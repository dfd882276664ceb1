// Per-sample fused NeRF MLP: positions and directions [N, 3] in,
// (sigma, r, g, b) [N, 4] out, on the WMMA body.
//
// The first port of the Pallas TPU kernel `_nerf_kernel` of
// nerf_tpu/ops/mlp_kernel.py. K4 now runs on `mlp_wgmma_kernel` of
// ray_wgmma.cu; this build is reached only through
// `ops/mlp_kernel._launch(..., library="mlp_forward")`, as a timed comparison.
// Plain PyTorch twin and wrapper: nerf_tpu_torch/ops/mlp_kernel.py.
//
// What bounds it: tensor-core operations, as the ray kernels: ~0.53 M
// multiply-adds per sample against 24 bytes read and 16 written.
//
// Design: the ray kernels' tile (mlp_body.cuh: 128 rows a block, WMMA bf16,
// weights streamed by cp.async) with position and direction read per row
// from memory (`sample_body` there, shared with mlp_quant.cu). The direction
// branch is evaluated per row: the direction is normalized (where the model
// asks) and encoded in fp32, rounded to bf16 [128 x 32], and `denc @ wdir`
// is one more tensor-core product accumulated into the color layer's
// accumulators, as the skip layer adds `enc @ wskip`. N need not be a
// multiple of 128: rows past N are encoded as zeros and not written.

#include "mlp_body.cuh"

namespace {

constexpr size_t SMEM_BYTES = sample_smem_bytes<WQ_BF16>();

struct Params {
  Net net;
  const float* pos;   // [N, 3]
  const float* dirs;  // [N, 3]
  float* out;         // [N, 4]
  long long n;
};

__global__ void __launch_bounds__(THREADS, 1) mlp_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  sample_body<WQ_BF16>(p.net, p.pos, p.dirs, p.out, p.n, smem);
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int mlp_forward(const float* pos, const float* dirs, long long n, const void* const* weights,
                int Lp, int Ld, int skip_pos, int bmild, int relu_sigma, int normalize_dirs,
                float band_scale, float* out, void* stream) {
  Params p;
  p.net = make_net(weights, nullptr, Lp, Ld, skip_pos, bmild, relu_sigma, normalize_dirs, band_scale);
  p.pos = pos;
  p.dirs = dirs;
  p.out = out;
  p.n = n;
  if (n < 1 || !net_fits(p.net)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (n + M - 1) / M;
  mlp_kernel<<<unsigned(blocks), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

}  // extern "C"
