// Per-sample fused NeRF MLP: positions and directions [N, 3] in,
// (sigma, r, g, b) [N, 4] out.
//
// Replaces the Pallas TPU kernel `_nerf_kernel` of nerf_tpu/ops/mlp_kernel.py
// (`_pallas_forward`, reached through `fused_nerf_apply` and the forward of
// `fused_train_apply`). Plain PyTorch twin and wrapper:
// nerf_tpu_torch/ops/mlp_kernel.py.
//
// What bounds it: tensor-core operations, as the ray kernels: ~0.53 M
// multiply-adds per sample against 24 bytes read and 16 written.
//
// Design: the ray kernels' tile (mlp_body.cuh: 128 rows a block, WMMA bf16,
// weights streamed by cp.async) with position and direction read per row
// from memory. The direction branch is evaluated per row: the direction is
// normalized (where the model asks) and encoded in fp32, rounded to bf16
// [128 x 32], and `denc @ wdir` is one more tensor-core product accumulated
// into the color layer's accumulators, as the skip layer adds
// `enc @ wskip`. N need not be a multiple of 128: rows past N are encoded
// as zeros and not written.

#include "mlp_body.cuh"

namespace {

constexpr size_t SMEM_BYTES = ACT_BYTES + ENC_BYTES + DENC_BYTES + WBUF_BYTES + STAGE_BYTES +
                              M * sizeof(float) + 2 * M * 3 * sizeof(float);

struct Params {
  Net net;
  const float* pos;   // [N, 3]
  const float* dirs;  // [N, 3]
  float* out;         // [N, 4]
  long long n;
};

__global__ void __launch_bounds__(THREADS, 1) mlp_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);
  bf16* enc = reinterpret_cast<bf16*>(smem + ACT_BYTES);
  bf16* denc = reinterpret_cast<bf16*>(smem + ACT_BYTES + ENC_BYTES);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + ACT_BYTES + ENC_BYTES + DENC_BYTES);
  float* stage =
      reinterpret_cast<float*>(smem + ACT_BYTES + ENC_BYTES + DENC_BYTES + WBUF_BYTES);
  float* sig = stage + WARPS * 256;
  float* xyz = sig + M;        // [M, 3]
  float* dxyz = xyz + M * 3;   // [M, 3]

  const int tid = threadIdx.x;
  const long long n0 = (long long)blockIdx.x * M;
  const long long valid = min((long long)M, p.n - n0);
  if (tid < M) {
    const bool ok = tid < valid;
    float x[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
    if (ok) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        x[c] = p.pos[(n0 + tid) * 3 + c];
        d[c] = p.dirs[(n0 + tid) * 3 + c];
      }
      if (p.net.normalize_dirs) normalize_dir(d);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      xyz[tid * 3 + c] = x[c];
      dxyz[tid * 3 + c] = d[c];
    }
  }
  __syncthreads();
  encode_pos_tile(enc, xyz, valid, p.net.Lp, p.net.band_scale);
  encode_dir_tile(denc, dxyz, valid, p.net.Ld, p.net.band_scale);
  __syncthreads();
  mlp_tile<true, false>(p.net, act, enc, wbuf, stage, sig, nullptr, nullptr, denc, nullptr);
  if (tid < valid) {
    const float* res = stage + tid * 4;
    reinterpret_cast<float4*>(p.out)[n0 + tid] = make_float4(sig[tid], res[1], res[2], res[3]);
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int mlp_forward(const float* pos, const float* dirs, long long n, const void* const* weights,
                int Lp, int Ld, int skip_pos, int bmild, int relu_sigma, int normalize_dirs,
                float band_scale, float* out, void* stream) {
  Params p;
  p.net = make_net(weights, Lp, Ld, skip_pos, bmild, relu_sigma, normalize_dirs, band_scale);
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
