// Per-sample fused NeRF MLP on quantized weights: positions and directions
// [N, 3] in, (sigma, r, g, b) [N, 4] out, from int8 or int16 matrices with
// one fp32 scale per output column.
//
// The first port of the Pallas TPU kernel `_quant_kernel` of
// nerf_tpu/ops/quant.py (`quantized_nerf_apply`: `quant_w_dict` dequantizes
// inside VMEM) and, on the int8-compute route, of the `_int8_mm` hook that
// `int8_w_dict` hands to `_nerf_math`. K7 now runs on `mlp_wgmma_kernel` of
// ray_wgmma.cu, built per weight route; this build is reached only through
// `ops/quant._launch(..., library="mlp_quant")`, as a timed comparison.
// Plain PyTorch twin and wrapper: nerf_tpu_torch/ops/quant.py.
//
// What bounds it: tensor-core operations, as the bf16 kernel
// (mlp_forward.cu): ~0.53 M multiply-adds per sample against 24 bytes read
// and 16 written. The weights are 0.6 MB (int8) instead of 1.2 MB a tile,
// from L2: fewer bytes on a kernel that does not wait for them.
//
// Design: mlp_forward.cu's kernel (`sample_body` of mlp_body.cuh) on the
// body's quantized weight routes. No bf16 copy of a matrix exists in global
// memory: on the dequantize routes the body writes bf16(f32(q) * s[col])
// into the 32-row operand ring in shared memory as it stages each chunk; on
// the int8-compute route the s8 weights are the tensor-core operand as they
// are, against s8 copies of the encoding and the activations.

#include "mlp_body.cuh"

namespace {

struct Params {
  Net net;
  const float* pos;   // [N, 3]
  const float* dirs;  // [N, 3]
  float* out;         // [N, 4]
  long long n;
};

template <int WQ>
__global__ void __launch_bounds__(THREADS, 1) mlp_quant_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  sample_body<WQ>(p.net, p.pos, p.dirs, p.out, p.n, smem);
}

template <int WQ>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = sample_smem_bytes<WQ>();
  cudaError_t err = cudaFuncSetAttribute(mlp_quant_kernel<WQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (p.n + M - 1) / M;
  mlp_quant_kernel<WQ><<<unsigned(blocks), THREADS, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// route: 1 int8 weights dequantized on chip, 2 int16 likewise, 3 int8 compute
int mlp_quant(const float* pos, const float* dirs, long long n, const void* const* weights,
              const void* const* scales, int route, int Lp, int Ld, int skip_pos, int bmild,
              int relu_sigma, int normalize_dirs, float band_scale, float* out, void* stream) {
  Params p;
  p.net = make_net(weights, scales, Lp, Ld, skip_pos, bmild, relu_sigma, normalize_dirs,
                   band_scale);
  p.pos = pos;
  p.dirs = dirs;
  p.out = out;
  p.n = n;
  if (n < 1 || !net_fits(p.net) || route < WQ_INT8 || route > WQ_INT8_COMPUTE ||
      !net_has_scales(p.net, route))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == WQ_INT8) return launch<WQ_INT8>(p, s);
  if (route == WQ_INT16) return launch<WQ_INT16>(p, s);
  return launch<WQ_INT8_COMPUTE>(p, s);
}

}  // extern "C"
