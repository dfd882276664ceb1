// Volume-rendering compositors: over the ray kernel's interleaved output,
// and over planar per-sample fields.
//
// Replaces the Pallas TPU kernels of nerf_tpu/ops/composite_kernel.py:
// - composite_kernel: `_composite_kernel_interleaved` (reached through
//   `fused_volume_render_interleaved`), raw [N, 4S] = (sigma, r, g, b) per
//   sample, in fp32 or (the ray kernels' bf16 raw output) bf16, widened to
//   fp32 as it is read: every operation is fp32;
// - composite_planar_kernel: `_composite_kernel` (`_pallas_composite`,
//   reached through `fused_volume_render`), sigma [N, S] and rgb as
//   [N, S, 3] or as three [N, S] planes.
// Plain PyTorch twin and wrappers: nerf_tpu_torch/ops/composite_kernel.py.
//
// Per ray: dists = z[s+1] - z[s] (sentinel for the last sample) * ||d||,
// alpha = 1 - exp(-relu(sigma) * dist), T = exp(exclusive prefix sum of
// log(max(1 - alpha, eps))), w = alpha * T, and the w-weighted sums of rgb,
// z and 1. Writes out [N, 8] = (r, g, b, depth, acc, 0, 0, 0) and w [N, S].
//
// What bounds it: memory. It reads 16 bytes and writes 4 per sample (20 and
// 4 with per-ray depths) and does some twenty operations on them.
//
// Design: one warp per ray, one device function for both layouts. Lanes walk
// the samples 32 at a time. Interleaved: each lane reads its sample's
// (sigma, r, g, b) as one 16-byte load (8 bytes for bf16), so a warp reads
// 512 (256) contiguous bytes. Planar: four 4-byte loads a lane from strided [N, S] views
// (contiguous across the warp for separate planes). The prefix sum runs across
// the warp with __shfl_up_sync and a carried offset between chunks (the TPU
// kernels used a triangular matmul); the five sums are warp-shuffle
// reductions. z may be a broadcast view: its row stride is an argument (0
// for one shared row of depths).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 rays per block
constexpr unsigned FULL = 0xffffffffu;

// One ray by one warp. load(s) gives sample s as (sigma, r, g, b).
template <class Load>
__device__ __forceinline__ void composite_ray(Load load, const float* __restrict__ zr,
                                              const float* __restrict__ d, int S, float sentinel,
                                              float eps, float* __restrict__ out8,
                                              float* __restrict__ wr) {
  const int lane = threadIdx.x & 31;
  const float dx = d[0], dy = d[1], dz = d[2];
  const float dnorm =
      sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));

  float carry = 0.f;
  float sr = 0.f, sg = 0.f, sb = 0.f, sd = 0.f, sa = 0.f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool valid = s < S;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    float zs = 0.f, dist = 0.f;
    if (valid) {
      v = load(s);
      zs = zr[s];
      dist = s == S - 1 ? sentinel : __fsub_rn(zr[s + 1], zs);
      dist = __fmul_rn(dist, dnorm);
    }
    const float alpha = valid ? 1.f - expf(-fmaxf(v.x, 0.f) * dist) : 0.f;
    const float lt = valid ? logf(fmaxf(1.f - alpha, eps)) : 0.f;
    float incl = lt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += t;
    }
    float excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = 0.f;
    const float wv = alpha * expf(carry + excl);
    if (valid) wr[s] = wv;
    sr = fmaf(wv, v.y, sr);
    sg = fmaf(wv, v.z, sg);
    sb = fmaf(wv, v.w, sb);
    sd = fmaf(wv, zs, sd);
    sa += wv;
    carry += __shfl_sync(FULL, incl, 31);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sr += __shfl_xor_sync(FULL, sr, off);
    sg += __shfl_xor_sync(FULL, sg, off);
    sb += __shfl_xor_sync(FULL, sb, off);
    sd += __shfl_xor_sync(FULL, sd, off);
    sa += __shfl_xor_sync(FULL, sa, off);
  }
  if (lane < 8) {
    const float vals[5] = {sr, sg, sb, sd, sa};
    out8[lane] = lane < 5 ? vals[lane] : 0.f;
  }
}

// RAW: float (16 bytes a sample) or __nv_bfloat16 (8 bytes).
template <typename RAW>
__global__ void __launch_bounds__(THREADS) composite_kernel(
    const RAW* __restrict__ raw, const float* __restrict__ z, long long z_stride,
    const float* __restrict__ rays_d, int n_rays, int S, float sentinel, float eps,
    float* __restrict__ out, float* __restrict__ w) {
  const long long r = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (r >= n_rays) return;  // uniform across the warp
  const RAW* row = raw + r * 4 * S;
  composite_ray(
      [row](int s) {
        if constexpr (sizeof(RAW) == 4) {
          return reinterpret_cast<const float4*>(row)[s];
        } else {
          const uint2 u = reinterpret_cast<const uint2*>(row)[s];
          const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
          return make_float4(__bfloat162float(h[0]), __bfloat162float(h[1]),
                             __bfloat162float(h[2]), __bfloat162float(h[3]));
        }
      },
      z + r * z_stride, rays_d + r * 3, S, sentinel, eps, out + r * 8, w + r * S);
}

// sigma and the color planes cr, cg, cb are [N, S] views given by a row
// stride and an element stride: S and 1 for a contiguous plane, 3S and 3
// for a channel of one [N, S, 3] array, 4S and 4 for a column of the MLP
// kernel's [N * S, 4] output.
__global__ void __launch_bounds__(THREADS) composite_planar_kernel(
    const float* __restrict__ sigma, const float* __restrict__ cr, const float* __restrict__ cg,
    const float* __restrict__ cb, long long sigma_row_stride, int sigma_stride,
    long long rgb_row_stride, int rgb_stride, const float* __restrict__ z, long long z_stride, const float* __restrict__ rays_d, int n_rays,
    int S, float sentinel, float eps, float* __restrict__ out, float* __restrict__ w) {
  const long long r = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (r >= n_rays) return;  // uniform across the warp
  const float* sg = sigma + r * sigma_row_stride;
  const float* plane_r = cr + r * rgb_row_stride;
  const float* plane_g = cg + r * rgb_row_stride;
  const float* plane_b = cb + r * rgb_row_stride;
  composite_ray(
      [=](int s) {
        const long long c = (long long)s * rgb_stride;
        return make_float4(sg[(long long)s * sigma_stride], plane_r[c], plane_g[c],
                           plane_b[c]);
      },
      z + r * z_stride, rays_d + r * 3, S, sentinel, eps, out + r * 8, w + r * S);
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// raw_bf16: raw holds bf16 values, else fp32
int composite(const void* raw, int raw_bf16, const float* z, long long z_stride,
              const float* rays_d, int n_rays, int n_samples, float sentinel, float eps,
              float* out, float* w, void* stream) {
  if (n_samples < 1) return int(cudaErrorInvalidValue);
  const long long blocks = ((long long)n_rays * 32 + THREADS - 1) / THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (raw_bf16)
    composite_kernel<<<unsigned(blocks), THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(raw), z, z_stride, rays_d, n_rays, n_samples,
        sentinel, eps, out, w);
  else
    composite_kernel<<<unsigned(blocks), THREADS, 0, s>>>(
        static_cast<const float*>(raw), z, z_stride, rays_d, n_rays, n_samples, sentinel, eps,
        out, w);
  return int(cudaGetLastError());
}

int composite_planar(const float* sigma, const float* cr, const float* cg, const float* cb,
                     long long sigma_row_stride, int sigma_stride, long long rgb_row_stride,
                     int rgb_stride, const float* z, long long z_stride,
                     const float* rays_d, int n_rays, int n_samples, float sentinel, float eps,
                     float* out, float* w, void* stream) {
  if (n_samples < 1) return int(cudaErrorInvalidValue);
  const long long blocks = ((long long)n_rays * 32 + THREADS - 1) / THREADS;
  composite_planar_kernel<<<unsigned(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      sigma, cr, cg, cb, sigma_row_stride, sigma_stride, rgb_row_stride, rgb_stride, z, z_stride,
      rays_d, n_rays, n_samples, sentinel, eps, out, w);
  return int(cudaGetLastError());
}

}  // extern "C"
