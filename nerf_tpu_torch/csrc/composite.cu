// Volume-rendering compositor over the ray kernel's interleaved output.
//
// Replaces the Pallas TPU kernel `_composite_kernel_interleaved`
// (nerf_tpu/ops/composite_kernel.py, reached through
// `fused_volume_render_interleaved`). Plain PyTorch twin and wrapper:
// nerf_tpu_torch/ops/composite_kernel.py.
//
// Per ray: dists = z[s+1] - z[s] (sentinel for the last sample) * ||d||,
// alpha = 1 - exp(-relu(sigma) * dist), T = exp(exclusive prefix sum of
// log(max(1 - alpha, eps))), w = alpha * T, and the w-weighted sums of rgb,
// z and 1. Writes out [N, 8] = (r, g, b, depth, acc, 0, 0, 0) and w [N, S].
//
// What bounds it: memory. It reads 16 bytes and writes 4 per sample and
// does some twenty operations on them.
//
// Design: one warp per ray. Lanes walk the samples 32 at a time, each
// reading its sample's (sigma, r, g, b) as one 16-byte load, so a warp reads
// 512 contiguous bytes. The prefix sum runs across the warp with
// __shfl_up_sync and a carried offset between chunks (the TPU kernel used a
// triangular matmul); the five sums are warp-shuffle reductions.
// z may be a broadcast view: its row stride is an argument (0 for one
// shared row of depths).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 rays per block
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS) composite_kernel(
    const float* __restrict__ raw, const float* __restrict__ z, long long z_stride,
    const float* __restrict__ rays_d, int n_rays, int S, float sentinel, float eps,
    float* __restrict__ out, float* __restrict__ w) {
  const long long r = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= n_rays) return;  // uniform across the warp

  const float dx = rays_d[r * 3], dy = rays_d[r * 3 + 1], dz = rays_d[r * 3 + 2];
  const float dnorm =
      sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
  const float4* row = reinterpret_cast<const float4*>(raw + r * 4 * S);
  const float* zr = z + r * z_stride;
  float* wr = w + r * S;

  float carry = 0.f;
  float sr = 0.f, sg = 0.f, sb = 0.f, sd = 0.f, sa = 0.f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool valid = s < S;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    float zs = 0.f, dist = 0.f;
    if (valid) {
      v = row[s];
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
    out[r * 8 + lane] = lane < 5 ? vals[lane] : 0.f;
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int composite(const float* raw, const float* z, long long z_stride, const float* rays_d,
              int n_rays, int n_samples, float sentinel, float eps, float* out, float* w,
              void* stream) {
  if (n_samples < 1) return int(cudaErrorInvalidValue);
  const long long blocks = ((long long)n_rays * 32 + THREADS - 1) / THREADS;
  composite_kernel<<<unsigned(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      raw, z, z_stride, rays_d, n_rays, n_samples, sentinel, eps, out, w);
  return int(cudaGetLastError());
}

}  // extern "C"
