// Volume-rendering compositors: over the ray kernels' interleaved output
// (K2), and over planar per-sample fields (K6).
//
// Replaces the Pallas TPU kernels of nerf_tpu/ops/composite_kernel.py:
// - composite_rays_kernel (K2): `_composite_kernel_interleaved` (reached
//   through `fused_volume_render_interleaved`), raw [N, 4S] = (sigma, r, g,
//   b) per sample, in fp32 or (the ray kernels' bf16 raw output) bf16,
//   widened to fp32 as it is read: every operation is fp32;
// - composite_planar_kernel (K6): `_composite_kernel` (`_pallas_composite`,
//   reached through `fused_volume_render`), sigma [N, S] and rgb as
//   [N, S, 3] or as three [N, S] planes.
// Plain PyTorch twin and wrappers: nerf_tpu_torch/ops/composite_kernel.py.
//
// Per ray: dists = z[s+1] - z[s] (sentinel for the last sample) * ||d||,
// alpha = 1 - exp(-relu(sigma) * dist), T = exp(exclusive prefix sum of
// log(max(1 - alpha, eps))), w = alpha * T, and the w-weighted sums of rgb,
// z and 1. Writes out [N, 8] = (r, g, b, depth, acc, 0, 0, 0) and, where the
// caller asks for them, the weights w [N, S].
//
// What bounds them: memory at large S, instruction issue at small S. K2
// reads 16 bytes a sample (8 of a bf16 raw), 4 more with per-ray depths,
// writes 4 with the weights, and runs some forty instructions a sample
// (accurate expf twice and logf once, no fast math), plus per ray the
// shuffles of its scan and of its five sums: on an H100 the time tracks the
// count of warp-rays up to S = 64, and the bytes from S = 128 on.
//
// Two bodies:
// - composite_rays_kernel (K2, the port's one path to the interleaved
//   compositor). One memory round trip per ray: a lane owns a contiguous
//   run of k = ceil(S / P) samples and issues every load of its run (16
//   bytes a load: one fp32 sample or two bf16 ones) before any arithmetic,
//   scans the run serially in registers, then one segmented shuffle scan of
//   the lanes' run totals gives each run its offset, and the weights and the
//   five sums follow. P, the lanes a ray takes, is a template argument: a
//   warp takes 32 / P rays, and the scans use the shuffles' `width`, so no
//   lane idles past its segment's padding. A power-of-two S >= 16 takes
//   runs of 4 (P = S / 4, at most 32: 8 rays a warp at S = 16, 2 at 64),
//   any other S the smallest power of two >= S, at most 32 (32 rays a warp
//   at S = 1): at S = 16 to 64 the time follows the warp-rays, and runs of
//   4 cut it by 15-35% against one sample a lane at P >= S. The five sums are a
//   reduce-scatter (8 shuffles at P = 32 where butterflies take 25), and
//   eight lanes store the ray's out row. Bodies are instantiated for k =
//   1..7 (S <= 224: the port's sample counts 1 to 192, and 200; a run's tail
//   past S is masked); a larger S is walked in chunks, 224 samples in runs
//   of 7 while they last, then 32 in runs of 1, the transmittance carried (a
//   round trip a chunk). The weights, only where w is given, go straight to memory
//   where runs of 1, 2 or 4 tile the row (the warp's stores contiguous),
//   else through the warp's slot in shared memory, stored as contiguous
//   rows. Blocks are persistent (occupancy x SMs; faster than one block a
//   group of rays, and than a TMA ring of the next rows in shared memory)
//   and walk groups of rays; the schedule is mirrored in
//   ops/composite_kernel.py (`rays_schedule`) and exported here
//   (`composite_rays_*`).
// - composite_ray (K6): one warp per ray, the samples 32 at a time; each
//   chunk's loads wait on the previous chunk's scan and carry. Four 4-byte
//   loads a lane from strided [N, S] views (contiguous across the warp for
//   separate planes). The prefix sum runs across the warp with
//   __shfl_up_sync and a carried offset (the TPU kernels used a triangular
//   matmul); the sums are warp-shuffle reductions.
// z may be a broadcast view: its row stride is an argument (0 for one shared
// row of depths). The arithmetic of a sample is the same in both bodies;
// only the order of the prefix sum and of the five sums differs.
//
// K2's edges form, composite_edges_kernel, replaces no TPU kernel: it
// composites the mip variant's intervals (google/mipnerf
// volumetric_rendering; plain twin composite_edges_plain). raw [N, 4S] is
// per interval (density, r, g, b), fp32 or bf16, between edges t [N, S + 1]
// (row stride t_stride, 0 for one shared row): delta = (t[s+1] - t[s]) x
// ||d||, sd = density x delta, w = (1 - exp(-sd)) exp(-exclusive sum of sd),
// the w-weighted sums of rgb, of the midpoints 0.5 (t[s] + t[s+1]) and of 1;
// depth = that sum / acc, 0 / 0 read as 0, clipped to [t[0], t[S]]. It
// writes out [N, 8] = (r, g, b, depth, acc, 0, 0, 0) and, where asked, w [N,
// S]. A warp takes a ray, a lane a run of 4 intervals (a chunk of 128: the
// mip cells' S), the run scanned serially and the runs' totals by shuffles,
// the sum carried from chunk to chunk; persistent blocks. It is bound by
// memory: 16 bytes of raw and 4 of edges an interval, 4 of weights out.
//
// K2's opaque edges form, composite_edges_360_kernel, replaces no TPU kernel
// either: it composites Mip-NeRF 360's levels (multinerf
// compute_alpha_weights with opaque_background; plain twins
// composite_weights_360_plain and composite_edges_360_plain), the last
// interval's density x delta infinite (its alpha 1). Two entries of one
// body: WEIGHTS, a proposal level's weights w [N, S] alone from its density
// [N, S] fp32; otherwise the NeRF level's raw [N, 4S] fp32 to out [N, 8] =
// (r, g, b, depth, acc, 0, 0, 0), depth as the edges form has it. The body
// is the edges form's (a warp a ray, runs of 4, shuffle scan); bound by
// memory: 4 (or 16) bytes in and 4 of edges an interval.

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


// -- K2: composite_rays_kernel --------------------------------------------

constexpr int RAYS_THREADS = 256;
constexpr int RAYS_WARPS = RAYS_THREADS / 32;
constexpr int MAX_RUN = 7;   // samples a lane a chunk: one chunk up to S = 224

// lanes a ray takes: a power-of-two S >= 16 takes S / 4 (runs of 4), at
// most a warp; any other S the smallest power of two >= S, at most a warp
__host__ __device__ inline int segment_lanes(int S) {
  if (S >= 16 && (S & (S - 1)) == 0) return S / 4 < 32 ? S / 4 : 32;
  int p = 1;
  while (p < S && p < 32) p <<= 1;
  return p;
}
// samples a lane owns (a contiguous run): ceil(S / P), at most MAX_RUN.
// Past S = 32 * MAX_RUN a ray is walked in chunks: as many of 32 * MAX_RUN
// samples as it holds, then the rest 32 at a time, one a lane (ray_chunks
// in ops/composite_kernel.py)
__host__ __device__ inline int run_length(int S) {
  const int p = segment_lanes(S), k = (S + p - 1) / p;
  return k < MAX_RUN ? k : MAX_RUN;
}

__device__ __forceinline__ float4 widen(uint2 u) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
  return make_float4(__bfloat162float(h[0]), __bfloat162float(h[1]), __bfloat162float(h[2]),
                     __bfloat162float(h[3]));
}

// Every load of a lane's run s0 .. s0 + K - 1 (those below lim), issued
// before any arithmetic. EVEN (K and S even, z rows 8-byte aligned): a
// bf16 raw is read two samples a 16-byte load, and z two floats a load.
template <int K, typename RAW, bool EVEN>
__device__ __forceinline__ void load_run(const RAW* __restrict__ row,
                                         const float* __restrict__ zr, int s0, int lim,
                                         float4 (&v)[K], float (&zs)[K]) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (sizeof(RAW) == 4) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      v[j] = s0 + j < lim ? reinterpret_cast<const float4*>(row)[s0 + j] : zero;
  } else if constexpr (EVEN) {
#pragma unroll
    for (int j = 0; j < K; j += 2) {
      v[j] = v[j + 1] = zero;
      if (s0 + j < lim) {
        const uint4 u = reinterpret_cast<const uint4*>(row)[(s0 + j) >> 1];
        v[j] = widen(make_uint2(u.x, u.y));
        v[j + 1] = widen(make_uint2(u.z, u.w));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j)
      v[j] = s0 + j < lim ? widen(reinterpret_cast<const uint2*>(row)[s0 + j]) : zero;
  }
  if constexpr (EVEN) {
#pragma unroll
    for (int j = 0; j < K; j += 2) {
      zs[j] = zs[j + 1] = 0.f;
      if (s0 + j < lim) {
        const float2 t = *reinterpret_cast<const float2*>(zr + s0 + j);
        zs[j] = t.x;
        zs[j + 1] = t.y;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) zs[j] = s0 + j < lim ? zr[s0 + j] : 0.f;
  }
}

__device__ __forceinline__ float ray_norm(const float* __restrict__ d) {
  const float dx = d[0], dy = d[1], dz = d[2];
  return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
}

// A sample's opacity and log-transmittance factor, as composite_ray has them
__device__ __forceinline__ float sample_alpha(float sigma, float z, float z_next, bool last,
                                              float dnorm, float sentinel) {
  float dist = last ? sentinel : __fsub_rn(z_next, z);
  dist = __fmul_rn(dist, dnorm);
  return 1.f - expf(-fmaxf(sigma, 0.f) * dist);
}

// The running state of a ray's lane across its chunks: the log
// transmittance before the chunk and the lane's five partial sums
struct RayState {
  float carry = 0.f, sum[5] = {0.f, 0.f, 0.f, 0.f, 0.f};   // r, g, b, depth, acc
};

// One lane's run of a chunk after its loads: the serial scan in registers,
// the segment's scan, the weights and the sums. z_after is the depth after
// the chunk's last sample (where the ray goes on past the chunk). The
// weights go to wr (null: not written): a lane's run as one 8- or 16-byte
// store where runs of 2 or 4 tile the row (the warp's stores are then
// contiguous), else through the warp's slot wbuf, from which the warp
// stores contiguous rows.
template <int K, int P, bool CHUNKED>
__device__ __forceinline__ void composite_run(const float4 (&v)[K], const float (&zs)[K], int s0,
                                              int lim, int S, int sl, float z_after, float dnorm,
                                              float sentinel, float eps, RayState& st,
                                              float* __restrict__ wr, float* __restrict__ wbuf) {
  float z_next = __shfl_down_sync(FULL, zs[0], 1, P);   // the next run's first depth
  if (sl == P - 1) z_next = z_after;
  float alpha[K], pre[K];
  float run = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = s0 + j;
    const bool valid = s < lim;
    alpha[j] = valid ? sample_alpha(v[j].x, zs[j], j + 1 < K ? zs[j + 1] : z_next, s == S - 1,
                                    dnorm, sentinel)
                     : 0.f;
    const float lt = valid ? logf(fmaxf(1.f - alpha[j], eps)) : 0.f;
    pre[j] = run;
    run += lt;
  }
  float incl = run;   // a segmented inclusive shuffle scan of the run totals
#pragma unroll
  for (int off = 1; off < P; off <<= 1) {
    const float t = __shfl_up_sync(FULL, incl, off, P);
    if (sl >= off) incl += t;
  }
  float base = __shfl_up_sync(FULL, incl, 1, P);
  base = st.carry + (sl == 0 ? 0.f : base);
  if constexpr (CHUNKED) st.carry += __shfl_sync(FULL, incl, P - 1, P);
  float wv[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    wv[j] = alpha[j] * expf(base + pre[j]);
    st.sum[0] = fmaf(wv[j], v[j].y, st.sum[0]);
    st.sum[1] = fmaf(wv[j], v[j].z, st.sum[1]);
    st.sum[2] = fmaf(wv[j], v[j].w, st.sum[2]);
    st.sum[3] = fmaf(wv[j], zs[j], st.sum[3]);
    st.sum[4] += wv[j];
  }
  if (!wr) return;
  if constexpr (K == 1) {
    if (s0 < lim) wr[s0] = wv[0];   // consecutive lanes, consecutive weights
    return;
  } else if constexpr (K == 2 || K == 4) {
    if (S % K == 0) {                // the runs tile the row
      if constexpr (K == 2) {
        if (s0 < lim) *reinterpret_cast<float2*>(wr + s0) = make_float2(wv[0], wv[1]);
      } else {
        if (s0 < lim)
          *reinterpret_cast<float4*>(wr + s0) = make_float4(wv[0], wv[1], wv[2], wv[3]);
      }
      return;
    }
  }
  // a warp a ray (K > 1): wr is uniform across the warp
#pragma unroll
  for (int j = 0; j < K; ++j) wbuf[s0 + j] = wv[j];
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const int n = min(32 * K, lim);
  if (S % 4 == 0) {
    for (int i = 4 * lane; i < n; i += 128)
      *reinterpret_cast<float4*>(wr + i) = *reinterpret_cast<const float4*>(wbuf + i);
  } else {
    for (int i = lane; i < n; i += 32) wr[i] = wbuf[i];
  }
  __syncwarp();
}

// The five sums over a ray's segment of P lanes, and the ray's row of out
// (null for a spare segment). P >= 8: a reduce-scatter, each exchange
// halving the set of sums a lane carries (5 -> 3 or 2 -> 2 or 1 -> 1): 8
// shuffles at P = 32 where five butterflies take 25; then eight lanes a
// ray, one per column of out, store its row in one 32-byte piece.
template <int P>
__device__ __forceinline__ void reduce_and_store(const RayState& st, int sl,
                                                 float* __restrict__ o8) {
  const float* v = st.sum;
  if constexpr (P < 8) {
    float t[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      t[i] = v[i];
#pragma unroll
      for (int off = P >> 1; off > 0; off >>= 1) t[i] += __shfl_xor_sync(FULL, t[i], off, P);
    }
    if (o8 && sl == 0) {
      reinterpret_cast<float4*>(o8)[0] = make_float4(t[0], t[1], t[2], t[3]);
      reinterpret_cast<float4*>(o8)[1] = make_float4(t[4], 0.f, 0.f, 0.f);
    }
  } else {
    constexpr int A = P / 2, B = P / 4, C = P / 8;
    const bool a = sl & A, b = sl & B, c = sl & C;
    // a: lanes with a clear keep sums 0-2, the others 3-4
    const float u0 = (a ? v[3] : v[0]) + __shfl_xor_sync(FULL, a ? v[0] : v[3], A, P);
    const float u1 = (a ? v[4] : v[1]) + __shfl_xor_sync(FULL, a ? v[1] : v[4], A, P);
    const float u2 = v[2] + __shfl_xor_sync(FULL, v[2], A, P);   // kept where a is clear
    // b: (0, 1 | 2) where a is clear, (3 | 4) where it is set
    const float w0 = (a ? (b ? u1 : u0) : (b ? u2 : u0)) +
                     __shfl_xor_sync(FULL, b ? u0 : (a ? u1 : u2), B, P);
    const float w1 = u1 + __shfl_xor_sync(FULL, u1, B, P);       // kept where a, b are clear
    // c: (0 | 1) where a, b are clear; one sum elsewhere, summed by both
    const bool two = !a && !b;
    float x = (two && c ? w1 : w0) + __shfl_xor_sync(FULL, two && !c ? w1 : w0, C, P);
#pragma unroll
    for (int off = C >> 1; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off, P);
    // lane (a, b, c) holds sum 0, 1, 2, 2, 3, 3, 4, 4; it writes column 0, 1,
    // 2, 5, 3, 6, 4, 7 (the last three zeros)
    if (o8 && sl % C == 0) {
      const int col = c ? (two ? 1 : 4 + 2 * int(a) + int(b)) : (a ? 3 + int(b) : 2 * int(b));
      o8[col] = col < 5 ? x : 0.f;
    }
  }
}

// K2: a warp takes 32 / P rays, a lane K samples; one chunk where S <= 32 *
// MAX_RUN, else (CHUNKED) chunks of 32 K, then of 32, with the transmittance
// carried. Persistent: warp g of the grid takes the groups of rays g,
// g + warps, ...
template <int K, int P, typename RAW, bool EVEN, bool CHUNKED>
__global__ void __launch_bounds__(RAYS_THREADS) composite_rays_kernel(
    const RAW* __restrict__ raw, const float* __restrict__ z, long long z_stride,
    const float* __restrict__ rays_d, int n_rays, int S, float sentinel, float eps,
    float* __restrict__ out, float* __restrict__ w) {
  __shared__ __align__(16) float wslots[K > 1 ? RAYS_WARPS : 1][32 * K];
  const int lane = threadIdx.x & 31;
  const int sl = lane & (P - 1);
  constexpr int rpw = 32 / P;
  const int s0 = sl * K;
  float* wbuf = wslots[K > 1 ? threadIdx.x >> 5 : 0];
  const long long groups = ((long long)n_rays + rpw - 1) / rpw;
  const long long warps = (long long)gridDim.x * RAYS_WARPS;
  for (long long g = (long long)blockIdx.x * RAYS_WARPS + (threadIdx.x >> 5); g < groups;
       g += warps) {
    const long long r = g * rpw + lane / P;
    const bool ok = r < n_rays;   // the last group's spare segments join the shuffles only
    const long long rr = ok ? r : 0;
    const float dnorm = ray_norm(rays_d + rr * 3);
    const RAW* row = raw + rr * 4 * S;
    const float* zr = z + rr * z_stride;
    float* wr = ok && w ? w + rr * S : nullptr;
    RayState st;
    float4 v[K];
    float zs[K];
    if constexpr (!CHUNKED) {   // S <= 32 K: one chunk
      const int lim = ok ? S : 0;
      load_run<K, RAW, EVEN>(row, zr, s0, lim, v, zs);
      composite_run<K, P, false>(v, zs, s0, lim, S, sl, 0.f, dnorm, sentinel, eps, st, wr,
                                 wbuf);
    } else {
      int c0 = 0;
      for (; c0 + 32 * K <= S; c0 += 32 * K) {   // chunks of 32 K, K a lane
        const int c1 = c0 + 32 * K, lim = ok ? S - c0 : 0;
        const float z_after = ok && c1 < S ? zr[c1] : 0.f;
        load_run<K, RAW, EVEN>(row + 4 * c0, zr + c0, s0, lim, v, zs);
        composite_run<K, P, true>(v, zs, s0, lim, S - c0, sl, z_after, dnorm, sentinel, eps,
                                  st, wr ? wr + c0 : nullptr, wbuf);
      }
      for (; c0 < S; c0 += 32) {                 // the rest: chunks of 32, one a lane
        const int lim = ok ? S - c0 : 0;
        const float z_after = ok && c0 + 32 < S ? zr[c0 + 32] : 0.f;
        float4 v1[1];
        float z1[1];
        load_run<1, RAW, false>(row + 4 * c0, zr + c0, lane, lim, v1, z1);
        composite_run<1, P, true>(v1, z1, lane, lim, S - c0, sl, z_after, dnorm, sentinel, eps,
                                  st, wr ? wr + c0 : nullptr, wbuf);
      }
    }
    reduce_and_store<P>(st, sl, ok ? out + r * 8 : nullptr);
  }
}

// -- K2's edges form: composite_edges_kernel -------------------------------

constexpr int EDGES_THREADS = 256;
constexpr int EDGES_RUN = 4;   // intervals a lane a chunk: 128 a warp

template <typename RAW>
__device__ __forceinline__ float4 load_sample(const RAW* __restrict__ row, int s) {
  if constexpr (sizeof(RAW) == 4)
    return reinterpret_cast<const float4*>(row)[s];
  else
    return widen(reinterpret_cast<const uint2*>(row)[s]);
}

template <typename RAW>
__global__ void __launch_bounds__(EDGES_THREADS) composite_edges_kernel(
    const RAW* __restrict__ raw, const float* __restrict__ t, long long t_stride,
    const float* __restrict__ rays_d, int n_rays, int S, float* __restrict__ out,
    float* __restrict__ w) {
  constexpr int WARPS = EDGES_THREADS / 32;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * WARPS;
  for (long long r = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5); r < n_rays; r += warps) {
    const RAW* row = raw + r * 4 * S;
    const float* tr = t + r * t_stride;
    float* wr = w ? w + r * S : nullptr;
    const float dnorm = ray_norm(rays_d + r * 3);
    float carry = 0.f, sr = 0.f, sg = 0.f, sb = 0.f, sd = 0.f, sa = 0.f;
    for (int c0 = 0; c0 < S; c0 += 32 * EDGES_RUN) {
      const int s0 = c0 + lane * EDGES_RUN;
      float4 v[EDGES_RUN];
      float e[EDGES_RUN + 1];
#pragma unroll
      for (int j = 0; j < EDGES_RUN; ++j)
        v[j] = s0 + j < S ? load_sample(row, s0 + j) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j <= EDGES_RUN; ++j) e[j] = s0 + j <= S ? tr[s0 + j] : 0.f;
      float dd[EDGES_RUN], pre[EDGES_RUN], run = 0.f;
#pragma unroll
      for (int j = 0; j < EDGES_RUN; ++j) {
        dd[j] = s0 + j < S ? __fmul_rn(v[j].x, __fmul_rn(__fsub_rn(e[j + 1], e[j]), dnorm)) : 0.f;
        pre[j] = run;
        run = __fadd_rn(run, dd[j]);
      }
      float incl = run;   // the runs' totals: an inclusive shuffle scan
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl = __fadd_rn(incl, u);
      }
      float base = __shfl_up_sync(FULL, incl, 1);
      base = __fadd_rn(carry, lane == 0 ? 0.f : base);
#pragma unroll
      for (int j = 0; j < EDGES_RUN; ++j) {
        if (s0 + j >= S) continue;
        const float wv = __fmul_rn(1.f - expf(-dd[j]), expf(-__fadd_rn(base, pre[j])));
        if (wr) wr[s0 + j] = wv;
        sr = fmaf(wv, v[j].y, sr);
        sg = fmaf(wv, v[j].z, sg);
        sb = fmaf(wv, v[j].w, sb);
        sd = fmaf(wv, __fmul_rn(0.5f, __fadd_rn(e[j], e[j + 1])), sd);
        sa += wv;
      }
      carry = __fadd_rn(carry, __shfl_sync(FULL, incl, 31));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sr += __shfl_xor_sync(FULL, sr, off);
      sg += __shfl_xor_sync(FULL, sg, off);
      sb += __shfl_xor_sync(FULL, sb, off);
      sd += __shfl_xor_sync(FULL, sd, off);
      sa += __shfl_xor_sync(FULL, sa, off);
    }
    if (lane == 0) {
      float depth = __fdiv_rn(sd, sa);
      if (depth != depth) depth = 0.f;   // 0 / 0
      depth = fminf(fmaxf(depth, tr[0]), tr[S]);
      float4* o = reinterpret_cast<float4*>(out + r * 8);
      o[0] = make_float4(sr, sg, sb, depth);
      o[1] = make_float4(sa, 0.f, 0.f, 0.f);
    }
  }
}

// K2's opaque edges form: the last interval's alpha is 1
template <bool WEIGHTS>
__global__ void __launch_bounds__(EDGES_THREADS) composite_edges_360_kernel(
    const float* __restrict__ raw, const float* __restrict__ t, long long t_stride,
    const float* __restrict__ rays_d, int n_rays, int S, float* __restrict__ out,
    float* __restrict__ w) {
  constexpr int WARPS = EDGES_THREADS / 32;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * WARPS;
  for (long long r = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5); r < n_rays; r += warps) {
    const float* tr = t + r * t_stride;
    const float dnorm = ray_norm(rays_d + r * 3);
    float carry = 0.f, sr = 0.f, sg = 0.f, sb = 0.f, sd = 0.f, sa = 0.f;
    for (int c0 = 0; c0 < S; c0 += 32 * EDGES_RUN) {
      const int s0 = c0 + lane * EDGES_RUN;
      float4 v[EDGES_RUN];
      float e[EDGES_RUN + 1];
#pragma unroll
      for (int j = 0; j < EDGES_RUN; ++j) {
        const bool in = s0 + j < S;
        if constexpr (WEIGHTS)
          v[j] = make_float4(in ? raw[r * S + s0 + j] : 0.f, 0.f, 0.f, 0.f);
        else
          v[j] = in ? reinterpret_cast<const float4*>(raw + r * 4 * S)[s0 + j]
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j <= EDGES_RUN; ++j) e[j] = s0 + j <= S ? tr[s0 + j] : 0.f;
      float dd[EDGES_RUN], pre[EDGES_RUN], run = 0.f;
#pragma unroll
      for (int j = 0; j < EDGES_RUN; ++j) {
        dd[j] = s0 + j < S ? __fmul_rn(v[j].x, __fmul_rn(__fsub_rn(e[j + 1], e[j]), dnorm)) : 0.f;
        if (s0 + j == S - 1) dd[j] = __int_as_float(0x7f800000);   // opaque: +inf
        pre[j] = run;
        run = __fadd_rn(run, dd[j]);
      }
      float incl = run;   // the runs' totals: an inclusive shuffle scan
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl = __fadd_rn(incl, u);
      }
      float base = __shfl_up_sync(FULL, incl, 1);
      base = __fadd_rn(carry, lane == 0 ? 0.f : base);
#pragma unroll
      for (int j = 0; j < EDGES_RUN; ++j) {
        if (s0 + j >= S) continue;
        const float wv = __fmul_rn(1.f - expf(-dd[j]), expf(-__fadd_rn(base, pre[j])));
        if constexpr (WEIGHTS) {
          w[r * S + s0 + j] = wv;
        } else {
          sr = fmaf(wv, v[j].y, sr);
          sg = fmaf(wv, v[j].z, sg);
          sb = fmaf(wv, v[j].w, sb);
          sd = fmaf(wv, __fmul_rn(0.5f, __fadd_rn(e[j], e[j + 1])), sd);
          sa += wv;
        }
      }
      carry = __fadd_rn(carry, __shfl_sync(FULL, incl, 31));
    }
    if constexpr (!WEIGHTS) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sr += __shfl_xor_sync(FULL, sr, off);
        sg += __shfl_xor_sync(FULL, sg, off);
        sb += __shfl_xor_sync(FULL, sb, off);
        sd += __shfl_xor_sync(FULL, sd, off);
        sa += __shfl_xor_sync(FULL, sa, off);
      }
      if (lane == 0) {
        float depth = __fdiv_rn(sd, sa);
        if (depth != depth) depth = 0.f;   // 0 / 0
        depth = fminf(fmaxf(depth, tr[0]), tr[S]);
        float4* o = reinterpret_cast<float4*>(out + r * 8);
        o[0] = make_float4(sr, sg, sb, depth);
        o[1] = make_float4(sa, 0.f, 0.f, 0.f);
      }
    }
  }
}

// the launch floor: an empty kernel, timed beside K2
__global__ void empty_kernel() {}

struct RaysLaunch {
  const void* kernel;
  int blocks_per_sm;
};

// The body for (S, raw type, EVEN) and its resident blocks an SM (cached
// per body and device)
template <typename RAW>
RaysLaunch rays_body(int S, bool even) {
  const int k = run_length(S), P = segment_lanes(S);
  const bool chunked = S > 32 * MAX_RUN;
  const void* f = nullptr;
#define K2_BODY(K, P_, C)                                                                     \
  if (k == K && P == P_ && chunked == C)                                                      \
    f = even ? reinterpret_cast<const void*>(&composite_rays_kernel<K, P_, RAW, K % 2 == 0, C>) \
             : reinterpret_cast<const void*>(&composite_rays_kernel<K, P_, RAW, false, C>);
  K2_BODY(1, 1, false) K2_BODY(1, 2, false) K2_BODY(1, 4, false) K2_BODY(1, 8, false)
  K2_BODY(1, 16, false) K2_BODY(1, 32, false) K2_BODY(2, 32, false) K2_BODY(3, 32, false)
  K2_BODY(4, 32, false) K2_BODY(5, 32, false) K2_BODY(6, 32, false) K2_BODY(7, 32, false)
  K2_BODY(4, 4, false) K2_BODY(4, 8, false) K2_BODY(4, 16, false)   // S = 16, 32, 64
  K2_BODY(MAX_RUN, 32, true)   // S > 32 * MAX_RUN
#undef K2_BODY
  int dev = 0;
  cudaGetDevice(&dev);
  static int cache[2 * 2 * (MAX_RUN + 6)][16];   // (chunked, k + log2 P, even)
  int& b = cache[2 * (2 * (k - 1 + __builtin_ctz(P)) + int(chunked)) + int(even)][dev & 15];
  if (b == 0) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, f, RAYS_THREADS, 0);
  return {f, b};
}

// EVEN: two samples a load (bf16) and two depths a load need even runs and
// rows that keep the alignment
bool rays_even(const void* raw, int raw_bf16, const float* z, long long z_stride, int S) {
  return run_length(S) % 2 == 0 && S % 2 == 0 && z_stride % 2 == 0 &&
         reinterpret_cast<uintptr_t>(z) % 8 == 0 &&
         (!raw_bf16 || reinterpret_cast<uintptr_t>(raw) % 16 == 0);
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

long long rays_grid(long long n_rays, int S, int blocks_per_sm, int sms) {
  const int rpw = 32 / segment_lanes(S);
  const long long groups = (n_rays + rpw - 1) / rpw;
  const long long blocks = (groups + RAYS_WARPS - 1) / RAYS_WARPS;
  const long long resident = (long long)blocks_per_sm * sms;
  return blocks < resident ? blocks : resident;
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// K2 (composite_rays_kernel): w may be null (no weights written)
int composite_rays(const void* raw, int raw_bf16, const float* z, long long z_stride,
                   const float* rays_d, int n_rays, int n_samples, float sentinel, float eps,
                   float* out, float* w, void* stream) {
  if (n_samples < 1 || n_rays < 1) return int(cudaErrorInvalidValue);
  const int S = n_samples;
  const bool even = rays_even(raw, raw_bf16, z, z_stride, S);
  const RaysLaunch L = raw_bf16 ? rays_body<__nv_bfloat16>(S, even) : rays_body<float>(S, even);
  if (L.blocks_per_sm < 1) return int(cudaErrorInvalidConfiguration);
  const unsigned grid = unsigned(rays_grid(n_rays, S, L.blocks_per_sm, sm_count()));
  void* args[] = {const_cast<void**>(&raw), const_cast<float**>(&z), &z_stride,
                  const_cast<float**>(&rays_d), &n_rays, const_cast<int*>(&S), &sentinel, &eps,
                  &out, &w};
  return int(cudaLaunchKernel(L.kernel, dim3(grid), dim3(RAYS_THREADS), args, 0,
                              static_cast<cudaStream_t>(stream)));
}

// K2's schedule, as ops/composite_kernel.py computes it
int composite_rays_segment(int n_samples) { return segment_lanes(n_samples); }
int composite_rays_run(int n_samples) { return run_length(n_samples); }
int composite_rays_max_run() { return MAX_RUN; }
int composite_rays_threads() { return RAYS_THREADS; }
int composite_rays_blocks_per_sm(int n_samples, int raw_bf16, int even) {
  return raw_bf16 ? rays_body<__nv_bfloat16>(n_samples, even).blocks_per_sm
                  : rays_body<float>(n_samples, even).blocks_per_sm;
}
long long composite_rays_grid(long long n_rays, int n_samples, int raw_bf16, int even) {
  return rays_grid(n_rays, n_samples, composite_rays_blocks_per_sm(n_samples, raw_bf16, even),
                   sm_count());
}

// K2's edges form (composite_edges_kernel): t [N, S + 1] the edges (row
// stride t_stride), w may be null (no weights written)
int composite_edges(const void* raw, int raw_bf16, const float* t, long long t_stride,
                    const float* rays_d, int n_rays, int n_intervals, float* out, float* w,
                    void* stream) {
  if (n_intervals < 1 || n_rays < 1) return int(cudaErrorInvalidValue);
  const long long warps = EDGES_THREADS / 32;
  long long blocks = (n_rays + warps - 1) / warps;
  const long long resident = 8LL * sm_count();
  if (blocks > resident) blocks = resident;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (raw_bf16)
    composite_edges_kernel<<<unsigned(blocks), EDGES_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(raw), t, t_stride, rays_d, n_rays, n_intervals, out, w);
  else
    composite_edges_kernel<<<unsigned(blocks), EDGES_THREADS, 0, s>>>(
        static_cast<const float*>(raw), t, t_stride, rays_d, n_rays, n_intervals, out, w);
  return int(cudaGetLastError());
}

// K2's opaque edges form (composite_edges_360_kernel): `weights` 1, a
// proposal level's density [N, S] fp32 -> w [N, S]; 0, the NeRF level's raw
// [N, 4S] fp32 -> out [N, 8]. t [N, S + 1] the metric edges (row stride
// t_stride).
int composite_edges_360(const float* raw, int weights, const float* t, long long t_stride,
                        const float* rays_d, int n_rays, int n_intervals, float* out, float* w,
                        void* stream) {
  if (n_intervals < 1 || n_rays < 1 || !raw || !t || !rays_d || (weights ? !w : !out))
    return int(cudaErrorInvalidValue);
  const long long warps = EDGES_THREADS / 32;
  long long blocks = (n_rays + warps - 1) / warps;
  const long long resident = 8LL * sm_count();
  if (blocks > resident) blocks = resident;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (weights)
    composite_edges_360_kernel<true><<<unsigned(blocks), EDGES_THREADS, 0, s>>>(
        raw, t, t_stride, rays_d, n_rays, n_intervals, nullptr, w);
  else
    composite_edges_360_kernel<false><<<unsigned(blocks), EDGES_THREADS, 0, s>>>(
        raw, t, t_stride, rays_d, n_rays, n_intervals, out, nullptr);
  return int(cudaGetLastError());
}

// the launch floor: one empty kernel
int composite_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
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
