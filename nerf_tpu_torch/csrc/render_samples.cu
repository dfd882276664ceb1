// Fused ray kernels: samples along each ray + the whole NeRF MLP, and
// optionally the volume rendering of those samples.
//
// Replaces the Pallas TPU kernels of nerf_tpu/ops/render_kernel.py:
// - ray_kernel: `_ray_kernel` (uniform depths, `fused_render_samples`);
// - ray_z_kernel: `_ray_z_kernel` (per-ray depths z [R, S] read from memory,
//   `_zvals_forward` -> `fused_render_zvals_raw`);
// - ray_composite_kernel / ray_z_composite_kernel: their `composited=True`
//   modes (`_composite_flat` + `_segmented_cumsum_excl`), which write per ray
//   (r, g, b, depth, acc, 0, 0, 0) and optionally the weights [R, S].
// Plain PyTorch twins and wrappers: nerf_tpu_torch/ops/render_kernel.py;
// weight layout: ops/mlp_kernel.py.
//
// What bounds it: tensor-core operations. Per sample the MLP is ~0.52 M
// multiply-adds (8 x 256 trunk, skip, heads) against 24 bytes of ray input
// and 16 bytes of output, about 25,000 operations per byte moved.
//
// Design (simple first; wgmma/TMA/warp specialisation are later work):
// - one block of 512 threads (16 warps) owns M = 128 consecutive samples
//   (flat index n = ray * S + s, so a tile holds whole or partial rays);
// - positions (one per row, kept in shared memory), phases and sin/cos in
//   fp32 (sinf/cosf with full range reduction: the top band reaches
//   thousands of radians), rounded to bf16 only as matmul inputs;
// - the direction branch (normalize, encode, @ wdir) once per ray of the
//   tile, kept in shared memory as fp32 and added in the color epilogue;
// - activations [128 x 256] bf16 stay in shared memory for all ten layers
//   and are updated in place (all warps finish reading before any writes);
// - every product runs on tensor cores through WMMA bf16 16x16x16 with fp32
//   accumulation, each warp owning a 32 x (N/4) tile of the output;
// - weights (1.2 MB, more than shared memory holds) stream from global
//   memory, which L2 keeps, 32 rows at a time into a double buffer filled by
//   cp.async while the previous rows are multiplied;
// - epilogue: fp32 accumulator + fp32 bias (+ direction term), ReLU, then
//   round to bf16; density (one column) and rgb (three) as dot products.
// - per-ray depths (K3) are read exactly, one per row; the TPU kernel's
//   hi/lo split gather of z has no counterpart here.
//
// Composited modes: a 128-row tile cuts rays, so a block owns
// rb = lcm(S, 128) / S whole rays and walks their samples 128 rows at a
// time. After each tile's MLP, one warp per ray segment of the tile runs the
// exclusive log-transmittance scan with __shfl_up_sync (the TPU kernel's
// segmented roll scan and one-hot reduction matmul), continuing from the
// ray's carried log-transmittance and five sums, kept in shared memory in
// exact fp32 between tiles. sigma and rgb never leave shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int M = 128;          // samples per block
constexpr int THREADS = 512;    // 16 warps: 4 row groups x 4 column groups
constexpr int WARPS = THREADS / 32;
constexpr int HID = 256;
constexpr int CH = 128;         // color layer width
constexpr int KPOS = 64;        // padded position-encoding width
constexpr int KDIR = 32;        // padded direction-encoding width
constexpr int KC = 32;          // weight rows per pipeline step
constexpr int STAGES = 2;       // weight chunks in flight (cp.async ring)
constexpr int LDA = HID + 8;    // activation row stride (elements)
constexpr int LDE = KPOS + 8;   // encoding row stride
constexpr int LDW = HID + 8;    // staged-weight row stride

constexpr size_t ACT_BYTES = size_t(M) * LDA * sizeof(bf16);
constexpr size_t ENC_BYTES = size_t(M) * LDE * sizeof(bf16);
constexpr size_t WBUF_BYTES = size_t(STAGES) * KC * LDW * sizeof(bf16);
constexpr size_t STAGE_BYTES = size_t(WARPS) * 256 * sizeof(float);
constexpr size_t FIXED_BYTES = ACT_BYTES + ENC_BYTES + WBUF_BYTES + STAGE_BYTES +
                               M * sizeof(float) + M * sizeof(int) + M * 3 * sizeof(float) +
                               M * sizeof(float);
constexpr int STATE = 6;        // per ray: log-transmittance carry, r, g, b, depth, acc
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* rays_o;
  const float* rays_d;
  const float* z;        // per-ray depths (ray_z kernels), row stride z_stride
  long long z_stride;
  const bf16* w0;
  const float* b0;
  const bf16* wt;
  const float* bt;
  const bf16* wskip;
  const bf16* wsig;
  const float* bsig;
  const bf16* wbn;
  const float* bbn;
  const bf16* wc0;
  const float* bc0;
  const bf16* wdir;
  const bf16* wc1;
  const float* bc1;
  float* out;            // raw [R * S, 4], or composited [R, 8]
  float* w;              // composited weights [R, S], or null
  long long total;       // n_rays * S
  int n_rays, S, Lp, Ld, skip_pos, bmild, relu_sigma, normalize_dirs, nr_max, rb;
  float near, span, band_scale, dz, sentinel, eps;
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Column k of the positional encoding of x (3 coordinates), in the
// reference layout [x, sin(f0 x), cos(f0 x), sin(f1 x), ...], f_i = 2^i * scale.
// Columns past the encoding are zero padding.
__device__ __forceinline__ float encode_col(const float x[3], int k, int L, float scale) {
  if (k < 3) return x[k];
  int j = k - 3;
  if (j >= 6 * L) return 0.f;
  int band = j / 6, w = j % 6;
  float phase = __fmul_rn(x[w % 3], ldexpf(scale, band));
  return w < 3 ? sinf(phase) : cosf(phase);
}

// acc[i][j] += A[rows of this warp, 0:K] @ W[0:K, cols of this warp].
// A: bf16 in shared memory (row stride lda); W: bf16 row-major [K, N] in
// global memory, staged KC rows at a time through a ring of STAGES buffers
// (one commit group per chunk, empty groups past the end keep the count).
// Ends with __syncthreads(), so the caller may overwrite A afterwards.
template <int N>
__device__ void gemm_acc(Acc (&acc)[2][4], const bf16* A, int lda, int K,
                         const bf16* __restrict__ W, bf16* wbuf) {
  constexpr int NJ = N / 64;        // 16-wide fragments per warp column group
  constexpr int VPR = N / 8;        // 16-byte vectors per weight row
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  const int steps = K / KC;

  auto issue = [&](int step) {
    if (step < steps) {
      bf16* dst = wbuf + (step % STAGES) * KC * LDW;
      const bf16* src = W + size_t(step) * KC * N;
      for (int v = tid; v < KC * VPR; v += THREADS) {
        int r = v / VPR, c = (v % VPR) * 8;
        cp_async16(dst + r * LDW + c, src + size_t(r) * N + c);
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();    // chunk `step` has landed (this thread's part)
    __syncthreads();                // ... everyone's, and step - 1 is consumed
    issue(step + STAGES - 1);       // refills the buffer step - 1 used
    const bf16* wb = wbuf + (step % STAGES) * KC * LDW;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], A + (wr * 32 + i * 16) * lda + step * KC + kk, lda);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, wb + kk * LDW + wc * (N / 4) + j * 16, LDW);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
  }
  __syncthreads();  // A and the ring are free for the caller / next product
}

template <int N>
__device__ __forceinline__ void zero(Acc (&acc)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < N / 64; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// out[rows, cols of this warp] = bf16(act(acc + bias (+ cdir[ray of row])))
template <int N>
__device__ void epilogue(Acc (&acc)[2][4], bf16* out, const float* __restrict__ bias,
                         const float* cdir, const int* slot, bool relu, float* stage) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  float* st = stage + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < N / 64; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = wr * 32 + i * 16, c0 = wc * (N / 4) + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int row = r0 + (e >> 4), col = c0 + (e & 15);
        float v = st[e] + bias[col];
        if (cdir) v += cdir[slot[row] * CH + col];
        if (relu) v = fmaxf(v, 0.f);
        out[row * LDA + col] = __float2bfloat16_rn(v);
      }
      __syncwarp();
    }
  }
}

// Views of the dynamic shared memory.
struct Tile {
  bf16* act;
  bf16* enc;
  bf16* wbuf;
  float* stage;
  float* sig;    // [M] density per row
  int* slot;     // [M] ray of the row, relative to the tile's first ray
  float* pos;    // [M, 3]
  float* zrow;   // [M] depth per row
  float* cdir;   // [nr_max, CH] direction term per ray of the tile
  float* denc;   // [nr_max, KDIR]
  float* state;  // [rb, STATE] composited modes: per-ray running state
};

__device__ __forceinline__ Tile carve(unsigned char* smem, const Params& p) {
  Tile t;
  t.act = reinterpret_cast<bf16*>(smem);
  t.enc = reinterpret_cast<bf16*>(smem + ACT_BYTES);
  t.wbuf = reinterpret_cast<bf16*>(smem + ACT_BYTES + ENC_BYTES);
  t.stage = reinterpret_cast<float*>(smem + ACT_BYTES + ENC_BYTES + WBUF_BYTES);
  t.sig = t.stage + WARPS * 256;
  t.slot = reinterpret_cast<int*>(t.sig + M);
  t.pos = reinterpret_cast<float*>(t.slot + M);
  t.zrow = t.pos + M * 3;
  t.cdir = t.zrow + M;
  t.denc = t.cdir + p.nr_max * CH;
  t.state = t.denc + p.nr_max * KDIR;
  return t;
}

// The network on flat rows n = n0 .. n0 + M - 1 (row n is sample n % S of
// ray n / S; rows at or past n_end are padding). Leaves per row the density
// in t.sig, rgb in t.stage[row * 4 + 1 .. 3] and the depth in t.zrow, and
// ends with __syncthreads().
template <bool ZIN>
__device__ void eval_tile(const Params& p, const Tile& t, long long n0, long long n_end) {
  const int tid = threadIdx.x;
  const long long r_lo = n0 / p.S;
  const long long n_last = min(n0 + M, n_end) - 1;
  const int nr = int(n_last / p.S - r_lo) + 1;       // rays touched by this tile

  // 1. depth and sample position per row (pos = o + d * z in fp32, no fma),
  //    then its encoding, one (row, column) per step
  if (tid < M) {
    const long long n = n0 + tid;
    const bool valid = n < n_end;
    const long long r = valid ? n / p.S : 0;
    const int s = int(n - r * p.S);
    float z = 0.f;
    if (valid) {
      if (ZIN) {
        z = p.z[r * p.z_stride + s];
      } else {
        const float u = __fdiv_rn(float(s), float(p.S - 1));
        z = __fadd_rn(p.near, __fmul_rn(p.span, u));
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      t.pos[tid * 3 + c] =
          valid ? __fadd_rn(p.rays_o[r * 3 + c], __fmul_rn(p.rays_d[r * 3 + c], z)) : 0.f;
    t.zrow[tid] = z;
    t.slot[tid] = valid ? int(r - r_lo) : 0;
  }
  __syncthreads();
  for (int e = tid; e < M * KPOS; e += THREADS) {
    const int row = e / KPOS, k = e % KPOS;
    const float v = n0 + row < n_end ? encode_col(t.pos + row * 3, k, p.Lp, p.band_scale) : 0.f;
    t.enc[row * LDE + k] = __float2bfloat16_rn(v);
  }

  // 2. direction branch once per ray of the tile: cdir = bf16(denc) @ wdir
  for (int e = tid; e < nr * KDIR; e += THREADS) {
    const int sl = e / KDIR, k = e % KDIR;
    const long long r = r_lo + sl;
    float d[3] = {p.rays_d[r * 3], p.rays_d[r * 3 + 1], p.rays_d[r * 3 + 2]};
    if (p.normalize_dirs) {
      const float ss = __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                                 __fmul_rn(d[2], d[2]));
      const float inv = rsqrtf(__fadd_rn(ss, 1e-12f));
#pragma unroll
      for (int c = 0; c < 3; ++c) d[c] = __fmul_rn(d[c], inv);
    }
    t.denc[e] = __bfloat162float(__float2bfloat16_rn(encode_col(d, k, p.Ld, p.band_scale)));
  }
  __syncthreads();
  for (int e = tid; e < nr * CH; e += THREADS) {
    const int sl = e / CH, col = e % CH;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < KDIR; ++k)
      acc = fmaf(t.denc[sl * KDIR + k], __bfloat162float(p.wdir[k * CH + col]), acc);
    t.cdir[e] = acc;
  }
  __syncthreads();

  // 3. trunk: layer 0 from the encoding, layers 1..7 in place, skip adds
  //    the encoding rows into the same accumulators
  Acc acc[2][4];
  zero<HID>(acc);
  gemm_acc<HID>(acc, t.enc, LDE, KPOS, p.w0, t.wbuf);
  epilogue<HID>(acc, t.act, p.b0, nullptr, t.slot, true, t.stage);
  __syncthreads();
  for (int i = 1; i < 8; ++i) {
    zero<HID>(acc);
    gemm_acc<HID>(acc, t.act, LDA, HID, p.wt + size_t(i - 1) * HID * HID, t.wbuf);
    if (i == p.skip_pos) gemm_acc<HID>(acc, t.enc, LDE, KPOS, p.wskip, t.wbuf);
    epilogue<HID>(acc, t.act, p.bt + (i - 1) * HID, nullptr, t.slot, true, t.stage);
    __syncthreads();
  }

  // 4. density: 4 threads per row, 64 hidden units each
  {
    const int row = tid >> 2, q = tid & 3;
    float part = 0.f;
    for (int k = q * 64; k < q * 64 + 64; ++k)
      part = fmaf(__bfloat162float(t.act[row * LDA + k]), __bfloat162float(p.wsig[k]), part);
    part += __shfl_xor_sync(FULL, part, 1);
    part += __shfl_xor_sync(FULL, part, 2);
    if (q == 0) {
      float s = part + p.bsig[0];
      t.sig[row] = p.relu_sigma ? fmaxf(s, 0.f) : s;
    }
  }
  __syncthreads();

  // 5. bmild bottleneck (no activation), then the color layer with the
  //    per-ray direction term, both in place
  if (p.bmild) {
    zero<HID>(acc);
    gemm_acc<HID>(acc, t.act, LDA, HID, p.wbn, t.wbuf);
    epilogue<HID>(acc, t.act, p.bbn, nullptr, t.slot, false, t.stage);
    __syncthreads();
  }
  zero<CH>(acc);
  gemm_acc<CH>(acc, t.act, LDA, HID, p.wc0, t.wbuf);
  epilogue<CH>(acc, t.act, p.bc0, t.cdir, t.slot, true, t.stage);
  __syncthreads();

  // 6. rgb = sigmoid(c @ wc1 + bc1) into stage[row * 4 + 1 .. 3]
  for (int e = tid; e < M * 3; e += THREADS) {
    const int row = e / 3, ch = e % 3;
    float v = 0.f;
    for (int k = 0; k < CH; ++k)
      v = fmaf(__bfloat162float(t.act[row * LDA + k]), __bfloat162float(p.wc1[k * 3 + ch]), v);
    v += p.bc1[ch];
    t.stage[row * 4 + 1 + ch] = 1.f / (1.f + expf(-v));
  }
  __syncthreads();
}

// Raw modes: one 128-row tile per block, out row = (sigma, r, g, b).
template <bool ZIN>
__device__ void raw_body(const Params& p, unsigned char* smem) {
  const Tile t = carve(smem, p);
  const int tid = threadIdx.x;
  const long long n0 = (long long)blockIdx.x * M;
  eval_tile<ZIN>(p, t, n0, p.total);
  if (tid < M && n0 + tid < p.total) {
    const float* res = t.stage + tid * 4;
    reinterpret_cast<float4*>(p.out)[n0 + tid] = make_float4(t.sig[tid], res[1], res[2], res[3]);
  }
}

// Volume rendering of the tile's rows n0 .. stop - 1: one warp per ray
// segment, lanes over 32 samples at a time. dist = z[s+1] - z[s] (per-ray
// depths) or dz (uniform), the sentinel for the last sample, times ||d||;
// alpha = 1 - exp(-relu(sigma) * dist); T = exp(carry + exclusive sum of
// log(max(1 - alpha, eps))); w = alpha * T.
template <bool ZIN>
__device__ void composite_tile(const Params& p, const Tile& t, long long n0, long long n_end,
                               long long r_first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stop = min(n0 + M, n_end);
  const long long r_lo = n0 / p.S;
  const int nr = int((stop - 1) / p.S - r_lo) + 1;
  for (int seg = warp; seg < nr; seg += WARPS) {
    const long long r = r_lo + seg;
    const long long a = max(n0, r * p.S), b = min(stop, (r + 1) * p.S);
    float* st = t.state + (r - r_first) * STATE;
    const float dx = p.rays_d[r * 3], dy = p.rays_d[r * 3 + 1], dzr = p.rays_d[r * 3 + 2];
    const float dnorm =
        sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dzr, dzr)));
    float carry = st[0];
    float sr = 0.f, sg = 0.f, sb = 0.f, sd = 0.f, sa = 0.f;
    for (long long c = a; c < b; c += 32) {
      const long long n = c + lane;
      const bool valid = n < b;
      const int row = int(n - n0);
      const int s = int(n - r * p.S);
      float sigma = 0.f, cr = 0.f, cg = 0.f, cb = 0.f, zs = 0.f, dist = 0.f;
      if (valid) {
        sigma = t.sig[row];
        cr = t.stage[row * 4 + 1];
        cg = t.stage[row * 4 + 2];
        cb = t.stage[row * 4 + 3];
        zs = t.zrow[row];
        if (s == p.S - 1)
          dist = p.sentinel;
        else
          dist = ZIN ? __fsub_rn(p.z[r * p.z_stride + s + 1], zs) : p.dz;
        dist = __fmul_rn(dist, dnorm);
      }
      const float alpha = valid ? 1.f - expf(-fmaxf(sigma, 0.f) * dist) : 0.f;
      const float lt = valid ? logf(fmaxf(1.f - alpha, p.eps)) : 0.f;
      float incl = lt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += v;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = 0.f;
      const float wv = alpha * expf(carry + excl);
      if (valid && p.w) p.w[r * p.S + s] = wv;
      sr = fmaf(wv, cr, sr);
      sg = fmaf(wv, cg, sg);
      sb = fmaf(wv, cb, sb);
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
    if (lane == 0) {
      st[0] = carry;
      st[1] += sr;
      st[2] += sg;
      st[3] += sb;
      st[4] += sd;
      st[5] += sa;
    }
  }
}

// Composited modes: the block owns rays r_first .. r_first + rb - 1 and
// walks their samples one 128-row tile at a time.
template <bool ZIN>
__device__ void composite_body(const Params& p, unsigned char* smem) {
  const Tile t = carve(smem, p);
  const int tid = threadIdx.x;
  const long long r_first = (long long)blockIdx.x * p.rb;
  const int nrb = int(min((long long)p.rb, (long long)p.n_rays - r_first));
  const long long n_end = (r_first + nrb) * p.S;
  for (int e = tid; e < nrb * STATE; e += THREADS) t.state[e] = 0.f;
  for (long long n0 = r_first * p.S; n0 < n_end; n0 += M) {
    eval_tile<ZIN>(p, t, n0, n_end);
    composite_tile<ZIN>(p, t, n0, n_end, r_first);
    __syncthreads();  // state, and the tile's rows, are free for the next tile
  }
  for (int e = tid; e < nrb * 8; e += THREADS) {
    const int rl = e >> 3, k = e & 7;
    p.out[(r_first + rl) * 8 + k] = k < 5 ? t.state[rl * STATE + 1 + k] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS, 1) ray_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  raw_body<false>(p, smem);
}

__global__ void __launch_bounds__(THREADS, 1) ray_z_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  raw_body<true>(p, smem);
}

__global__ void __launch_bounds__(THREADS, 1) ray_composite_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  composite_body<false>(p, smem);
}

__global__ void __launch_bounds__(THREADS, 1) ray_z_composite_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  composite_body<true>(p, smem);
}

// Shared memory the kernel needs: the fixed tiles, the direction branch of
// every ray a tile can touch and the running state of a block's rays.
size_t smem_bytes(int nr_max, int rb) {
  return FIXED_BYTES + size_t(nr_max) * (CH + KDIR) * sizeof(float) +
         size_t(rb) * STATE * sizeof(float);
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int ray_render(const float* rays_o, const float* rays_d, const float* z, long long z_stride,
               int n_rays, int n_samples, float near, float span, const void* w0,
               const float* b0, const void* wt, const float* bt, const void* wskip,
               const void* wsig, const float* bsig, const void* wbn, const float* bbn,
               const void* wc0, const float* bc0, const void* wdir, const void* wc1,
               const float* bc1, int Lp, int Ld, int skip_pos, int bmild, int relu_sigma,
               int normalize_dirs, float band_scale, int composited, float dz, float sentinel,
               float eps, float* out, float* w, void* stream) {
  Params p;
  p.rays_o = rays_o;
  p.rays_d = rays_d;
  p.z = z;
  p.z_stride = z_stride;
  p.w0 = static_cast<const bf16*>(w0);
  p.b0 = b0;
  p.wt = static_cast<const bf16*>(wt);
  p.bt = bt;
  p.wskip = static_cast<const bf16*>(wskip);
  p.wsig = static_cast<const bf16*>(wsig);
  p.bsig = bsig;
  p.wbn = static_cast<const bf16*>(wbn);
  p.bbn = bbn;
  p.wc0 = static_cast<const bf16*>(wc0);
  p.bc0 = bc0;
  p.wdir = static_cast<const bf16*>(wdir);
  p.wc1 = static_cast<const bf16*>(wc1);
  p.bc1 = bc1;
  p.out = out;
  p.w = w;
  p.total = (long long)n_rays * n_samples;
  p.n_rays = n_rays;
  p.S = n_samples;
  p.Lp = Lp;
  p.Ld = Ld;
  p.skip_pos = skip_pos;
  p.bmild = bmild;
  p.relu_sigma = relu_sigma;
  p.normalize_dirs = normalize_dirs;
  p.nr_max = (M - 1) / n_samples + 2;
  p.rb = composited ? M / gcd(n_samples, M) : 0;
  p.near = near;
  p.span = span;
  p.band_scale = band_scale;
  p.dz = dz;
  p.sentinel = sentinel;
  p.eps = eps;
  if (n_samples < (z ? 1 : 2) || 3 + 6 * Lp > KPOS || 3 + 6 * Ld > KDIR)
    return int(cudaErrorInvalidValue);
  void (*kernel)(const Params) = z ? (composited ? ray_z_composite_kernel : ray_z_kernel)
                                   : (composited ? ray_composite_kernel : ray_kernel);
  const size_t smem = smem_bytes(p.nr_max, p.rb);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long blocks = composited ? (n_rays + p.rb - 1) / p.rb : (p.total + M - 1) / M;
  kernel<<<unsigned(blocks), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

}  // extern "C"
