// The NeRF MLP on one 128-row tile, shared by every kernel that evaluates
// the network: the ray kernels (render_samples.cu), the per-sample forward
// (mlp_forward.cu) and the forward recompute of the backward kernel
// (mlp_backward.cu). One body, so their arithmetic is the same.
//
// - one block of 512 threads (16 warps) owns M = 128 rows;
// - the encoding [128 x 64] and the activations [128 x 256] are bf16 in
//   shared memory; the activations are updated in place layer by layer (all
//   warps finish reading before any writes);
// - every product runs on tensor cores through WMMA bf16 16x16x16 with fp32
//   accumulation, each warp owning a 32 x (N/4) tile of the output;
// - weights (1.2 MB, more than shared memory holds) stream from global
//   memory, which L2 keeps, 32 rows at a time into a double buffer filled by
//   cp.async while the previous rows are multiplied;
// - epilogue: fp32 accumulator + fp32 bias (+ direction term), ReLU, then
//   round to bf16; density (one column) and rgb (three) as dot products.
//
// The direction term of the color layer comes in one of two forms: a
// per-ray fp32 row looked up through `slot` (the ray kernels, where many
// rows share a ray), or a second product `denc @ wdir` accumulated into the
// color layer's accumulators from a per-row bf16 direction encoding (the
// per-sample kernels).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int M = 128;          // rows (samples) per tile
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
constexpr int LDD = KDIR + 8;   // per-row direction-encoding row stride
constexpr int LDW = HID + 8;    // staged-weight row stride

constexpr size_t ACT_BYTES = size_t(M) * LDA * sizeof(bf16);
constexpr size_t ENC_BYTES = size_t(M) * LDE * sizeof(bf16);
constexpr size_t DENC_BYTES = size_t(M) * LDD * sizeof(bf16);
constexpr size_t WBUF_BYTES = size_t(STAGES) * KC * LDW * sizeof(bf16);
constexpr size_t STAGE_BYTES = size_t(WARPS) * 256 * sizeof(float);
constexpr unsigned FULL = 0xffffffffu;

// The network: weights in pack_params' layout (nerf_tpu_torch/ops/mlp_kernel.py)
// and the architecture switches.
struct Net {
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
  int Lp, Ld, skip_pos, bmild, relu_sigma, normalize_dirs;
  float band_scale;
};

// `w`: the 14 weight pointers in PackedWeights order (wbn, bbn null unless bmild).
inline Net make_net(const void* const* w, int Lp, int Ld, int skip_pos, int bmild,
                    int relu_sigma, int normalize_dirs, float band_scale) {
  Net n;
  n.w0 = static_cast<const bf16*>(w[0]);
  n.b0 = static_cast<const float*>(w[1]);
  n.wt = static_cast<const bf16*>(w[2]);
  n.bt = static_cast<const float*>(w[3]);
  n.wskip = static_cast<const bf16*>(w[4]);
  n.wsig = static_cast<const bf16*>(w[5]);
  n.bsig = static_cast<const float*>(w[6]);
  n.wbn = static_cast<const bf16*>(w[7]);
  n.bbn = static_cast<const float*>(w[8]);
  n.wc0 = static_cast<const bf16*>(w[9]);
  n.bc0 = static_cast<const float*>(w[10]);
  n.wdir = static_cast<const bf16*>(w[11]);
  n.wc1 = static_cast<const bf16*>(w[12]);
  n.bc1 = static_cast<const float*>(w[13]);
  n.Lp = Lp;
  n.Ld = Ld;
  n.skip_pos = skip_pos;
  n.bmild = bmild;
  n.relu_sigma = relu_sigma;
  n.normalize_dirs = normalize_dirs;
  n.band_scale = band_scale;
  return n;
}

inline bool net_fits(const Net& n) { return 3 + 6 * n.Lp <= KPOS && 3 + 6 * n.Ld <= KDIR; }

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

// d * rsqrt(|d|^2 + 1e-12), in fp32 without fused multiply-adds
__device__ __forceinline__ void normalize_dir(float d[3]) {
  const float ss = __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                             __fmul_rn(d[2], d[2]));
  const float inv = rsqrtf(__fadd_rn(ss, 1e-12f));
#pragma unroll
  for (int c = 0; c < 3; ++c) d[c] = __fmul_rn(d[c], inv);
}

// enc[row, 0:KPOS] = bf16(encoding of pos[row]) for the tile's first
// `valid` rows, zero for the rest. pos: [M, 3] fp32 in shared memory.
__device__ __forceinline__ void encode_pos_tile(bf16* enc, const float* pos, long long valid,
                                                int L, float scale) {
  for (int e = threadIdx.x; e < M * KPOS; e += THREADS) {
    const int row = e / KPOS, k = e % KPOS;
    const float v = row < valid ? encode_col(pos + row * 3, k, L, scale) : 0.f;
    enc[row * LDE + k] = __float2bfloat16_rn(v);
  }
}

// denc[row, 0:KDIR] = bf16(encoding of dir[row]), the per-row form of the
// direction branch. dir: [M, 3] fp32 in shared memory, already normalized
// where the model asks for it.
__device__ __forceinline__ void encode_dir_tile(bf16* denc, const float* dir, long long valid,
                                                int L, float scale) {
  for (int e = threadIdx.x; e < M * KDIR; e += THREADS) {
    const int row = e / KDIR, k = e % KDIR;
    const float v = row < valid ? encode_col(dir + row * 3, k, L, scale) : 0.f;
    denc[row * LDD + k] = __float2bfloat16_rn(v);
  }
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

  auto fetch = [&](int step) {
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

  for (int s = 0; s < STAGES - 1; ++s) fetch(s);
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();    // chunk `step` has landed (this thread's part)
    __syncthreads();                // ... everyone's, and step - 1 is consumed
    fetch(step + STAGES - 1);       // refills the buffer step - 1 used
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

// hs[M, HID] (global, contiguous) = act[M, 0:HID], 16 bytes a thread
__device__ __forceinline__ void save_act(bf16* __restrict__ hs, const bf16* act) {
  for (int v = threadIdx.x; v < M * HID / 8; v += THREADS) {
    const int row = v / (HID / 8), c = (v % (HID / 8)) * 8;
    *reinterpret_cast<uint4*>(hs + row * HID + c) =
        *reinterpret_cast<const uint4*>(act + row * LDA + c);
  }
}

// The network on the tile's 128 rows, from the encoding in `enc`. Leaves per
// row the density in sig, rgb in stage[row * 4 + 1 .. 3] and the color
// layer's activations (bf16) in act[:, 0:CH], and ends with __syncthreads().
// DIR_ROWS: the direction term is denc @ wdir per row (cdir, slot unused);
// otherwise the per-ray fp32 rows of cdir through slot (denc unused).
// SAVE: the trunk's activations h0..h7 are also written to hs [8, M, HID].
template <bool DIR_ROWS, bool SAVE>
__device__ void mlp_tile(const Net& p, bf16* act, const bf16* enc, bf16* wbuf, float* stage,
                         float* sig, const float* cdir, const int* slot, const bf16* denc,
                         bf16* hs) {
  const int tid = threadIdx.x;

  // trunk: layer 0 from the encoding, layers 1..7 in place, skip adds the
  // encoding rows into the same accumulators
  Acc acc[2][4];
  zero<HID>(acc);
  gemm_acc<HID>(acc, enc, LDE, KPOS, p.w0, wbuf);
  epilogue<HID>(acc, act, p.b0, nullptr, nullptr, true, stage);
  __syncthreads();
  if (SAVE) save_act(hs, act);
  for (int i = 1; i < 8; ++i) {
    zero<HID>(acc);
    gemm_acc<HID>(acc, act, LDA, HID, p.wt + size_t(i - 1) * HID * HID, wbuf);
    if (i == p.skip_pos) gemm_acc<HID>(acc, enc, LDE, KPOS, p.wskip, wbuf);
    epilogue<HID>(acc, act, p.bt + (i - 1) * HID, nullptr, nullptr, true, stage);
    __syncthreads();
    if (SAVE) save_act(hs + size_t(i) * M * HID, act);
  }

  // density: 4 threads per row, 64 hidden units each
  {
    const int row = tid >> 2, q = tid & 3;
    float part = 0.f;
    for (int k = q * 64; k < q * 64 + 64; ++k)
      part = fmaf(__bfloat162float(act[row * LDA + k]), __bfloat162float(p.wsig[k]), part);
    part += __shfl_xor_sync(FULL, part, 1);
    part += __shfl_xor_sync(FULL, part, 2);
    if (q == 0) {
      float s = part + p.bsig[0];
      sig[row] = p.relu_sigma ? fmaxf(s, 0.f) : s;
    }
  }
  __syncthreads();

  // bmild bottleneck (no activation), then the color layer with the
  // direction term, both in place
  if (p.bmild) {
    zero<HID>(acc);
    gemm_acc<HID>(acc, act, LDA, HID, p.wbn, wbuf);
    epilogue<HID>(acc, act, p.bbn, nullptr, nullptr, false, stage);
    __syncthreads();
  }
  zero<CH>(acc);
  gemm_acc<CH>(acc, act, LDA, HID, p.wc0, wbuf);
  if (DIR_ROWS) gemm_acc<CH>(acc, denc, LDD, KDIR, p.wdir, wbuf);
  epilogue<CH>(acc, act, p.bc0, DIR_ROWS ? nullptr : cdir, slot, true, stage);
  __syncthreads();

  // rgb = sigmoid(c @ wc1 + bc1) into stage[row * 4 + 1 .. 3]
  for (int e = tid; e < M * 3; e += THREADS) {
    const int row = e / 3, ch = e % 3;
    float v = 0.f;
    for (int k = 0; k < CH; ++k)
      v = fmaf(__bfloat162float(act[row * LDA + k]), __bfloat162float(p.wc1[k * 3 + ch]), v);
    v += p.bc1[ch];
    stage[row * 4 + 1 + ch] = 1.f / (1.f + expf(-v));
  }
  __syncthreads();
}

}  // namespace
