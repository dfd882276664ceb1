// The NeRF MLP on one 128-row tile, shared by the WMMA kernels that evaluate
// the network: the composited ray kernels (render_samples.cu) and the builds
// kept as timed comparisons of the Hopper kernels (mlp_forward.cu,
// mlp_quant.cu, mlp_backward.cu). One body, so their arithmetic is the same;
// wgmma_common.cuh builds the Hopper kernels on its constants, Net and
// encoding.
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
//
// Weight routes (template parameter WQ; nerf_tpu_torch/ops/quant.py has the
// plain versions):
// - WQ_BF16: bf16 matrices, as above;
// - WQ_INT8, WQ_INT16 (the TPU kernels' `quant_w_dict`): the matrices are
//   int8 / int16 in global memory with one fp32 scale per output column.
//   Each thread reads 16 bytes of a weight chunk into registers while the
//   previous chunk is multiplied, then writes bf16(f32(q) * s[col]) into the
//   operand ring: the dequantized matrix exists only there, 32 rows at a
//   time. The scalar heads dequantize the same way;
// - WQ_INT8_COMPUTE (the TPU kernels' `_int8_mm` hook): layer 0, the trunk
//   layers and the skip product are s8 x s8 -> s32 WMMA products. The
//   encoding is quantized once per tile at a fixed scale,
//   clip(rint(enc * (enc_scale[k] * 127)), +-127); the bf16 activations are
//   quantized per layer and row, rint(a * (127 / max(max|a|, 1e-20))), into
//   an s8 tile beside them. The s32 result goes through the stage buffer to
//   fp32: (acc * ax[row]) * (s[col] * (1 / 127)), without ax for the
//   encoding products. The skip layer's two products carry different
//   scales, so each is scaled to fp32 before they are added. The heads, the
//   bottleneck, the color layers and the direction branch take WQ_INT8.

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

// weight routes
constexpr int WQ_BF16 = 0, WQ_INT8 = 1, WQ_INT16 = 2, WQ_INT8_COMPUTE = 3;
// the int8-compute route's s8 tiles: activations, encoding (row strides a
// multiple of 16 bytes, as WMMA's 1-byte loads need) and the per-row absmax
constexpr int LDQ = HID + 16;
constexpr int LDEQ = KPOS + 16;
constexpr int LDWQ = HID + 16;  // s8 weight chunk row stride, inside the bf16 ring's bytes
constexpr size_t QTILE_BYTES = size_t(M) * LDQ + size_t(M) * LDEQ + M * sizeof(float);
__host__ __device__ constexpr size_t qtile_bytes(int wq) { return wq == WQ_INT8_COMPUTE ? QTILE_BYTES : 0; }
static_assert(size_t(STAGES) * KC * LDWQ <= WBUF_BYTES, "the s8 ring fits the bf16 ring");

// element type of the matrices in global memory, and the route the heads take
template <int WQ> struct WeightType { typedef bf16 T; };
template <> struct WeightType<WQ_INT8> { typedef int8_t T; };
template <> struct WeightType<WQ_INT16> { typedef int16_t T; };
template <> struct WeightType<WQ_INT8_COMPUTE> { typedef int8_t T; };
__host__ __device__ constexpr int head_route(int wq) { return wq == WQ_INT8_COMPUTE ? WQ_INT8 : wq; }

// The network: weights in pack_params' layout (nerf_tpu_torch/ops/mlp_kernel.py)
// and the architecture switches.
// A matrix is bf16 on the WQ_BF16 route, else int8 / int16 with its scales
// (one fp32 per output column; wt_s is [7, 256]) beside it.
struct Net {
  const void* w0;
  const float* b0;
  const void* wt;
  const float* bt;
  const void* wskip;
  const void* wsig;
  const float* bsig;
  const void* wbn;
  const float* bbn;
  const void* wc0;
  const float* bc0;
  const void* wdir;
  const void* wc1;
  const float* bc1;
  const float *w0_s, *wt_s, *wskip_s, *wsig_s, *wbn_s, *wc0_s, *wdir_s, *wc1_s;
  const float* enc_scale;  // [KPOS], int8 compute only
  int Lp, Ld, skip_pos, bmild, relu_sigma, normalize_dirs;
  float band_scale;
};

// `w`: the 14 weight pointers in PackedWeights order (wbn, bbn null unless
// bmild). `scales`: null on the bf16 route, else the eight matrices' scales
// in the same order and enc_scale.
inline Net make_net(const void* const* w, const void* const* scales, int Lp, int Ld,
                    int skip_pos, int bmild, int relu_sigma, int normalize_dirs,
                    float band_scale) {
  Net n;
  n.w0 = w[0];
  n.b0 = static_cast<const float*>(w[1]);
  n.wt = w[2];
  n.bt = static_cast<const float*>(w[3]);
  n.wskip = w[4];
  n.wsig = w[5];
  n.bsig = static_cast<const float*>(w[6]);
  n.wbn = w[7];
  n.bbn = static_cast<const float*>(w[8]);
  n.wc0 = w[9];
  n.bc0 = static_cast<const float*>(w[10]);
  n.wdir = w[11];
  n.wc1 = w[12];
  n.bc1 = static_cast<const float*>(w[13]);
  const float* sc[9];
  for (int i = 0; i < 9; ++i) sc[i] = scales ? static_cast<const float*>(scales[i]) : nullptr;
  n.w0_s = sc[0];
  n.wt_s = sc[1];
  n.wskip_s = sc[2];
  n.wsig_s = sc[3];
  n.wbn_s = sc[4];
  n.wc0_s = sc[5];
  n.wdir_s = sc[6];
  n.wc1_s = sc[7];
  n.enc_scale = sc[8];
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

// The quantized routes need every scale (and int8 compute its enc_scale).
inline bool net_has_scales(const Net& n, int wq) {
  if (wq == WQ_BF16) return true;
  return n.w0_s && n.wt_s && n.wskip_s && n.wsig_s && n.wc0_s && n.wdir_s && n.wc1_s &&
         (!n.bmild || n.wbn_s) && (wq != WQ_INT8_COMPUTE || n.enc_scale);
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> IAcc;

// Element idx of a matrix as the products see it: the bf16 value, or
// bf16(f32(q) * s[col]) on the quantized routes (HQ: WQ_BF16, WQ_INT8 or
// WQ_INT16).
template <int HQ>
__device__ __forceinline__ float weight_at(const void* w, const float* s, int idx, int col) {
  if constexpr (HQ == WQ_BF16) {
    return __bfloat162float(static_cast<const bf16*>(w)[idx]);
  } else {
    const float q = float(static_cast<const typename WeightType<HQ>::T*>(w)[idx]);
    return __bfloat162float(__float2bfloat16_rn(__fmul_rn(q, s[col])));
  }
}

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

// One staged chunk of a product: acc[i][j] += a[32 rows, 0:KC] @ b[0:KC, NJ
// 16-wide column fragments]; a and b point at the warp's rows of A (at the
// chunk's first column) and at its columns of the staged chunk. T: bf16
// with float accumulators, or signed char with int accumulators.
template <int NJ, typename T, typename ACC>
__device__ __forceinline__ void mma_chunk(ACC (&acc)[2][4], const T* a, int lda, const T* b,
                                          int ldw) {
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], a + i * 16 * lda + kk, lda);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + kk * ldw + j * 16, ldw);
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
    }
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
    mma_chunk<NJ>(acc, A + wr * 32 * lda + step * KC, lda,
                  wbuf + (step % STAGES) * KC * LDW + wc * (N / 4), LDW);
  }
  __syncthreads();  // A and the ring are free for the caller / next product
}

// The same product from intN weights W [K, N] with per-column scales S [N]
// (W and S 16-byte aligned): chunk step + 1 travels global memory ->
// registers (16 bytes a thread and trip) while chunk `step` is multiplied,
// then is dequantized into the ring as bf16(f32(q) * S[col]).
template <int N, typename WT>
__device__ void gemm_acc_dq(Acc (&acc)[2][4], const bf16* A, int lda, int K,
                            const WT* __restrict__ W, const float* __restrict__ S, bf16* wbuf) {
  constexpr int NJ = N / 64;
  constexpr int EPV = 16 / int(sizeof(WT));   // weights per 16-byte vector
  constexpr int VPR = N / EPV;                // vectors per weight row
  constexpr int NV = KC * VPR;                // vectors per chunk
  constexpr int TRIPS = (NV + THREADS - 1) / THREADS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  const int steps = K / KC;
  uint4 regs[TRIPS];

  auto fetch = [&](int step) {
    if (step >= steps) return;
    const uint4* src = reinterpret_cast<const uint4*>(W + size_t(step) * KC * N);
#pragma unroll
    for (int t = 0; t < TRIPS; ++t) {
      const int v = tid + t * THREADS;
      if (v < NV) regs[t] = __ldg(src + v);
    }
  };
  auto stage = [&](int step) {
    if (step >= steps) return;
    bf16* dst = wbuf + (step % STAGES) * KC * LDW;
#pragma unroll
    for (int t = 0; t < TRIPS; ++t) {
      const int v = tid + t * THREADS;
      if (v >= NV) continue;
      const int r = v / VPR, c = (v % VPR) * EPV;
      const WT* q = reinterpret_cast<const WT*>(&regs[t]);
      __align__(16) __nv_bfloat162 vals[EPV / 2];
#pragma unroll
      for (int e = 0; e < EPV; e += 4) {
        const float4 sc = __ldg(reinterpret_cast<const float4*>(S + c + e));
        vals[e / 2] = __floats2bfloat162_rn(__fmul_rn(float(q[e]), sc.x),
                                            __fmul_rn(float(q[e + 1]), sc.y));
        vals[e / 2 + 1] = __floats2bfloat162_rn(__fmul_rn(float(q[e + 2]), sc.z),
                                                __fmul_rn(float(q[e + 3]), sc.w));
      }
#pragma unroll
      for (int e = 0; e < EPV; e += 8)
        *reinterpret_cast<uint4*>(dst + r * LDW + c + e) =
            *reinterpret_cast<const uint4*>(vals + e / 2);
    }
  };

  fetch(0);
  stage(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    fetch(step + 1);
    mma_chunk<NJ>(acc, A + wr * 32 * lda + step * KC, lda,
                  wbuf + (step % STAGES) * KC * LDW + wc * (N / 4), LDW);
    stage(step + 1);   // the buffer chunk step - 1 used: everyone is past it
    __syncthreads();   // chunk step + 1 is staged, chunk step consumed
  }
}

// acc += A @ W on the route HQ (WQ_BF16, WQ_INT8 or WQ_INT16).
template <int N, int HQ>
__device__ __forceinline__ void product(Acc (&acc)[2][4], const bf16* A, int lda, int K,
                                        const void* W, const float* S, bf16* wbuf) {
  if constexpr (HQ == WQ_BF16)
    gemm_acc<N>(acc, A, lda, K, static_cast<const bf16*>(W), wbuf);
  else
    gemm_acc_dq<N>(acc, A, lda, K, static_cast<const typename WeightType<HQ>::T*>(W), S, wbuf);
}

// ---- int8 compute ---------------------------------------------------------

// acc[i][j] (s32) = A[rows of this warp, 0:K] @ W[0:K, cols of this warp]:
// A s8 in shared memory (row stride lda bytes), W s8 row-major [K, HID] in
// global memory, staged through the ring like gemm_acc's (its bytes, as
// rows of LDWQ). Ends with __syncthreads().
__device__ void gemm_s8(IAcc (&acc)[2][4], const signed char* A, int lda, int K,
                        const signed char* __restrict__ W, signed char* wbuf) {
  constexpr int VPR = HID / 16;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  const int steps = K / KC;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);

  auto fetch = [&](int step) {
    if (step < steps) {
      signed char* dst = wbuf + (step % STAGES) * KC * LDWQ;
      const signed char* src = W + size_t(step) * KC * HID;
      for (int v = tid; v < KC * VPR; v += THREADS) {
        int r = v / VPR, c = (v % VPR) * 16;
        cp_async16(dst + r * LDWQ + c, src + size_t(r) * HID + c);
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < STAGES - 1; ++s) fetch(s);
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    fetch(step + STAGES - 1);
    mma_chunk<4>(acc, A + wr * 32 * lda + step * KC, lda,
                 wbuf + (step % STAGES) * KC * LDWQ + wc * (HID / 4), LDWQ);
  }
  __syncthreads();
}

// y += (f32(acc) (* ax[row])) * (s[col] * (1 / 127)), through the warp's
// stage buffer. Element t of y[i][j] is entry lane + 32 t of the 16 x 16
// fragment (i, j): row (lane + 32 t) / 16, column (lane + 32 t) % 16.
__device__ void scale_add(IAcc (&acc)[2][4], float (&y)[2][4][8], const float* ax,
                          const float* __restrict__ s, float* stage) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  int* st = reinterpret_cast<int*>(stage + warp * 256);
  const float inv127 = float(1.0 / 127.0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = wr * 32 + i * 16, c0 = wc * (HID / 4) + j * 16;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = lane + 32 * t;
        float v = float(st[e]);
        if (ax) v = __fmul_rn(v, ax[r0 + (e >> 4)]);
        v = __fmul_rn(v, __fmul_rn(s[c0 + (e & 15)], inv127));
        y[i][j][t] = __fadd_rn(y[i][j][t], v);
      }
      __syncwarp();
    }
  }
}

// out[rows, cols of this warp] = bf16(relu(y + bias)), y in scale_add's layout
__device__ void finish_s8(float (&y)[2][4][8], bf16* out, const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = lane + 32 * t;
        const int row = wr * 32 + i * 16 + (e >> 4), col = wc * (HID / 4) + j * 16 + (e & 15);
        out[row * LDA + col] = __float2bfloat16_rn(fmaxf(y[i][j][t] + bias[col], 0.f));
      }
}

// The int8-compute route's tiles in shared memory.
struct QTile {
  signed char* aq;    // [M, LDQ] activations of the current layer
  signed char* encq;  // [M, LDEQ] the encoding
  float* ax;          // [M] per-row absmax of the current layer's activations
};

__device__ __forceinline__ QTile carve_qtile(unsigned char* p) {
  QTile q;
  q.aq = reinterpret_cast<signed char*>(p);
  q.encq = q.aq + size_t(M) * LDQ;
  q.ax = reinterpret_cast<float*>(q.encq + size_t(M) * LDEQ);
  return q;
}

// encq = clip(rint(enc * (enc_scale * 127)), +-127)
__device__ __forceinline__ void quantize_enc(const QTile& q, const bf16* enc,
                                             const float* __restrict__ enc_scale) {
  for (int e = threadIdx.x; e < M * KPOS; e += THREADS) {
    const int row = e / KPOS, k = e % KPOS;
    const float v = rintf(__fmul_rn(__bfloat162float(enc[row * LDE + k]),
                                    __fmul_rn(enc_scale[k], 127.f)));
    q.encq[row * LDEQ + k] = (signed char)int(fminf(fmaxf(v, -127.f), 127.f));
  }
}

// Per row: ax = max|act|, aq = rint(act * (127 / max(ax, 1e-20))). Four
// threads a row, each on eight interleaved runs of eight columns.
__device__ __forceinline__ void quantize_act(const QTile& q, const bf16* act) {
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  uint4 v[8];
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = *reinterpret_cast<const uint4*>(act + row * LDA + (part + 4 * j) * 8);
    const bf16* a = reinterpret_cast<const bf16*>(&v[j]);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(__bfloat162float(a[e])));
  }
  m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
  m = fmaxf(m, __shfl_xor_sync(FULL, m, 2));
  const float inv = __fdiv_rn(127.f, fmaxf(m, 1e-20f));
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bf16* a = reinterpret_cast<const bf16*>(&v[j]);
    __align__(8) signed char out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      out[e] = (signed char)__float2int_rn(__fmul_rn(__bfloat162float(a[e]), inv));
    *reinterpret_cast<uint2*>(q.aq + row * LDQ + (part + 4 * j) * 8) =
        *reinterpret_cast<const uint2*>(out);
  }
  if (part == 0) q.ax[row] = m;
}

// The trunk (layer 0, layers 1..7 with the skip) on the int8-compute route:
// act = h7 in bf16, as the other routes leave it.
__device__ void trunk_s8(const Net& p, bf16* act, const bf16* enc, bf16* wbuf, float* stage,
                         const QTile& q) {
  signed char* ring = reinterpret_cast<signed char*>(wbuf);
  const signed char* wt = static_cast<const signed char*>(p.wt);
  IAcc acc[2][4];
  float y[2][4][8];
  auto clear = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int t = 0; t < 8; ++t) y[i][j][t] = 0.f;
  };
  quantize_enc(q, enc, p.enc_scale);
  __syncthreads();
  clear();
  gemm_s8(acc, q.encq, LDEQ, KPOS, static_cast<const signed char*>(p.w0), ring);
  scale_add(acc, y, nullptr, p.w0_s, stage);
  finish_s8(y, act, p.b0);
  __syncthreads();
  for (int i = 1; i < 8; ++i) {
    quantize_act(q, act);
    __syncthreads();
    clear();
    gemm_s8(acc, q.aq, LDQ, HID, wt + size_t(i - 1) * HID * HID, ring);
    scale_add(acc, y, q.ax, p.wt_s + (i - 1) * HID, stage);
    if (i == p.skip_pos) {
      gemm_s8(acc, q.encq, LDEQ, KPOS, static_cast<const signed char*>(p.wskip), ring);
      scale_add(acc, y, nullptr, p.wskip_s, stage);
    }
    finish_s8(y, act, p.bt + (i - 1) * HID);
    __syncthreads();
  }
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
// SAVE: the trunk's activations h0..h7 are also written to hs [8, M, HID]
// (not on the int8-compute route). WQ: the weight route; `q` is the
// int8-compute route's tiles.
template <bool DIR_ROWS, bool SAVE, int WQ = WQ_BF16>
__device__ void mlp_tile(const Net& p, bf16* act, const bf16* enc, bf16* wbuf, float* stage,
                         float* sig, const float* cdir, const int* slot, const bf16* denc,
                         bf16* hs, const QTile& q = QTile()) {
  const int tid = threadIdx.x;
  constexpr int HQ = head_route(WQ);
  typedef typename WeightType<WQ>::T WT;
  static_assert(!(SAVE && WQ == WQ_INT8_COMPUTE), "no saved activations on the int8 route");

  Acc acc[2][4];
  if constexpr (WQ == WQ_INT8_COMPUTE) {
    trunk_s8(p, act, enc, wbuf, stage, q);
  } else {
    // trunk: layer 0 from the encoding, layers 1..7 in place, skip adds the
    // encoding rows into the same accumulators
    zero<HID>(acc);
    product<HID, HQ>(acc, enc, LDE, KPOS, p.w0, p.w0_s, wbuf);
    epilogue<HID>(acc, act, p.b0, nullptr, nullptr, true, stage);
    __syncthreads();
    if (SAVE) save_act(hs, act);
    for (int i = 1; i < 8; ++i) {
      zero<HID>(acc);
      product<HID, HQ>(acc, act, LDA, HID, static_cast<const WT*>(p.wt) + size_t(i - 1) * HID * HID,
                       HQ == WQ_BF16 ? nullptr : p.wt_s + (i - 1) * HID, wbuf);
      if (i == p.skip_pos) product<HID, HQ>(acc, enc, LDE, KPOS, p.wskip, p.wskip_s, wbuf);
      epilogue<HID>(acc, act, p.bt + (i - 1) * HID, nullptr, nullptr, true, stage);
      __syncthreads();
      if (SAVE) save_act(hs + size_t(i) * M * HID, act);
    }
  }

  // density: 4 threads per row, 64 hidden units each
  {
    const int row = tid >> 2, q = tid & 3;
    float part = 0.f;
    for (int k = q * 64; k < q * 64 + 64; ++k)
      part = fmaf(__bfloat162float(act[row * LDA + k]), weight_at<HQ>(p.wsig, p.wsig_s, k, 0), part);
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
    product<HID, HQ>(acc, act, LDA, HID, p.wbn, p.wbn_s, wbuf);
    epilogue<HID>(acc, act, p.bbn, nullptr, nullptr, false, stage);
    __syncthreads();
  }
  zero<CH>(acc);
  product<CH, HQ>(acc, act, LDA, HID, p.wc0, p.wc0_s, wbuf);
  if (DIR_ROWS) product<CH, HQ>(acc, denc, LDD, KDIR, p.wdir, p.wdir_s, wbuf);
  epilogue<CH>(acc, act, p.bc0, DIR_ROWS ? nullptr : cdir, slot, true, stage);
  __syncthreads();

  // rgb = sigmoid(c @ wc1 + bc1) into stage[row * 4 + 1 .. 3]
  for (int e = tid; e < M * 3; e += THREADS) {
    const int row = e / 3, ch = e % 3;
    float v = 0.f;
    for (int k = 0; k < CH; ++k)
      v = fmaf(__bfloat162float(act[row * LDA + k]), weight_at<HQ>(p.wc1, p.wc1_s, k * 3 + ch, ch), v);
    v += p.bc1[ch];
    stage[row * 4 + 1 + ch] = 1.f / (1.f + expf(-v));
  }
  __syncthreads();
}

// ---- the per-sample kernels' body (mlp_forward.cu, mlp_quant.cu) -----------

template <int WQ>
__host__ __device__ constexpr size_t sample_smem_bytes() {
  return ACT_BYTES + ENC_BYTES + DENC_BYTES + WBUF_BYTES + STAGE_BYTES + qtile_bytes(WQ) +
         M * sizeof(float) + 2 * M * 3 * sizeof(float);
}

// out[n0 + row] = (sigma, r, g, b) of positions pos[n0 + row] and directions
// dirs[n0 + row] for the block's 128 rows: position and direction are read
// per row, the direction is normalized (where the model asks) and encoded in
// fp32, rounded to bf16 [128 x 32], and `denc @ wdir` is one more
// tensor-core product accumulated into the color layer's accumulators. Rows
// past n are encoded as zeros and not written.
template <int WQ>
__device__ void sample_body(const Net& net, const float* __restrict__ pos,
                            const float* __restrict__ dirs, float* __restrict__ out,
                            long long n, unsigned char* smem) {
  bf16* act = reinterpret_cast<bf16*>(smem);
  bf16* enc = reinterpret_cast<bf16*>(smem + ACT_BYTES);
  bf16* denc = reinterpret_cast<bf16*>(smem + ACT_BYTES + ENC_BYTES);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + ACT_BYTES + ENC_BYTES + DENC_BYTES);
  unsigned char* rest = smem + ACT_BYTES + ENC_BYTES + DENC_BYTES + WBUF_BYTES;
  float* stage = reinterpret_cast<float*>(rest);
  QTile q = QTile();
  if (WQ == WQ_INT8_COMPUTE) q = carve_qtile(rest + STAGE_BYTES);
  float* sig = reinterpret_cast<float*>(rest + STAGE_BYTES + qtile_bytes(WQ));
  float* xyz = sig + M;        // [M, 3]
  float* dxyz = xyz + M * 3;   // [M, 3]

  const int tid = threadIdx.x;
  const long long n0 = (long long)blockIdx.x * M;
  const long long valid = min((long long)M, n - n0);
  if (tid < M) {
    const bool ok = tid < valid;
    float x[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
    if (ok) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        x[c] = pos[(n0 + tid) * 3 + c];
        d[c] = dirs[(n0 + tid) * 3 + c];
      }
      if (net.normalize_dirs) normalize_dir(d);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      xyz[tid * 3 + c] = x[c];
      dxyz[tid * 3 + c] = d[c];
    }
  }
  __syncthreads();
  encode_pos_tile(enc, xyz, valid, net.Lp, net.band_scale);
  encode_dir_tile(denc, dxyz, valid, net.Ld, net.band_scale);
  __syncthreads();
  mlp_tile<true, false, WQ>(net, act, enc, wbuf, stage, sig, nullptr, nullptr, denc, nullptr, q);
  if (tid < valid) {
    const float* res = stage + tid * 4;
    reinterpret_cast<float4*>(out)[n0 + tid] = make_float4(sig[tid], res[1], res[2], res[3]);
  }
}

}  // namespace
