// Fused NeRF MLP backward: from positions, directions [N, 3] and the
// cotangents dsigma [N], drgb [N, 3], the gradient of every weight and bias
// (reference variant), in pack_params' layout.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of nerf_tpu/ops/train_kernel.py
// (`_packed_grads`, the VJP of `fused_train_apply`). Plain PyTorch twin and
// wrapper: nerf_tpu_torch/ops/train_kernel.py.
//
// What bounds it: tensor-core operations. Per sample the forward recompute
// is ~0.53 M multiply-adds and the backward twice that (one product for the
// weight gradient, one for the input gradient, per layer), against 40 bytes
// read per sample and 2.4 MB of gradients written once.
//
// Per 128-row tile: recompute the forward (mlp_body.cuh, the forward
// kernel's arithmetic) keeping h0..h7, then walk back through sigmoid,
// color1, the color layer's ReLU, color0 with the direction rows, the
// density head (ReLU mask on sigma) and the eight trunk layers with the
// skip. Roundings follow the TPU kernel: every cotangent that enters a
// product (dz1, dc_pre, dsigma_pre, dpre_i) is rounded to bf16 first, bias
// gradients sum those rounded values in fp32, ReLU masks read the bf16
// activations (the color layer's and the density's masks read the bf16
// activation and the ReLU'd density, which are positive exactly where the
// fp32 pre-activations are, down to bf16's smallest subnormal).
//
// What the TPU design rested on does not carry over, and what replaces it:
// - Activations. h0..h7 of a tile are 8 x [128 x 256] bf16 = 512 KB, more
//   than the 227 KB of shared memory a block has. Chosen here: keep the
//   128-row tile (the forward body and its warp layout are reused as they
//   are) and give each block a 512 KB scratch in global memory, written once
//   in the forward and read in the backward (ReLU mask, weight gradient); 132
//   blocks' scratch is 68 MB, most of which L2 (50 MB) serves. A 32-row tile
//   would fit in shared memory but streams all weights four times as often
//   and needs another warp layout.
// - Weight gradients. 0.6 M parameters in fp32 are 2.4 MB, so no block holds
//   its own copy in shared memory. The grid is persistent (at most one block
//   per SM); each block owns one fp32 copy of all gradients in global memory
//   and accumulates tile after tile: the warp that owns a fragment loads it
//   as the WMMA accumulator, adds x^T @ dy over the tile's 128 rows and stores
//   it back. No atomics; tiles are assigned to blocks statically, so the
//   summation order is fixed and two runs agree bit for bit. The caller sums
//   the copies over blocks.
// - Products. The weight gradient x^T @ dy contracts the sample axis: x
//   [128 x in] row-major is loaded as a col_major matrix_a fragment (from
//   shared memory for the encodings, from the scratch for h_i), no transposed
//   copy. The input gradient dy @ W^T reads the row-major weight through a
//   col_major matrix_b fragment: W streams by cp.async as [256 x 32] column
//   slabs instead of shipping transposed copies.
// Rows past N have zero cotangents and contribute nothing.

#include "mlp_body.cuh"

namespace {

constexpr int LDT = KC + 8;     // row stride of a staged [256 x 32] weight slab
constexpr size_t WBUF_T_BYTES = size_t(STAGES) * HID * LDT * sizeof(bf16);
static_assert(WBUF_T_BYTES >= WBUF_BYTES, "the ring serves both product forms");
constexpr size_t SMEM_BYTES = ACT_BYTES + ENC_BYTES + DENC_BYTES + WBUF_T_BYTES + STAGE_BYTES +
                              M * sizeof(float) * (1 + 3 + 3 + 1 + 3 + 1 + 4);
constexpr size_t HS_ELEMS = size_t(8) * M * HID;   // scratch per block

// One block's gradient copies; the caller's arrays are [blocks, ...].
struct Grads {
  float* w0;     // [KPOS, HID]
  float* b0;     // [HID]
  float* wt;     // [7, HID, HID]
  float* bt;     // [7, HID]
  float* wskip;  // [KPOS, HID]
  float* wsig;   // [HID]
  float* bsig;   // [1]
  float* wc0;    // [HID, CH]
  float* bc0;    // [CH]
  float* wdir;   // [KDIR, CH]
  float* wc1;    // [CH, 3]
  float* bc1;    // [3]
};

struct Params {
  Net net;
  const float* pos;    // [N, 3]
  const float* dirs;   // [N, 3]
  const float* dsig;   // [N]
  const float* drgb;   // [N, 3]
  long long n;
  bf16* hs;            // [blocks, 8, M, HID]
  Grads g;             // block 0's copies
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc[i][j] += A[rows of this warp, 0:K] @ W^T[0:K, cols of this warp] for
// W [HID, K] row-major in global memory (row stride ldw): W^T is read as a
// col_major matrix_b. W streams KC columns at a time, each chunk a
// [HID x KC] slab in the ring. Ends with __syncthreads().
__device__ void gemm_acc_t(Acc (&acc)[2][4], const bf16* A, int lda, int K,
                           const bf16* __restrict__ W, int ldw, bf16* wbuf) {
  constexpr int VPR = KC / 8;       // 16-byte vectors per slab row
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  const int steps = K / KC;

  auto fetch = [&](int step) {
    if (step < steps) {
      bf16* dst = wbuf + (step % STAGES) * HID * LDT;
      const bf16* src = W + step * KC;
      for (int v = tid; v < HID * VPR; v += THREADS) {
        int r = v / VPR, c = (v % VPR) * 8;
        cp_async16(dst + r * LDT + c, src + size_t(r) * ldw + c);
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < STAGES - 1; ++s) fetch(s);
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    fetch(step + STAGES - 1);
    const bf16* wb = wbuf + (step % STAGES) * HID * LDT;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], A + (wr * 32 + i * 16) * lda + step * KC + kk, lda);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, wb + (wc * 64 + j * 16) * LDT + kk, LDT);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
  }
  __syncthreads();
}

// act[row, col] = bf16(h[row, col] > 0 ? acc (+ dsp[row] * wsig[col]) : 0):
// the cotangent of a trunk layer's pre-activation. h: that layer's bf16
// activations [M, HID] in the scratch.
__device__ void epilogue_mask(Acc (&acc)[2][4], bf16* act, const bf16* __restrict__ h,
                              const float* dsp, const bf16* __restrict__ wsig, float* stage) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  float* st = stage + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = wr * 32 + i * 16, c0 = wc * 64 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int row = r0 + (e >> 4), col = c0 + (e & 15);
        float v = st[e];
        if (dsp) v = fmaf(dsp[row], __bfloat162float(wsig[col]), v);
        if (!(__bfloat162float(h[row * HID + col]) > 0.f)) v = 0.f;
        act[row * LDA + col] = __float2bfloat16_rn(v);
      }
      __syncwarp();
    }
  }
}

// G[0:IN, 0:OUT] += X^T @ DY over the tile's M rows. X [M, IN] bf16 (row
// stride ldx; shared memory or the scratch), DY [M, OUT] bf16 in shared
// memory (row stride ldy), G fp32 row-major in global memory. Each warp owns
// blocks of BI x BJ fragments: it loads them as accumulators, adds, stores.
template <int BI, int BJ>
__device__ void wgrad(float* __restrict__ G, const bf16* X, int ldx, int IN, const bf16* DY,
                      int ldy, int OUT) {
  const int warp = threadIdx.x >> 5;
  const int nbj = OUT / (16 * BJ);
  const int nb = (IN / (16 * BI)) * nbj;
  for (int b = warp; b < nb; b += WARPS) {
    const int i0 = (b / nbj) * BI * 16, j0 = (b % nbj) * BJ * 16;
    Acc acc[BI][BJ];
#pragma unroll
    for (int i = 0; i < BI; ++i)
#pragma unroll
      for (int j = 0; j < BJ; ++j)
        wmma::load_matrix_sync(acc[i][j], G + size_t(i0 + i * 16) * OUT + j0 + j * 16, OUT,
                               wmma::mem_row_major);
#pragma unroll 2
    for (int k = 0; k < M; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[BI];
#pragma unroll
      for (int i = 0; i < BI; ++i)
        wmma::load_matrix_sync(a[i], X + size_t(k) * ldx + i0 + i * 16, ldx);
#pragma unroll
      for (int j = 0; j < BJ; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, DY + k * ldy + j0 + j * 16, ldy);
#pragma unroll
        for (int i = 0; i < BI; ++i) wmma::mma_sync(acc[i][j], a[i], bfr, acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < BI; ++i)
#pragma unroll
      for (int j = 0; j < BJ; ++j)
        wmma::store_matrix_sync(G + size_t(i0 + i * 16) * OUT + j0 + j * 16, acc[i][j], OUT,
                                wmma::mem_row_major);
  }
}

// g[col] += sum over rows of act[row, col], for the first `cols` threads
__device__ __forceinline__ void bias_grad(float* __restrict__ g, const bf16* act, int cols) {
  const int col = threadIdx.x;
  if (col < cols) {
    float s = 0.f;
    for (int row = 0; row < M; ++row) s += __bfloat162float(act[row * LDA + col]);
    g[col] += s;
  }
}

__global__ void __launch_bounds__(THREADS, 1) mlp_backward_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);
  bf16* enc = reinterpret_cast<bf16*>(smem + ACT_BYTES);
  bf16* denc = reinterpret_cast<bf16*>(smem + ACT_BYTES + ENC_BYTES);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + ACT_BYTES + ENC_BYTES + DENC_BYTES);
  float* stage =
      reinterpret_cast<float*>(smem + ACT_BYTES + ENC_BYTES + DENC_BYTES + WBUF_T_BYTES);
  float* sig = stage + WARPS * 256;   // [M] relu(sigma)
  float* xyz = sig + M;               // [M, 3]
  float* dxyz = xyz + M * 3;          // [M, 3]
  float* dsig = dxyz + M * 3;         // [M] cotangent of sigma
  float* drgb = dsig + M;             // [M, 3] cotangent of rgb
  float* dsp = drgb + M * 3;          // [M] bf16-rounded cotangent of the density head
  float* dz1 = dsp + M;               // [M, 4] bf16-rounded cotangent of color1's output

  const int tid = threadIdx.x;
  const Net& net = p.net;
  const bf16* wt = static_cast<const bf16*>(net.wt);    // this kernel takes bf16 weights only
  const bf16* wc1 = static_cast<const bf16*>(net.wc1);
  const size_t blk = blockIdx.x;
  bf16* hs = p.hs + blk * HS_ELEMS;
  Grads g;
  g.w0 = p.g.w0 + blk * (KPOS * HID);
  g.b0 = p.g.b0 + blk * HID;
  g.wt = p.g.wt + blk * (7 * HID * HID);
  g.bt = p.g.bt + blk * (7 * HID);
  g.wskip = p.g.wskip + blk * (KPOS * HID);
  g.wsig = p.g.wsig + blk * HID;
  g.bsig = p.g.bsig + blk;
  g.wc0 = p.g.wc0 + blk * (HID * CH);
  g.bc0 = p.g.bc0 + blk * CH;
  g.wdir = p.g.wdir + blk * (KDIR * CH);
  g.wc1 = p.g.wc1 + blk * (CH * 3);
  g.bc1 = p.g.bc1 + blk * 3;
  const bf16* h7 = hs + size_t(7) * M * HID;

  const long long n_tiles = (p.n + M - 1) / M;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long n0 = tile * M;
    const long long valid = min((long long)M, p.n - n0);

    // -- inputs and the forward recompute, h0..h7 to the scratch -------------
    if (tid < M) {
      const bool ok = tid < valid;
      float x[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f}, dc[3] = {0.f, 0.f, 0.f};
      float ds = 0.f;
      if (ok) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          x[c] = p.pos[(n0 + tid) * 3 + c];
          d[c] = p.dirs[(n0 + tid) * 3 + c];
          dc[c] = p.drgb[(n0 + tid) * 3 + c];
        }
        ds = p.dsig[n0 + tid];
        if (net.normalize_dirs) normalize_dir(d);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        xyz[tid * 3 + c] = x[c];
        dxyz[tid * 3 + c] = d[c];
        drgb[tid * 3 + c] = dc[c];
      }
      dsig[tid] = ds;
    }
    __syncthreads();
    encode_pos_tile(enc, xyz, valid, net.Lp, net.band_scale);
    encode_dir_tile(denc, dxyz, valid, net.Ld, net.band_scale);
    __syncthreads();
    mlp_tile<true, true>(net, act, enc, wbuf, stage, sig, nullptr, nullptr, denc, hs);
    // act[:, 0:CH] = c (bf16), sig = relu(sigma), stage[row * 4 + 1..3] = rgb

    // -- sigmoid and the density head's ReLU ---------------------------------
    if (tid < M * 3) {
      const int row = tid / 3, ch = tid % 3;
      const float rgb = stage[row * 4 + 1 + ch];
      dz1[row * 4 + ch] = round_bf16(drgb[tid] * rgb * (1.f - rgb));
    }
    if (tid < M) dsp[tid] = round_bf16(sig[tid] > 0.f ? dsig[tid] : 0.f);
    __syncthreads();

    // -- color1: d_wc1 = c^T @ dz1, d_bc1, then dc_pre over c in place --------
    if (tid < CH * 3) {
      const int k = tid / 3, ch = tid % 3;
      float s = 0.f;
      for (int row = 0; row < M; ++row)
        s = fmaf(__bfloat162float(act[row * LDA + k]), dz1[row * 4 + ch], s);
      g.wc1[tid] += s;
    } else if (tid < CH * 3 + 3) {
      const int ch = tid - CH * 3;
      float s = 0.f;
      for (int row = 0; row < M; ++row) s += dz1[row * 4 + ch];
      g.bc1[ch] += s;
    }
    __syncthreads();
    for (int e = tid; e < M * CH; e += THREADS) {
      const int row = e / CH, k = e % CH;
      float v = 0.f;
      if (__bfloat162float(act[row * LDA + k]) > 0.f) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          v = fmaf(dz1[row * 4 + ch], __bfloat162float(wc1[k * 3 + ch]), v);
      }
      act[row * LDA + k] = __float2bfloat16_rn(v);
    }
    __syncthreads();

    // -- color0 and the density head: weight gradients, then dh7 -------------
    wgrad<1, 1>(g.wdir, denc, LDD, KDIR, act, LDA, CH);
    wgrad<2, 4>(g.wc0, h7, HID, HID, act, LDA, CH);
    bias_grad(g.bc0, act, CH);
    if (tid >= CH && tid < CH + HID) {
      const int k = tid - CH;
      float s = 0.f;
      for (int row = 0; row < M; ++row)
        s = fmaf(__bfloat162float(h7[row * HID + k]), dsp[row], s);
      g.wsig[k] += s;
    } else if (tid == CH + HID) {
      float s = 0.f;
      for (int row = 0; row < M; ++row) s += dsp[row];
      g.bsig[0] += s;
    }
    Acc acc[2][4];
    zero<HID>(acc);
    gemm_acc_t(acc, act, LDA, CH, static_cast<const bf16*>(net.wc0), CH, wbuf);
    epilogue_mask(acc, act, h7, dsp, static_cast<const bf16*>(net.wsig), stage);
    __syncthreads();

    // -- trunk layers 7..1, then layer 0 -------------------------------------
    for (int i = 7; i >= 1; --i) {
      const bf16* h_in = hs + size_t(i - 1) * M * HID;
      wgrad<2, 4>(g.wt + size_t(i - 1) * HID * HID, h_in, HID, HID, act, LDA, HID);
      bias_grad(g.bt + (i - 1) * HID, act, HID);
      if (i == net.skip_pos) wgrad<1, 4>(g.wskip, enc, LDE, KPOS, act, LDA, HID);
      zero<HID>(acc);
      gemm_acc_t(acc, act, LDA, HID, wt + size_t(i - 1) * HID * HID, HID, wbuf);
      epilogue_mask(acc, act, h_in, nullptr, nullptr, stage);
      __syncthreads();
    }
    wgrad<1, 4>(g.w0, enc, LDE, KPOS, act, LDA, HID);
    bias_grad(g.b0, act, HID);
    __syncthreads();   // the tile's buffers are free for the next tile
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Elements of bf16 scratch each block needs (the caller allocates blocks x this).
long long mlp_backward_scratch_elems() { return (long long)HS_ELEMS; }

// Dynamic shared memory of the kernel, in bytes.
long long mlp_backward_smem_bytes() { return (long long)SMEM_BYTES; }

// grads: 12 pointers in the order of `Grads`, each [blocks, ...] and zeroed
// by the caller; hs: [blocks, 8, 128, 256] bf16.
int mlp_backward(const float* pos, const float* dirs, const float* dsig, const float* drgb,
                 long long n, const void* const* weights, int Lp, int Ld, int skip_pos,
                 int bmild, int relu_sigma, int normalize_dirs, float band_scale, void* hs,
                 float* const* grads, int blocks, void* stream) {
  Params p;
  p.net = make_net(weights, nullptr, Lp, Ld, skip_pos, bmild, relu_sigma, normalize_dirs,
                   band_scale);
  p.pos = pos;
  p.dirs = dirs;
  p.dsig = dsig;
  p.drgb = drgb;
  p.n = n;
  p.hs = static_cast<bf16*>(hs);
  p.g.w0 = grads[0];
  p.g.b0 = grads[1];
  p.g.wt = grads[2];
  p.g.bt = grads[3];
  p.g.wskip = grads[4];
  p.g.wsig = grads[5];
  p.g.bsig = grads[6];
  p.g.wc0 = grads[7];
  p.g.bc0 = grads[8];
  p.g.wdir = grads[9];
  p.g.wc1 = grads[10];
  p.g.bc1 = grads[11];
  if (n < 1 || blocks < 1 || !net_fits(p.net) || skip_pos < 1 || skip_pos > 7 || bmild ||
      !relu_sigma)   // the reference variant only
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  mlp_backward_kernel<<<unsigned(blocks), THREADS, SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

}  // extern "C"
