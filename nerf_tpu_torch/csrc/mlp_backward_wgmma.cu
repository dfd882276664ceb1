// The training backward K5 redesigned for Hopper: from positions, directions
// [N, 3] and the cotangents dsigma [N], drgb [N, 3], the gradient of every
// weight and bias of the reference variant, in pack_params' layout, by two
// kernels on warpgroup wgmma.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of nerf_tpu/ops/train_kernel.py
// (`_packed_grads`, the VJP of `fused_train_apply`). Wrapper, plain versions
// (bwd_rows_plain, wgrad_split_plain) and the pass and split rules:
// nerf_tpu_torch/ops/train_kernel.py; the weight stream:
// nerf_tpu_torch/ops/ray_wgmma.py (bwd_chunk_schedule, bwd_stream).
//
// What bounds it: tensor-core operations (per sample ~0.53 M multiply-adds of
// forward recompute, as many for the weight gradients and ~0.49 M for the
// input gradients), against 40 bytes read a sample and 2.1 MB of gradients
// written once. What the design does about the costs of a backward in one
// pass that keeps a copy of every gradient per block:
// 1. No per-tile read-modify-write of per-block gradient copies (2 x 2.4 MB
//    per 128 rows, 14.7 GB at 393,216 samples). The row pass K5a
//    writes the quantities the weight gradients contract over (bf16: the
//    encodings, h0..h7, every rounded cotangent) once to a scratch, and the
//    weight-gradient pass K5b reads them back once per output tile: ~9 KB a
//    sample each way, in passes of at most 65,536 rows (the wrapper), so the
//    scratch stays ~0.59 GB whatever N is. That write (4.7 GB a train step)
//    leaves by asynchronous bulk copies, not by the consumers' stores: a
//    consumer writes each quantity's bf16 pairs into a slot in shared memory
//    in the bytes of the image (pieces of STAGE_FEATS rows of 128 bytes,
//    already swizzled), one A fragment between each two products of the next
//    layer, which reads the quantity; a storer thread of the producer
//    warpgroup sends each filled slot on by cp.async.bulk and frees it once
//    the copy has read it (wait_group.read). The copies ask L2 to evict the
//    scratch first: K5b reads it only after the pass, and under L2's default
//    policy it pushed out the weight stream that every tile reads again.
// 2. Every product runs on wgmma. K5a is the ray kernels' body
//    (wgmma_common.cuh): one block per SM walking 128-row tiles, a producer
//    warpgroup streaming the network chunk by chunk by cp.async.bulk into an
//    mbarrier ring, two consumer warpgroups of 64 rows whose layer outputs
//    stay in registers as the next product's A fragments (RS form). The
//    input gradients dy @ W^T are the same RS products: the host streams
//    pre-transposed images of wc0 and wt[6..0] after the forward chunks, in
//    the same 128-byte-swizzled K-major layout, so no new descriptor form is
//    needed. The ReLU masks of h0..h7 are kept as bits in shared memory
//    (16 KB a consumer), so the mask epilogue reads nothing back. K5b is a
//    tall-skinny wgmma product dW = X^T @ dY over the sample axis: K5a stores
//    each scratch quantity feature-major, 64 samples to a 128-byte row in
//    the 128-byte swizzle (the chosen route: the image K5b's K-major
//    descriptors read as they are, for A = X^T and B = dY alike), so a
//    producer warp lands each 64-sample slab of A and B by bulk copies.
// 3. No float atomics and nothing zero-filled: each K5b block owns one
//    64- or 128-row tile of one or two matrices (consumers that share dY)
//    and one fixed range of sample blocks (split-K), and writes, not adds,
//    its fp32 partial into its own slot [pass x split]; bias gradients are
//    column sums of the same dY tiles, in a fixed order. The wrapper sums
//    the slots in one fixed-order reduction, so two runs agree bit for bit.
//
// Roundings (the module docstring of ops/train_kernel.py): every cotangent
// that enters a product (dz1, dc_pre, dsigma_pre, dpre_i) is rounded to bf16
// first, bias gradients sum those rounded values in fp32, ReLU masks read the
// bf16 activations. The forward recompute is K4's arithmetic: bf16 products,
// fp32 accumulation, the fp32 bias added before the rounding, the direction
// term as a product of the per-sample bf16 encoding with wdir. Rows past N
// get zero cotangents and add nothing.

#include "wgmma_common.cuh"

namespace {

constexpr int BW_THREADS = 384;           // producer + two consumer warpgroups
constexpr int BW_ROWS = 64;               // rows per consumer: one sample block
constexpr int BW_TILE = 2 * BW_ROWS;      // rows per tile of K5a
constexpr int CHUNK_BIG = 32768;          // a 64-row slab of 256 columns, bf16
constexpr int CHUNK_SMALL = 16384;        // a 64-row slab of 128 columns (wc0, wdir)
constexpr int ENC_TILE = BW_ROWS * KPOS * 2;   // 8 KB: a consumer's swizzled encoding
// the stream (ops/ray_wgmma.bwd_chunk_schedule): w0, 28 trunk slabs, wskip;
// wc0 (4 slabs) and wdir (one slab, rows padded to 64); wc0^T (2 slabs) and
// wt[6]^T .. wt[0]^T (4 slabs each)
constexpr int N_FWD_BIG = 1 + 28 + 1, N_SMALL = 5, N_CHUNKS = N_FWD_BIG + N_SMALL + 2 + 28;
__host__ __device__ constexpr uint32_t chunk_bytes(int j) {
  return j >= N_FWD_BIG && j < N_FWD_BIG + N_SMALL ? CHUNK_SMALL : CHUNK_BIG;
}

// The scratch of one 64-sample block: SCR_FEATS image rows of 128 bytes, one
// feature each (its 64 samples, 16-byte pieces of 8 at position piece ^
// (feature % 8)); the quantities' first rows (ops/train_kernel.SCRATCH)
constexpr int SCR_ENC = 0, SCR_DENC = SCR_ENC + KPOS, SCR_H = SCR_DENC + 64,
              SCR_DPRE = SCR_H + 8 * HID, SCR_DC = SCR_DPRE + 8 * HID, SCR_C = SCR_DC + CH,
              SCR_DY8 = SCR_C + CH, SCR_FEATS = SCR_DY8 + 8;
constexpr long long SCR_BLOCK_BYTES = (long long)SCR_FEATS * 128;

// resident parameters of K5a, in floats
constexpr int P_B0 = 0, P_BT = P_B0 + HID, P_BC0 = P_BT + 7 * HID, P_WSIG = P_BC0 + CH,
              P_WC1 = P_WSIG + HID, P_BSIG = P_WC1 + CH * 3, P_BC1 = P_BSIG + 1,
              P_FLOATS = (P_BC1 + 3 + 7) / 8 * 8;

// K5a's stores of the scratch (ops/train_kernel.STAGE_FEATS, STAGE_DEPTH): a
// consumer writes each quantity into shared memory a piece of at most
// STAGE_FEATS image rows at a time, in the bytes of the image, and its
// storer thread sends the piece on by one bulk copy; STAGE_DEPTH slots a
// consumer, filled in turn
constexpr int STAGE_FEATS = 128;
constexpr int STAGE_DEPTH = 2;
constexpr int STAGE_PIECE = STAGE_FEATS * 128;
constexpr int PIECE_FRAGS = STAGE_FEATS / 16;   // A fragments (k-steps) a piece
static_assert(STAGE_FEATS % 64 == 0 && HID % STAGE_FEATS == 0 && STAGE_DEPTH >= 1,
              "whole 64-row quantities a piece, whole pieces a hidden layer");

// K5a's shared memory (bytes from a 1024-aligned base): encodings, direction
// encodings, resident parameters, the ReLU mask bits of h0..h7 ([consumer,
// layer, word, thread]), the ring's barriers, the staging's ([consumer,
// full / empty, slot]), the staging slots ([consumer, slot]), then the ring
// of 32 KB stages
constexpr int SMEM_MAX = 232448;
constexpr int STAGES_MAX = 6;
constexpr int OFF_ENC = 0;
constexpr int OFF_DENC = OFF_ENC + 2 * ENC_TILE;
constexpr int OFF_PAR = OFF_DENC + 2 * ENC_TILE;
constexpr int OFF_MASK = OFF_PAR + P_FLOATS * 4;
constexpr int MASK_WORDS = 8 * 4 * 128;   // a consumer's: 8 layers x 128 bits x 128 threads
constexpr int OFF_BAR = OFF_MASK + 2 * MASK_WORDS * 4;
constexpr int OFF_SBAR = OFF_BAR + 2 * STAGES_MAX * 8;
constexpr int OFF_STAGE = (OFF_SBAR + 2 * 2 * STAGE_DEPTH * 8 + 1023) / 1024 * 1024;
constexpr int OFF_RING = OFF_STAGE + 2 * STAGE_DEPTH * STAGE_PIECE;
constexpr int ROW_STAGES = (SMEM_MAX - 1024 - OFF_RING) / CHUNK_BIG < STAGES_MAX
                           ? (SMEM_MAX - 1024 - OFF_RING) / CHUNK_BIG
                           : STAGES_MAX;
constexpr size_t ROWS_SMEM = 1024 + OFF_RING + size_t(ROW_STAGES) * CHUNK_BIG;
static_assert(OFF_PAR % 1024 == 0 && OFF_MASK % 16 == 0 && OFF_BAR % 8 == 0 &&
              OFF_RING % 1024 == 0 && ROW_STAGES >= 2,
              "K5a's shared memory");
using Ring = RingT<CHUNK_BIG, STAGES_MAX>;

struct RowsParams {
  Net net;
  const unsigned char* wstream;   // bwd_chunk_schedule's images, in order
  const float* pos;               // [rows, 3] of this pass
  const float* dirs;
  const float* dsig;              // [rows]
  const float* drgb;              // [rows, 3]
  unsigned char* scratch;         // 2 sample blocks a tile, SCR_FEATS rows of 128 bytes each
  long long rows;
  int tiles;
};

// Sample s of a block sits at image position P = 16 (s / 16) + 2 (s % 8) +
// (s / 8) % 2: a consumer thread's two rows (s0 = 16 w + g, s0 + 8) are
// neighbours, so it stores one 4-byte pair per feature, and a warp's stores
// of features 8 m + 2 q (q = 0..3) hit 32 distinct banks. K5b's sums run over
// all samples, so their order in the image does not change a product.
__device__ __forceinline__ int sample_pos(int s) {
  return (s & 0x30) | ((s & 7) << 1) | ((s >> 3) & 1);
}
// byte offset of (feature f, image position P) in a sample block's image:
// row f, its 16-byte piece P / 8 at position (P / 8) ^ (f % 8). For f = 8 m +
// r it is 1024 m + fm_off(r, P), so a thread keeps fm_off of its own r and P
// and reaches every atom by an immediate offset.
__device__ __forceinline__ uint32_t fm_off(int f, int P) {
  return uint32_t(f) * 128 + ((((P >> 3) ^ f) & 7) << 4) + ((P & 7) << 1);
}
// stores into an image in shared memory (img: its shared address)
__device__ __forceinline__ void st_bf16(uint32_t img, int f, int P, uint32_t bits) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(img + fm_off(f, P)), "h"(uint16_t(bits))
               : "memory");
}
// features 8 m + 2 q and 8 m + 2 q + 1 of the thread's rows (atom = img +
// 1024 m; o0, o1 = fm_off(2 q (+ 1), P0)), from u0 = the pair of row s0 and
// u1 = that of row s0 + 8: one 4-byte word per feature, at position P0
__device__ __forceinline__ void st_pairs(uint32_t atom, uint32_t o0, uint32_t o1, uint32_t u0,
                                         uint32_t u1) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(atom + o0), "r"(__byte_perm(u0, u1, 0x5410))
               : "memory");
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(atom + o1), "r"(__byte_perm(u0, u1, 0x7632))
               : "memory");
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bytes from shared to global memory, in the thread's open bulk group, the
// lines written first in line to leave L2: the scratch is read back only
// after the pass, and would otherwise push out the weight stream, which
// every tile reads again
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 policy;\ncreatepolicy.fractional.L2::evict_first.b64 policy, 1.0;\n"
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, policy;\n}\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N of the thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// until every bulk group of the thread has completed its writes
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A consumer's view of its staging: acquire() waits until the next slot is
// free and returns its shared address; the threads write a piece there, and
// commit() hands it to the storer (one arrival per warp, after every lane's
// writes are fenced for the bulk copies' proxy). The full barrier of slot s
// is at bars + 8 s, its empty barrier at bars + 8 (STAGE_DEPTH + s).
struct Staging {
  uint32_t slots, bars;
  int slot;
  uint32_t phase;
  bool lane0;
  __device__ __forceinline__ uint32_t acquire() const {
    mbar_wait(bars + 8 * (STAGE_DEPTH + slot), phase ^ 1);
    return slots + slot * STAGE_PIECE;
  }
  __device__ __forceinline__ void commit() {
    fence_async_smem();
    __syncwarp();
    if (lane0) mbar_arrive(bars + 8 * slot);
    if (++slot == STAGE_DEPTH) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// the ReLU mask bits of one 8-row atom (bit e: nonzero bf16 e of u0, u1)
__device__ __forceinline__ uint32_t atom_mask(uint32_t u0, uint32_t u1) {
  return ((u0 & 0x7fffu) != 0) | (((u0 & 0x7fff0000u) != 0) << 1) |
         (((u1 & 0x7fffu) != 0) << 2) | (((u1 & 0x7fff0000u) != 0) << 3);
}

// The stores of a quantity held as A fragments f (the accumulator layout's
// bf16 pairs, epilogue_to_a), a fragment at a time: store(x) writes fragment
// x (features 16 x .. 16 x + 15, j = 2 x, 2 x + 1: features 8 j + 2 q (+ 1)
// of rows s0 and s0 + 8, at image position P0 = 16 w + 2 g; o0, o1 = fm_off(2
// q (+ 1), P0)) into a staging slot, PIECE_FRAGS to a piece (or the R the
// quantity has); the storer sends piece k to image rows STAGE_FEATS k .. of
// the quantity. With `mk`, also the ReLU mask bits (bit 4 (j % 8) + e of
// word j / 8), mk[word * 128 + t].
template <int R>
struct FragStores {
  const uint32_t (&f)[R][4];
  Staging& st;
  uint32_t o0, o1;
  uint32_t* mk;
  int t;
  uint32_t slot = 0u, m = 0u;
  __device__ __forceinline__ void store(int x) {
    if (x % PIECE_FRAGS == 0) slot = st.acquire();
    const uint32_t atom = slot + (2 * x) % (2 * PIECE_FRAGS) * 1024;
    st_pairs(atom, o0, o1, f[x][0], f[x][1]);
    st_pairs(atom + 1024, o0, o1, f[x][2], f[x][3]);
    if (mk) m |= (atom_mask(f[x][0], f[x][1]) | atom_mask(f[x][2], f[x][3]) << 4) << (8 * (x & 3));
    if (mk && (x & 3) == 3) {
      mk[(x >> 2) * 128 + t] = m;
      m = 0u;
    }
    if (x % PIECE_FRAGS == PIECE_FRAGS - 1 || x == R - 1) st.commit();
  }
};

// hidden_layer (wgmma_common.cuh) that also stores its input a: a commit
// group per k-step, and beside each product the fragment of the k-step
// before it, which no product in flight reads any more (wait<1>); the last
// fragment beside the skip chunk, or after the products.
__device__ __forceinline__ void hidden_layer_storing(float (&acc)[128], uint32_t (&a)[16][4],
                                                     Ring& ring, bool leader, bool skip,
                                                     uint64_t enc_desc, FragStores<16>& fs) {
  fence_regs(acc);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    const uint64_t b = sw128_desc(ring.acquire());
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n256(acc, a[ch * 4 + kk], b + 2 * kk, (ch | kk) != 0);
      wgmma_commit();
      if (ch * 4 + kk > 0) {
        wgmma_wait<1>();
        fs.store(ch * 4 + kk - 1);
      }
    }
    wgmma_wait<0>();
    ring.release(leader);
  }
  if (skip) {
    const uint64_t b = sw128_desc(ring.acquire());
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss_n256(acc, enc_desc + 2 * kk, b + 2 * kk, 1);
    wgmma_commit();
    fs.store(15);
    wgmma_wait<0>();
    ring.release(leader);
  } else {
    fs.store(15);
  }
  fence_regs(acc);
}

// a = bf16(mask ? acc (+ dsp[row] * wsig[col]) : 0): the cotangent of a trunk
// layer's pre-activation, as the next input-gradient product's A fragments
__device__ __forceinline__ void mask_to_a(const float (&acc)[128], uint32_t (&a)[16][4],
                                          const uint32_t* mk, int t, int q, bool head, float dsp0,
                                          float dsp1, const float* wsig) {
  uint32_t m[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) m[w] = mk[w * 128 + t];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint32_t bits = m[j >> 3] >> (4 * (j & 7));
    float v0 = acc[4 * j], v1 = acc[4 * j + 1], v2 = acc[4 * j + 2], v3 = acc[4 * j + 3];
    if (head) {
      const float2 w = *reinterpret_cast<const float2*>(wsig + 8 * j + 2 * q);
      v0 = __fadd_rn(v0, __fmul_rn(dsp0, w.x));
      v1 = __fadd_rn(v1, __fmul_rn(dsp0, w.y));
      v2 = __fadd_rn(v2, __fmul_rn(dsp1, w.x));
      v3 = __fadd_rn(v3, __fmul_rn(dsp1, w.y));
    }
    a[j >> 1][(j & 1) * 2] = pack_bf16(bits & 1 ? v0 : 0.f, bits & 2 ? v1 : 0.f);
    a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(bits & 4 ? v2 : 0.f, bits & 8 ? v3 : 0.f);
  }
}

// One consumer warpgroup of K5a (c = 0, 1): rows n0 .. n0 + 63 of every tile
// of this block, which are one sample block of the scratch.
__device__ __forceinline__ void rows_consumer(const RowsParams& p, unsigned char* sm, int c) {
  const int t = threadIdx.x - 128 * (c + 1);
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const bool leader = t == 0;
  const int bar_id = 1 + c;
  const Net& net = p.net;
  const float* par = reinterpret_cast<const float*>(sm + OFF_PAR);
  unsigned char* enc = sm + OFF_ENC + c * ENC_TILE;
  unsigned char* denc = sm + OFF_DENC + c * ENC_TILE;
  const uint64_t enc_desc = sw128_desc(smem_u32(enc)), denc_desc = sw128_desc(smem_u32(denc));
  uint32_t* mask = reinterpret_cast<uint32_t*>(sm + OFF_MASK) + c * MASK_WORDS;
  Ring ring{smem_u32(sm + OFF_RING), smem_u32(sm + OFF_BAR), ROW_STAGES, 0, 0u, 0};
  Staging st{smem_u32(sm + OFF_STAGE) + c * STAGE_DEPTH * STAGE_PIECE,
             smem_u32(sm + OFF_SBAR) + c * 16 * STAGE_DEPTH, 0, 0u, lane == 0};
  const int s0 = 16 * warp + g;   // this thread's rows: s0 and s0 + 8 of the block
  const int P0 = 16 * warp + 2 * g;   // their image positions P0, P0 + 1
  const uint32_t o0 = fm_off(2 * q, P0), o1 = fm_off(2 * q + 1, P0);
  float acc[128];
  uint32_t a[16][4];

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const long long n0 = (long long)tile * BW_TILE + c * BW_ROWS;
    named_sync(bar_id);   // the previous tile's products are done with enc and denc

    // 1. the encodings of position and direction (thread t: row t % 64, half
    //    t / 64 of the columns) into the swizzled A tiles and the scratch
    {
      const int row = t & (BW_ROWS - 1), half = t / BW_ROWS;
      const long long n = n0 + row;
      const bool valid = n < p.rows;
      float x[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
      if (valid) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          x[k] = p.pos[n * 3 + k];
          d[k] = p.dirs[n * 3 + k];
        }
        if (net.normalize_dirs) normalize_dir(d);
      }
      const int sw = row & 7, P = sample_pos(row);
      // one encoding into its swizzled A tile (columns 32 half ..) and,
      // through the staging, the scratch's 64 rows of it (the thread's rows
      // 32 half .. 32 half + 31 of them)
      auto put = [&](const uint32_t (&v)[16], unsigned char* tile) {
        unsigned char* dst = tile + (row >> 3) * 1024 + sw * 128;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ck = half * 4 + j;   // 16-byte column piece: columns 8 ck .. 8 ck + 7
          *reinterpret_cast<uint4*>(dst + ((ck ^ sw) << 4)) =
              make_uint4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
        }
        const uint32_t s = st.acquire();   // one piece of 64 rows
#pragma unroll
        for (int k = 0; k < 32; ++k) st_bf16(s, 32 * half + k, P, k & 1 ? v[k >> 1] >> 16 : v[k >> 1]);
        st.commit();
      };
      uint32_t v[16];
      if (half == 0)
        encode_half<0>(x[0], x[1], x[2], valid ? net.Lp : -1, net.band_scale, v);
      else
        encode_half<1>(x[0], x[1], x[2], valid ? net.Lp : -1, net.band_scale, v);
      put(v, enc);
      if (half == 0) {
        encode_half<0>(d[0], d[1], d[2], valid ? net.Ld : -1, net.band_scale, v);
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = 0u;   // KDIR <= 32: the rest is padding
      }
      put(v, denc);
    }
    fence_async_smem();   // the encodings are read by the tensor cores' proxy
    named_sync(bar_id);

    // 2. the trunk: layer 0 from the encoding, layers 1..7 with the skip;
    //    each h_i to the scratch and its mask bits to shared memory under the
    //    next layer's products. The accumulators are set here, so the last
    //    tile's are not kept alive through the encodings
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    fence_regs(acc);
    wgmma_fence();
    {
      const uint64_t b = sw128_desc(ring.acquire());
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_n256(acc, enc_desc + 2 * kk, b + 2 * kk, kk != 0);
      wgmma_commit();
      wgmma_wait<0>();
      ring.release(leader);
    }
    fence_regs(acc);
    epilogue_to_a(acc, a, par + P_B0, q, true);
    for (int i = 1; i < 8; ++i) {   // h_{i-1} and its mask bits stored under layer i
      FragStores<16> fs{a, st, o0, o1, mask + (i - 1) * 512, t};
      hidden_layer_storing(acc, a, ring, leader, i == net.skip_pos, enc_desc, fs);
      epilogue_to_a(acc, a, par + P_BT + (i - 1) * HID, q, true);
    }

    // 3. density from h7 (its pre-activation kept for the mask)
    float sr0 = 0.f, sr1 = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float2 w = *reinterpret_cast<const float2*>(par + P_WSIG + 8 * j + 2 * q);
      const uint32_t u0 = a[j >> 1][(j & 1) * 2], u1 = a[j >> 1][(j & 1) * 2 + 1];
      sr0 = fmaf(bf_hi(u0), w.y, fmaf(bf_lo(u0), w.x, sr0));
      sr1 = fmaf(bf_hi(u1), w.y, fmaf(bf_lo(u1), w.x, sr1));
    }
    sr0 += __shfl_xor_sync(FULL, sr0, 1);
    sr1 += __shfl_xor_sync(FULL, sr1, 1);
    sr0 += __shfl_xor_sync(FULL, sr0, 2);
    sr1 += __shfl_xor_sync(FULL, sr1, 2);
    sr0 += par[P_BSIG];
    sr1 += par[P_BSIG];

    // 4. the color layer: h7 @ wc0 (4 slabs) + denc @ wdir (one slab, K =
    //    32), into 64 accumulators of their own, so that the trunk's 128 are
    //    free until the input gradients; h7 and its mask bits are stored
    //    under them
    float cacc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) cacc[i] = 0.f;
    fence_regs(cacc);
    fence_regs(a);
    wgmma_fence();
    {
      FragStores<16> fs{a, st, o0, o1, mask + 7 * 512, t};
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        const uint64_t b = sw128_desc(ring.acquire());
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs_n128(cacc, a[ch * 4 + kk], b + 2 * kk, 1);
          wgmma_commit();
          if (ch * 4 + kk > 0) {
            wgmma_wait<1>();
            fs.store(ch * 4 + kk - 1);
          }
        }
        wgmma_wait<0>();
        ring.release(leader);
      }
      const uint64_t b = sw128_desc(ring.acquire());
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) wgmma_ss_n128(cacc, denc_desc + 2 * kk, b + 2 * kk, 1);
      wgmma_commit();
      fs.store(15);
      wgmma_wait<0>();
      ring.release(leader);
    }
    fence_regs(cacc);

    // 5. c = bf16(relu(acc + bc0)) (kept as fragments, and stored),
    //    rgb = sigmoid(c @ wc1 + bc1) summed across the quad
    float r0[3] = {0.f, 0.f, 0.f}, r1[3] = {0.f, 0.f, 0.f};
    uint32_t cf[8][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * q;
      const float2 b = *reinterpret_cast<const float2*>(par + P_BC0 + col);
      const uint32_t u0 =
          pack_bf16(fmaxf(cacc[4 * j] + b.x, 0.f), fmaxf(cacc[4 * j + 1] + b.y, 0.f));
      const uint32_t u1 =
          pack_bf16(fmaxf(cacc[4 * j + 2] + b.x, 0.f), fmaxf(cacc[4 * j + 3] + b.y, 0.f));
      cf[j >> 1][(j & 1) * 2] = u0;
      cf[j >> 1][(j & 1) * 2 + 1] = u1;
      const float* w = par + P_WC1 + col * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        r0[k] = fmaf(bf_hi(u0), w[3 + k], fmaf(bf_lo(u0), w[k], r0[k]));
        r1[k] = fmaf(bf_hi(u1), w[3 + k], fmaf(bf_lo(u1), w[k], r1[k]));
      }
    }
    {
      FragStores<8> fs{cf, st, o0, o1, nullptr, t};
#pragma unroll
      for (int x = 0; x < 8; ++x) fs.store(x);
    }

    // 6. the heads' cotangents: dz1 = bf16(drgb rgb (1 - rgb)), dsp =
    //    bf16(sigma_pre > 0 ? dsigma : 0); [dz1, dsp, 0 x 4] is dy8
    const long long n_a = n0 + s0, n_b = n_a + 8;
    float dz0[3], dz1[3];
    float dsp0 = 0.f, dsp1 = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r0[k] += __shfl_xor_sync(FULL, r0[k], 1);
      r1[k] += __shfl_xor_sync(FULL, r1[k], 1);
      r0[k] += __shfl_xor_sync(FULL, r0[k], 2);
      r1[k] += __shfl_xor_sync(FULL, r1[k], 2);
      const float g0 = 1.f / (1.f + expf(-(r0[k] + par[P_BC1 + k])));
      const float g1 = 1.f / (1.f + expf(-(r1[k] + par[P_BC1 + k])));
      const float c0 = n_a < p.rows ? p.drgb[n_a * 3 + k] : 0.f;
      const float c1 = n_b < p.rows ? p.drgb[n_b * 3 + k] : 0.f;
      dz0[k] = round_bf16(__fmul_rn(__fmul_rn(c0, g0), __fsub_rn(1.f, g0)));
      dz1[k] = round_bf16(__fmul_rn(__fmul_rn(c1, g1), __fsub_rn(1.f, g1)));
    }
    if (n_a < p.rows && sr0 > 0.f) dsp0 = round_bf16(p.dsig[n_a]);
    if (n_b < p.rows && sr1 > 0.f) dsp1 = round_bf16(p.dsig[n_b]);
    {
      // lane q holds features 2 q, 2 q + 1 of dy8
      const float v0 = q == 0 ? dz0[0] : (q == 1 ? dz0[2] : 0.f);
      const float v1 = q == 0 ? dz0[1] : (q == 1 ? dsp0 : 0.f);
      const float v2 = q == 0 ? dz1[0] : (q == 1 ? dz1[2] : 0.f);
      const float v3 = q == 0 ? dz1[1] : (q == 1 ? dsp1 : 0.f);
      st_pairs(st.acquire(), o0, o1, pack_bf16(v0, v1), pack_bf16(v2, v3));
      st.commit();
    }

    // 7. dc_pre = bf16(c > 0 ? dz1 @ wc1^T : 0), as A fragments
    uint32_t dcf[8][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * q;
      const uint32_t c0 = cf[j >> 1][(j & 1) * 2], c1 = cf[j >> 1][(j & 1) * 2 + 1];
      const float* w = par + P_WC1 + col * 3;
      float d00 = 0.f, d01 = 0.f, d10 = 0.f, d11 = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        d00 = fmaf(dz0[k], w[k], d00);
        d01 = fmaf(dz0[k], w[3 + k], d01);
        d10 = fmaf(dz1[k], w[k], d10);
        d11 = fmaf(dz1[k], w[3 + k], d11);
      }
      dcf[j >> 1][(j & 1) * 2] =
          pack_bf16(c0 & 0x7fffu ? d00 : 0.f, c0 & 0x7fff0000u ? d01 : 0.f);
      dcf[j >> 1][(j & 1) * 2 + 1] =
          pack_bf16(c1 & 0x7fffu ? d10 : 0.f, c1 & 0x7fff0000u ? d11 : 0.f);
    }

    // 8. dh7 = dc_pre @ wc0^T (two slabs of the transposed image), dc_pre
    //    stored under them, + dsp wsig in the mask epilogue: dpre7
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    fence_regs(acc);
    fence_regs(dcf);
    wgmma_fence();
    {
      FragStores<8> fs{dcf, st, o0, o1, nullptr, t};
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const uint64_t b = sw128_desc(ring.acquire());
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs_n256(acc, dcf[ch * 4 + kk], b + 2 * kk, (ch | kk) != 0);
          wgmma_commit();
          if (ch * 4 + kk > 0) {
            wgmma_wait<1>();
            fs.store(ch * 4 + kk - 1);
          }
        }
        wgmma_wait<0>();
        ring.release(leader);
      }
      fs.store(7);
    }
    fence_regs(acc);
    mask_to_a(acc, a, mask + 7 * 512, t, q, true, dsp0, dsp1, par + P_WSIG);

    // 9. dh_{i-1} = dpre_i @ wt[i-1]^T (dpre_i stored under it), then
    //    dpre_{i-1}, for i = 7..1; dpre0 stored last
    for (int i = 7; i >= 1; --i) {
      FragStores<16> fs{a, st, o0, o1, nullptr, t};
      hidden_layer_storing(acc, a, ring, leader, false, 0, fs);
      mask_to_a(acc, a, mask + (i - 1) * 512, t, q, false, 0.f, 0.f, nullptr);
    }
    {
      FragStores<16> fs{a, st, o0, o1, nullptr, t};
#pragma unroll
      for (int x = 0; x < 16; ++x) fs.store(x);
    }
  }
}

// The quantities a consumer stores, in its order (ops/train_kernel.STORE_ORDER):
// enc, denc, h0..h7, c, dy8, dc_pre, dpre7..dpre0, as (first image row, rows)
constexpr int N_STORED = 21;
__device__ __forceinline__ int2 store_span(int i) {
  if (i < 2) return make_int2(SCR_ENC + 64 * i, 64);
  if (i < 10) return make_int2(SCR_H + HID * (i - 2), HID);
  if (i == 10) return make_int2(SCR_C, CH);
  if (i == 11) return make_int2(SCR_DY8, 8);
  if (i == 12) return make_int2(SCR_DC, CH);
  return make_int2(SCR_DPRE + HID * (20 - i), HID);
}

// K5a's storer of consumer c (one thread of the producer warpgroup): sends
// each piece the consumer stages to its rows of the consumer's sample block,
// in the consumer's order, and frees a slot once its bulk copy has read it;
// STAGE_DEPTH - 1 copies in flight, the last slot the consumer's to fill. n
// counts the pieces sent (slot n % STAGE_DEPTH), so that the loop fits the
// producer warpgroup's 24 registers.
__device__ __forceinline__ void rows_storer(const RowsParams& p, unsigned char* sm, int c) {
  const uint32_t slots = smem_u32(sm + OFF_STAGE) + c * STAGE_DEPTH * STAGE_PIECE;
  const uint32_t bars = smem_u32(sm + OFF_SBAR) + c * 16 * STAGE_DEPTH;
  uint32_t n = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    unsigned char* img = p.scratch + (2ll * tile + c) * SCR_BLOCK_BYTES;
    for (int i = 0; i < N_STORED; ++i) {
      const int2 span = store_span(i);
      for (int f = 0; f < span.y; f += STAGE_FEATS, ++n) {
        const uint32_t slot = n % STAGE_DEPTH;
        mbar_wait(bars + 8 * slot, (n / STAGE_DEPTH) & 1);   // the piece is in the slot
        bulk_store(img + (span.x + f) * 128, slots + slot * STAGE_PIECE,
                   (span.y - f < STAGE_FEATS ? span.y - f : STAGE_FEATS) * 128);
        bulk_commit();
        if (n + 1 >= STAGE_DEPTH) {   // piece n + 1 - STAGE_DEPTH has been read
          bulk_wait_read<STAGE_DEPTH - 1>();
          mbar_arrive(bars + 8 * (STAGE_DEPTH + (n + 1 - STAGE_DEPTH) % STAGE_DEPTH));
        }
      }
    }
  }
  bulk_wait_all();   // the scratch is written before the kernel ends
}

// K5a's producer: one thread streams the N_CHUNKS chunks once per tile.
__device__ __forceinline__ void rows_producer(const RowsParams& p, unsigned char* sm) {
  const uint32_t ring = smem_u32(sm + OFF_RING), bars = smem_u32(sm + OFF_BAR);
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const unsigned char* src = p.wstream;
    for (int j = 0; j < N_CHUNKS; ++j) {
      const uint32_t bytes = chunk_bytes(j);
      mbar_wait(bars + 8 * (STAGES_MAX + stage), phase ^ 1);
      mbar_expect_tx(bars + 8 * stage, bytes);
      bulk_load(ring + stage * CHUNK_BIG, src, bytes, bars + 8 * stage);
      src += bytes;
      if (++stage == ROW_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

__global__ void __launch_bounds__(BW_THREADS, 1) bwd_rows_wgmma_kernel(const __grid_constant__ RowsParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const Net& net = p.net;
  const bf16* wsig = static_cast<const bf16*>(net.wsig);
  const bf16* wc1 = static_cast<const bf16*>(net.wc1);
  float* par = reinterpret_cast<float*>(sm + OFF_PAR);
  for (int i = threadIdx.x; i < P_FLOATS; i += BW_THREADS) {
    float v = 0.f;
    if (i < P_BT) v = net.b0[i - P_B0];
    else if (i < P_BC0) v = net.bt[i - P_BT];
    else if (i < P_WSIG) v = net.bc0[i - P_BC0];
    else if (i < P_WC1) v = __bfloat162float(wsig[i - P_WSIG]);
    else if (i < P_BSIG) v = __bfloat162float(wc1[i - P_WC1]);
    else if (i == P_BSIG) v = net.bsig[0];
    else if (i < P_BC1 + 3) v = net.bc1[i - P_BC1];
    par[i] = v;
  }
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_u32(sm + OFF_BAR);
    for (int s = 0; s < ROW_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(bars + 8 * (STAGES_MAX + s), 2);   // one arrival per consumer
    }
    const uint32_t sbars = smem_u32(sm + OFF_SBAR);
    for (int s = 0; s < 2 * STAGE_DEPTH; ++s) {    // [consumer, slot]
      const uint32_t b = sbars + 16 * STAGE_DEPTH * (s / STAGE_DEPTH) + 8 * (s % STAGE_DEPTH);
      mbar_init(b, 4);                             // full: one arrival per warp
      mbar_init(b + 8 * STAGE_DEPTH, 1);           // empty: the storer's
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) rows_producer(p, sm);
    else if (threadIdx.x == 32 || threadIdx.x == 64) rows_storer(p, sm, threadIdx.x / 32 - 1);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    rows_consumer(p, sm, threadIdx.x / 128 - 1);
  }
}

// ---- K5b: the weight gradients ----------------------------------------------

// A job (ops/train_kernel.wgrad_jobs): the width N of dY, its first scratch
// row, and per consumer the first scratch row of its 64 rows of X (-1: no
// consumer) and where its [64, N] tile of X^T dY goes: row r < valid, column
// col0 <= col < col0 + ncols to out + r * ld + col - col0, and the column sums
// of dY to bias + col - col0 (bias -1: none)
constexpr int JOB_INTS = 2 + 2 * 8;
enum { J_A = 0, J_OUT, J_LD, J_VALID, J_COL0, J_NCOLS, J_BIAS };

constexpr int A_TILE = 64 * 128;                 // 8 KB: 64 features x 64 samples
constexpr int WG_STAGE = 2 * A_TILE + CHUNK_BIG;   // A of both consumers, then dY
constexpr int WG_STAGES = 4;
constexpr size_t WG_SMEM = 1024 + size_t(WG_STAGES) * WG_STAGE + 2 * WG_STAGES * 8;
static_assert(WG_SMEM <= SMEM_MAX, "K5b's shared memory");
using WgRing = RingT<WG_STAGE, WG_STAGES>;

struct WgParams {
  const unsigned char* scratch;
  const int* jobs;      // [n_jobs, JOB_INTS]
  float* partials;      // [slots, G]
  long long g;          // floats of one slot
  int n_jobs, splits, slot0, blocks;   // blocks: the pass's 64-sample blocks
};

// The consumer of one job's [64, N] tile over the split's sample blocks.
template <int N>
__device__ __forceinline__ void wgrad_consumer(const WgParams& p, const int* job, const int* cj,
                                               unsigned char* sm, int c, long long b0,
                                               long long b1, float* out) {
  constexpr int NA = N / 2 < 4 ? 4 : N / 2;   // accumulators a thread
  const int t = threadIdx.x - 128 * (c + 1);
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const bool leader = t == 0;
  const bool bias = cj[J_BIAS] >= 0;
  WgRing ring{smem_u32(sm), smem_u32(sm + WG_STAGES * WG_STAGE), WG_STAGES, 0, 0u, 0};
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  float bs[2] = {0.f, 0.f};   // the column sums of features t and t + 128
  for (long long sb = b0; sb < b1; ++sb) {
    const uint32_t st = ring.acquire();
    const uint64_t da = sw128_desc(st + c * A_TILE), db = sw128_desc(st + 2 * A_TILE);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (N == 256) wgmma_ss_n256(acc, da + 2 * kk, db + 2 * kk, 1);
      else if constexpr (N == 128) wgmma_ss_n128(acc, da + 2 * kk, db + 2 * kk, 1);
      else wgmma_ss_n8(acc, da + 2 * kk, db + 2 * kk, 1);
    }
    wgmma_commit();
    if (bias) {
      const unsigned char* dy = sm + (st - smem_u32(sm)) + 2 * A_TILE;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = t + 128 * h;
        if (f < N) {
          float s = 0.f;
#pragma unroll
          for (int pc = 0; pc < 8; ++pc) {   // samples 8 pc .. 8 pc + 7, in order
            const uint4 v = *reinterpret_cast<const uint4*>(dy + f * 128 + ((pc ^ (f & 7)) << 4));
            s += ((bf_lo(v.x) + bf_hi(v.x)) + (bf_lo(v.y) + bf_hi(v.y))) +
                 ((bf_lo(v.z) + bf_hi(v.z)) + (bf_lo(v.w) + bf_hi(v.w)));
          }
          bs[h] += s;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    ring.release(leader);
  }
  // acc[4 j + e]: row 16 warp + g (+ 8 for e >= 2), column 8 j + 2 q + (e & 1)
  const int valid = cj[J_VALID], ld = cj[J_LD], col0 = cj[J_COL0], ncols = cj[J_NCOLS];
  float* o = out + cj[J_OUT];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + g + 8 * (e >> 1), col = 8 * j + 2 * q + (e & 1);
      if (r < valid && col >= col0 && col < col0 + ncols) o[r * ld + col - col0] = acc[4 * j + e];
    }
  }
  if (bias) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = t + 128 * h;
      if (f < N && f >= col0 && f < col0 + ncols) out[cj[J_BIAS] + f - col0] = bs[h];
    }
  }
}

__global__ void __launch_bounds__(BW_THREADS, 1) wgrad_wgmma_kernel(const __grid_constant__ WgParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const int j = blockIdx.x % p.n_jobs, split = blockIdx.x / p.n_jobs;
  const int* job = p.jobs + j * JOB_INTS;
  const int n = job[0], b_row = job[1];
  const int* cj[2] = {job + 2, job + 2 + 8};
  const bool two = cj[1][J_A] >= 0;
  const long long b0 = (long long)split * p.blocks / p.splits;
  const long long b1 = (long long)(split + 1) * p.blocks / p.splits;
  float* out = p.partials + (long long)(p.slot0 + split) * p.g;
  const uint32_t bars = smem_u32(sm + WG_STAGES * WG_STAGE);
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (WG_STAGES + s), two ? 2 : 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 0) return;
    // the producer: per sample block, both consumers' A slabs and the dY slab
    const uint32_t base = smem_u32(sm);
    const uint32_t bytes = A_TILE * (two ? 2 : 1) + uint32_t(n) * 128;
    int stage = 0;
    uint32_t phase = 0;
    for (long long sb = b0; sb < b1; ++sb) {
      const unsigned char* blk = p.scratch + sb * SCR_BLOCK_BYTES;
      const uint32_t st = base + stage * WG_STAGE, full = bars + 8 * stage;
      mbar_wait(bars + 8 * (WG_STAGES + stage), phase ^ 1);
      mbar_expect_tx(full, bytes);
      bulk_load(st, blk + cj[0][J_A] * 128, A_TILE, full);
      if (two) bulk_load(st + A_TILE, blk + cj[1][J_A] * 128, A_TILE, full);
      bulk_load(st + 2 * A_TILE, blk + b_row * 128, uint32_t(n) * 128, full);
      if (++stage == WG_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = threadIdx.x / 128 - 1;
    if (cj[c][J_A] < 0) return;
    if (n == 256) wgrad_consumer<256>(p, job, cj[c], sm, c, b0, b1, out);
    else if (n == 128) wgrad_consumer<128>(p, job, cj[c], sm, c, b0, b1, out);
    else wgrad_consumer<8>(p, job, cj[c], sm, c, b0, b1, out);
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// The layout both kernels share with ops/train_kernel.py.
int bwd_scratch_features() { return SCR_FEATS; }
int bwd_stream_chunks() { return N_CHUNKS; }
long long bwd_rows_smem_bytes() { return (long long)ROWS_SMEM; }
int bwd_rows_stages() { return ROW_STAGES; }
// K5a's staging of the scratch: the bytes of a piece (i = 0), slots a
// consumer (i = 1)
int bwd_rows_staging(int i) { return i == 0 ? STAGE_PIECE : STAGE_DEPTH; }
long long wgrad_smem_bytes() { return (long long)WG_SMEM; }
int wgrad_job_ints() { return JOB_INTS; }

// K5a on one pass of `rows` rows (the inputs at the pass's first row):
// scratch holds 2 ceil(rows / 128) sample blocks of bwd_scratch_features()
// 128-byte rows; one block per SM, at most one per tile.
int bwd_rows_wgmma(const float* pos, const float* dirs, const float* dsig, const float* drgb,
                   long long rows, const void* wstream, const void* const* weights, int Lp, int Ld,
                   int skip_pos, int bmild, int relu_sigma, int normalize_dirs, float band_scale,
                   void* scratch, void* stream) {
  RowsParams p;
  p.net = make_net(weights, nullptr, Lp, Ld, skip_pos, bmild, relu_sigma, normalize_dirs,
                   band_scale);
  p.wstream = static_cast<const unsigned char*>(wstream);
  p.pos = pos;
  p.dirs = dirs;
  p.dsig = dsig;
  p.drgb = drgb;
  p.scratch = static_cast<unsigned char*>(scratch);
  p.rows = rows;
  const long long tiles = (rows + BW_TILE - 1) / BW_TILE;
  p.tiles = int(tiles);
  if (rows < 1 || tiles > 0x7fffffff || !wstream || !scratch || !net_fits(p.net) ||
      skip_pos < 1 || skip_pos > 7 || bmild || !relu_sigma)   // reference only
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(bwd_rows_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(ROWS_SMEM));
  if (err != cudaSuccess) return int(err);
  const int grid = tiles < sm_count() ? int(tiles) : sm_count();
  bwd_rows_wgmma_kernel<<<grid, BW_THREADS, ROWS_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

// K5b on the scratch of one pass of `rows` rows: n_jobs x splits blocks,
// split s over the sample blocks [s B / splits, (s + 1) B / splits), B =
// ceil(rows / 64), each writing its partials into slot slot0 + s of
// partials [slots, g].
int wgrad_wgmma(const void* scratch, long long rows, const int* jobs, int n_jobs, int splits,
                float* partials, int slot0, long long g, void* stream) {
  WgParams p;
  p.scratch = static_cast<const unsigned char*>(scratch);
  p.jobs = jobs;
  p.partials = partials;
  p.g = g;
  p.n_jobs = n_jobs;
  p.splits = splits;
  p.slot0 = slot0;
  const long long blocks = (rows + BW_ROWS - 1) / BW_ROWS;
  p.blocks = int(blocks);
  if (rows < 1 || blocks > 0x7fffffff || n_jobs < 1 || splits < 1 || splits > blocks ||
      slot0 < 0 || !scratch || !jobs || !partials)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(wgrad_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(WG_SMEM));
  if (err != cudaSuccess) return int(err);
  wgrad_wgmma_kernel<<<n_jobs * splits, BW_THREADS, WG_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

}  // extern "C"
