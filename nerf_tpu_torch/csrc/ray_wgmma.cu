// The ray kernels K1 and K3 in their raw output forms and their composited
// modes, and the per-sample forward K4 (K7 on quantized weights), on every
// weight route, redesigned for Hopper: warpgroup wgmma, a producer warpgroup
// that streams the weights by bulk copy into a ring of mbarrier-guarded
// stages, persistent blocks.
//
// Replaces the Pallas TPU kernels
// - ray_wgmma_kernel: `_ray_kernel` (uniform depths, K1) and
// - ray_z_wgmma_kernel: `_ray_z_kernel` (per-ray depths z [R, S], K3) of
//   nerf_tpu/ops/render_kernel.py, in the raw output forms (fp32 or bf16
//   interleaved (sigma, r, g, b) per sample, or four fp32 planes [R, S]), on
//   the weights `_weights_for` hands them;
// - ray_composite_wgmma_kernel, ray_z_composite_wgmma_kernel: their
//   `composited=True` modes (`_composite_flat` + `_segmented_cumsum_excl`),
//   which write per ray (r, g, b, depth, acc, 0, 0, 0) and optionally the
//   weights [R, S];
// - mlp_wgmma_kernel: `_nerf_kernel` of nerf_tpu/ops/mlp_kernel.py (K4:
//   positions and directions [N, 3] -> (sigma, r, g, b) [N, 4] fp32) and, on
//   the quantized routes, `_quant_kernel` of nerf_tpu/ops/quant.py (K7);
// all through `_nerf_math` (nerf_tpu/ops/mlp_kernel.py). This source is
// built once per weight route (-DNERF_WQ, the routes of mlp_body.cuh):
// - 0, bf16 weights;
// - 1 and 2, int8 and int16 weights dequantized in the kernel (`quant_w_dict`,
//   nerf_tpu/ops/quant.py): bf16(f32(q) * s[col]), bf16 products;
// - 3, int8 compute (`int8_w_dict` + `_int8_mm`): layer 0, the trunk and the
//   skip product as s8 x s8 -> s32, the rest on route 1.
// Wrappers and the dispatch rules: nerf_tpu_torch/ops/render_kernel.py (K1,
// K3), ops/mlp_kernel.py (K4), ops/quant.py (K7); the weight streams' layout,
// chunk schedules and the composited modes' schedule:
// nerf_tpu_torch/ops/ray_wgmma.py.
//
// What bounds it: tensor-core operations (~0.52 M multiply-adds a sample
// against 24 bytes in, 16 or 8 out). Next, the weight stream from L2: every
// 128-row tile reads the network's matrices (1 MiB in bf16, 128 FLOP a
// byte), so at the bf16 peak the SMs together would read ~7.7 TB/s from L2;
// l2_stream_probe measures what the ring can draw. Then the per-tile
// encoding (sinf/cosf at full range reduction) and the epilogues, which run
// on the CUDA cores between products.
//
// Design, and what each part does about those bounds:
// - one block per SM (grid = SMs), walking 128-row tiles (flat row n = ray *
//   S + s) in a grid-stride loop; three warpgroups of 128 threads;
// - warpgroup 0 is the producer: one thread streams the network, a fixed
//   sequence of chunks per tile (w0; wt[0..6] with wskip after the layer at
//   skip_pos; wbn for bmild; wc0), by cp.async.bulk into a ring of 32 KB
//   stages (as many as fit beside the rest, 4 to 6) with full/empty
//   mbarriers. It runs ahead across layer and tile boundaries, so the L2
//   latency hides behind the products. The host repacks every 64-row slab
//   of a matrix once (ops/ray_wgmma.py) into the exact shared-memory image
//   that wgmma's B descriptor reads (K-major, 128-byte swizzle), so a chunk
//   is one contiguous copy;
// - warpgroups 1 and 2 are consumers, each owning 64 rows of the tile and the
//   full output width: m64n256k16 for the trunk and bottleneck, m64n128k16
//   for the color layer, bf16 inputs, fp32 accumulators in registers
//   (setmaxnreg gives them 240 a thread, the producer 24; 224 and 56 on the
//   dequantize routes, whose producer converts every chunk). A layer's output
//   stays in registers: the epilogue (fp32 bias, ReLU, round to bf16) packs
//   the accumulators straight into the next product's A fragments (the RS
//   form of wgmma), so no layer touches shared memory and no barrier is
//   block-wide. The encoding (the A operand of layer 0 and the skip) is
//   written once per tile into a swizzled shared tile (the SS form). Each
//   phase whose sine and cosine a thread writes is reduced once (sincosf,
//   the same values as sinf and cosf): at full range reduction the encoding
//   is the largest cost beside the products;
// - the two consumers share each weight chunk and release it by one arrival
//   each; while one runs its epilogue or encoding the other keeps the
//   tensor cores busy;
// - the heads come from registers: density and rgb as per-thread partial
//   dot products over the thread's columns, summed across the quad by
//   shuffles; the quad then writes its two rows;
// - biases, wsig and wc1 stay in shared memory for the kernel's lifetime
//   (12 KB); the ray kernels compute the direction branch once per ray of a
//   consumer's 64 rows (fp32, from the bf16 encoding, kept in shared memory).
//
// The per-sample kernel keeps that design; what it changes: each consumer
// row reads its position and direction from memory; the direction is
// normalized (where the model asks) and encoded in fp32, rounded to bf16,
// into a swizzled 64 x 64 tile of its own (K 0..31 used); the direction term
// is two m64n128k16 SS products of that tile with wdir, which the stream
// carries after wc0 (one chunk, its rows padded to 64), into the color
// layer's accumulators; each row writes one float4. Rows at or past N are
// encoded as zeros and not written.
//
// The composited modes keep the ray kernels' design; what they change is
// the schedule and the epilogue. A ray's samples are consecutive rows, and
// its carried log-transmittance must pass from one 64-row step to the next
// in order, within one consumer, without waiting on the other consumer
// (their overlap is where the body's speed comes from). So each consumer
// warpgroup is a lane of whole rays: the R rays are split into 2 x grid
// contiguous ranges of near-equal count, lane 2 b + c of block b taking
// rays L R / lanes .. (L + 1) R / lanes - 1 (ops/ray_wgmma.lane_rays), and
// walks their rows 64 at a time, in order. A block runs the larger of its
// two lanes' step counts; a lane past its rows encodes zeros and writes
// nothing, as rows past the end do in the raw forms; the producer streams
// the network that many times. After the heads, each quad puts (sigma, r,
// g, b) of its two rows into a 64 x 4 fp32 slot (in the consumer's
// encoding tile, which the trunk has finished reading), the consumer meets
// at its named barrier, and its warps run the segmented exclusive scan of
// the TPU kernel's `_composite_flat`, one warp per ray segment of the 64
// rows, 32 rows a piece with shuffles: dist = (s == S - 1 ? sentinel : dz
// (K1, the constant step) or z[s + 1] - z[s]) x ||d||, alpha = 1 -
// exp(-max(sigma, 0) dist), w = alpha exp(carry + exclusive sum of
// log(max(1 - alpha, eps))), the five sums in fp32. The TPU kernel's
// one-hot `selT @ fields` reduction and roll scan are layout tricks of its
// own; here they are a shuffle scan and a sum. A segment that begins
// mid-ray continues from the carry and sums its consumer keeps in shared
// memory (never read by the other consumer; two slots by the parity of the
// step that wrote them, since the first segment of a step may still be
// reading the carry in while the last one leaves its own); one that ends
// mid-ray leaves them there; one that reaches the ray's last sample writes
// out. sigma and rgb never reach device memory.
//
// The quantized routes keep that design; what they change:
// - the stream is intN (ops/ray_wgmma.py). A dequantize chunk is the bf16
//   chunk's image element for element in int8 or int16, then the matrix's
//   256 (or 128) fp32 scales: one scale per 128-byte image row, since an
//   image row is one output column. The producer's first thread copies it
//   into a landing slot (LANDS of them, requested that many chunks ahead);
//   the whole producer warpgroup then writes bf16(f32(q) * s[col]) into the
//   ring stage (an exact integer-to-float construction, no I2F), fences the
//   writes for the tensor cores' proxy, and marks the stage full. The
//   dequantized matrix exists only in shared memory, one chunk at a time;
//   the consumers run the bf16 route's code unchanged. The resident heads
//   and wdir are dequantized with the same rounding where they are read;
// - int8 compute: the s8 chunks of w0, wt and wskip are 128-row slabs (a
//   128-byte image row holds 128 K-values), copied into their stage as
//   they are; wbn and wc0 are dequantize chunks. The consumers run the
//   trunk as s8 products in column parts, m64n128k32 halves (the skip
//   layer's two products carry different scales, so it keeps two s32
//   accumulator sets, in m64n64k32 quarters): layer 0 and the skip product
//   from the encoding,
//   quantized at the fixed scale into a swizzled s8 tile (the SS form);
//   layers 1..7 from registers (the RS form). Each layer's epilogue scales
//   the s32 sums to fp32, (acc * ax[row]) * (s[col] / 127), adds the bias,
//   applies ReLU and rounds to bf16; the row's absmax is a quad's shuffle
//   reduction (a row lives in one quad); the row is then quantized straight
//   into the next product's s8 A fragments. The host permutes the rows of
//   each wt matrix within every 16 (ops/ray_wgmma.K_PERM) so that a
//   thread's accumulator columns are, in order, the K positions of its A
//   fragment: integer sums are exact, so the product is unchanged. The s32
//   sums stay below 2^22 (256 * 127 * 127), which the exact int-to-float
//   construction needs.
//
// Arithmetic contract (the WMMA body's, ops/render_kernel.py; the
// compositing's is csrc/render_samples.cu composite_tile's: ||d|| in fp32
// without FMA, expf/logf without fast math): pos = o + d z
// in fp32 without FMA, K1's z = near + span * (s / (S - 1)); sinf/cosf at
// full range reduction; the direction term per ray in fp32 from a bf16
// encoding (per sample: a bf16 product accumulated in fp32); bf16 products
// with fp32 accumulation; the fp32 bias (and the ray kernels' direction
// term) added before the bf16 rounding; a quantized matrix
// rounded once, bf16(f32(q) * s[col]); the int8-compute route's scales and
// roundings in _int8_mm's order. The sums run in another order than WMMA's,
// so the two agree to bf16's rounding, not bit for bit (the int8-compute
// route: to its own quantization noise, where a flipped bf16 rounding moves
// a row's absmax).

#include <type_traits>

#include "wgmma_common.cuh"

#ifndef NERF_WQ
#define NERF_WQ 0
#endif

namespace {

constexpr int WQ = NERF_WQ;                 // this build's weight route
constexpr int HQ = head_route(WQ);          // the route of the heads, wbn, wc0 and wdir
constexpr bool CONVERTS = WQ != WQ_BF16;    // the producer converts dequantize chunks
constexpr int ES = WQ == WQ_INT16 ? 2 : 1;  // bytes of a quantized weight
constexpr int RW_THREADS = 384;             // producer + two consumer warpgroups
constexpr int RW_ROWS = 64;                 // rows per consumer warpgroup
constexpr int RW_TILE = 2 * RW_ROWS;        // rows per tile
constexpr int PROBE_STAGES = 4;             // the L2 probe's ring
constexpr int CHUNK_K = 64;                 // weight rows per chunk
constexpr int CHUNK_BIG = CHUNK_K * HID * 2;      // 32 KB: a slab of a 256-wide matrix
constexpr int CHUNK_SMALL = CHUNK_K * CH * 2;     // 16 KB: a slab of wc0
constexpr int ENC_TILE = RW_ROWS * KPOS * 2;      // 8 KB: one consumer's encoding (bf16, or
                                                  // s8 with K padded to 128)
constexpr int OUT_F32 = 0, OUT_BF16 = 1, OUT_PLANAR = 2;
// what a block evaluates: K1's uniform depths, K3's per-ray depths, or K4's
// per-sample positions and directions
constexpr int RAYS_UNIFORM = 0, RAYS_Z = 1, SAMPLES = 2;
constexpr int N_SMALL_RAYS = 4, N_SMALL_SAMPLES = 5;   // the 128-wide chunks at a stream's end
// a dequantize chunk in the stream: the intN image of a 64-row slab of N
// columns, then its N scales; a landing slot holds the largest (N = 256)
__host__ __device__ constexpr int conv_bytes(int n) { return n * (CHUNK_K * ES + 4); }
constexpr int LAND_BYTES = CONVERTS ? conv_bytes(HID) : 0;
constexpr int LANDS_MAX = 3;
constexpr int LANDS = !CONVERTS ? 0 : (WQ == WQ_INT8 ? 3 : 2);   // landing slots
constexpr int N_DIRECT_S8 = 1 + 7 * 2 + 1;        // int8 compute: w0, 2 slabs a trunk layer, wskip
constexpr int PRODUCER_BAR = 3;                   // named barrier of the producer warpgroup
// registers a thread after setmaxnreg, the producer warpgroup's and the
// consumers' (128 P + 256 C = the 168 x 384 the block launches with): the
// dequantize routes' producer converts every chunk, several steps at a time
constexpr int PRODUCER_REGS = WQ == WQ_INT8 || WQ == WQ_INT16 ? 56 : 24;
constexpr int CONSUMER_REGS = (168 * RW_THREADS - 128 * PRODUCER_REGS) / 256;
constexpr int CONVERT_BATCH = PRODUCER_REGS >= 56 ? 8 : 1;   // converter steps in flight
static_assert(CONSUMER_REGS % 8 == 0, "setmaxnreg counts");
constexpr float INV127 = float(1.0 / 127.0);
static_assert(LANDS <= LANDS_MAX && LAND_BYTES % 1024 == 0, "landing slots");

// resident parameters, in floats
constexpr int P_B0 = 0, P_BT = P_B0 + HID, P_BBN = P_BT + 7 * HID, P_BC0 = P_BBN + HID,
              P_WSIG = P_BC0 + CH, P_WC1 = P_WSIG + HID, P_BSIG = P_WC1 + CH * 3,
              P_BC1 = P_BSIG + 1, P_FLOATS = (P_BC1 + 3 + 7) / 8 * 8;

// shared-memory map (bytes from a 1024-aligned base): the encodings, the
// resident parameters, the barriers (full and empty per stage, full per
// landing slot), the direction branch of each consumer (the ray kernels':
// per-ray rows, their size following S, then the composited modes' carried
// state of each consumer; the per-sample kernel's: a swizzled bf16 encoding
// tile, 1024-aligned at OFF_DENC), then the weight ring, as many 32 KB
// stages as fit beside the landing slots, then the landing slots
constexpr int STAGES_MAX = 6;
constexpr int SMEM_MAX = 232448;            // a block's shared memory on the H100
constexpr int OFF_ENC = 0;
constexpr int OFF_PAR = OFF_ENC + 2 * ENC_TILE;
constexpr int OFF_BAR = OFF_PAR + P_FLOATS * 4;
constexpr int OFF_LBAR = OFF_BAR + 2 * STAGES_MAX * 8;
constexpr int OFF_DIR = (OFF_LBAR + LANDS_MAX * 8 + 15) / 16 * 16;
constexpr int STATE_FLOATS = 8;             // a carry and five sums (6 used)
// the composited modes' state after the direction branch: [consumer][parity]
__host__ __device__ constexpr int state_offset(int nr_max) {
  return OFF_DIR + 2 * nr_max * (KDIR + CH) * 4;
}
constexpr int OFF_DENC = (OFF_DIR + 1023) / 1024 * 1024;
static_assert(OFF_PAR % 1024 == 0 && OFF_BAR % 8 == 0 && OFF_DIR % 16 == 0, "alignment");
static_assert(RW_ROWS * 4 * 4 <= ENC_TILE, "the composited field slot lives in the encoding tile");
using Ring = RingT<CHUNK_BIG, STAGES_MAX>;   // the consumers' view of the weight ring

struct RwParams {
  Net net;
  const unsigned char* wstream;   // the repacked matrices, in chunk order
  const float* rays_o;   // the ray kernels' rays [R, 3]
  const float* rays_d;
  const float* z;
  long long z_stride;
  const float* pos;      // the per-sample kernel's positions and directions [N, 3]
  const float* dirs;
  void* out;
  float* w;              // the composited modes' weights [R, S], or null
  long long total;       // rows: n_rays * S, or N
  long long tiles;
  int n_rays;
  int S, nr_max, n_chunks, n_small, out_mode;
  int composited, lanes; // composited: the consumer lanes of rays, 2 x grid
  int ring_off, stages;  // the weight ring: byte offset in shared memory, 32 KB stages
  int land_off;          // the landing slots (quantized routes)
  float near, span;
  float dz, sentinel, eps;   // composited: K1's step, the last distance, 1 - alpha's floor
};

// The composited modes' schedule (ops/ray_wgmma.lane_rays, lane_steps): the
// rows of consumer lane `cl`, rays cl R / lanes .. (cl + 1) R / lanes - 1.
// With R = q lanes + m: cl R / lanes = cl q + cl m / lanes, in 32 bits.
__device__ __forceinline__ int lane_first_ray(const RwParams& p, int cl) {
  const int q = p.n_rays / p.lanes, m = p.n_rays - q * p.lanes;
  return cl * q + cl * m / p.lanes;
}
__device__ __forceinline__ void lane_rows(const RwParams& p, int cl, long long& begin,
                                          long long& end) {
  begin = (long long)lane_first_ray(p, cl) * p.S;
  end = (long long)lane_first_ray(p, cl + 1) * p.S;
}
__device__ __forceinline__ int lane_steps(const RwParams& p, int cl) {
  long long begin, end;
  lane_rows(p, cl, begin, end);
  return int((end - begin + RW_ROWS - 1) / RW_ROWS);
}
// The steps of this block, each one pass of the network's stream: the raw
// forms' tiles blockIdx.x + k gridDim.x < tiles; the composited modes', the
// larger of its two lanes' counts.
__device__ __forceinline__ int block_steps(const RwParams& p) {
  if (p.composited) return max(lane_steps(p, 2 * blockIdx.x), lane_steps(p, 2 * blockIdx.x + 1));
  return (long long)blockIdx.x < p.tiles ? int((p.tiles - 1 - blockIdx.x) / gridDim.x) + 1 : 0;
}

// ---- the int8-compute products (m64n128k32 and m64n64k32, s8 in, s32
// accumulate); an overload per width, chosen by the accumulator set ----

#define RW_S32_OUTS                                                                                 \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),   \
  "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),          \
  "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),        \
  "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),        \
  "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),        \
  "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),        \
  "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),        \
  "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),        \
  "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
#define RW_S32_REGS                                                                                 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                          \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

__device__ __forceinline__ void wgmma_ss_s8(uint32_t (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" RW_S32_REGS "}, %64, %65, p;\n}\n"
      : RW_S32_OUTS
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_s8(uint32_t (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" RW_S32_REGS
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : RW_S32_OUTS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#define RW_S32_OUTS_32                                                                              \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),   \
  "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),          \
  "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),        \
  "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),        \
  "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
#define RW_S32_REGS_32                                                                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                          \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"

__device__ __forceinline__ void wgmma_ss_s8(uint32_t (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" RW_S32_REGS_32 "}, %32, %33, p;\n}\n"
      : RW_S32_OUTS_32
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_s8(uint32_t (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" RW_S32_REGS_32
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : RW_S32_OUTS_32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---- the int8-compute trunk ------------------------------------------------

// f32 of an s32 sum |v| < 2^22, exactly: the bits of 1.5 * 2^23 + v, less
// 1.5 * 2^23 (no I2F)
__device__ __forceinline__ float s32_to_f32(uint32_t v) {
  return __fsub_rn(__uint_as_float(v + 0x4B400000u), 12582912.f);
}
// rint(x) for |x| <= 2^21: its low byte is the low byte of the bits of
// 1.5 * 2^23 + x (round to nearest even, as rintf)
__device__ __forceinline__ uint32_t rint_bits(float x) {
  return __float_as_uint(__fadd_rn(x, 12582912.f));
}
// the low bytes of four words into one register, the first lowest
__device__ __forceinline__ uint32_t pack_s8(uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

// A layer's input as s8 A fragments, from its bf16 A fragments: per row
// ax = max|a| over the row's 256 values (a quad holds the row: the thread's
// 64, then two shuffles), a -> rint(a * (127 / max(ax, 1e-20))). Fragment
// aq[kk] covers K positions 32 kk .. 32 kk + 31; register r holds row g
// (r = 0, 2) or g + 8 (1, 3), K positions 16 (r >> 1) + 4 q .. + 3. Those
// hold the thread's accumulator columns 32 kk + 16 (r >> 1) + 8 m + 2 q + e
// (m, e = 0, 1: accumulator blocks j = 4 kk + 2 (r >> 1) + m), which is the
// order ops/ray_wgmma.K_PERM gives the rows of wt.
__device__ __forceinline__ void quantize_rows(const uint32_t (&a)[16][4], uint32_t (&aq)[8][4],
                                              float& ax0, float& ax1) {
  float m0 = 0.f, m1 = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint32_t u0 = a[j >> 1][(j & 1) * 2], u1 = a[j >> 1][(j & 1) * 2 + 1];
    m0 = fmaxf(m0, fmaxf(fabsf(bf_lo(u0)), fabsf(bf_hi(u0))));
    m1 = fmaxf(m1, fmaxf(fabsf(bf_lo(u1)), fabsf(bf_hi(u1))));
  }
  m0 = fmaxf(m0, __shfl_xor_sync(FULL, m0, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(FULL, m1, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(FULL, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(FULL, m1, 2));
  ax0 = m0;
  ax1 = m1;
  const float i0 = __fdiv_rn(127.f, fmaxf(m0, 1e-20f)), i1 = __fdiv_rn(127.f, fmaxf(m1, 1e-20f));
  auto q4 = [](uint32_t u, uint32_t w, float inv) {
    return pack_s8(rint_bits(__fmul_rn(bf_lo(u), inv)), rint_bits(__fmul_rn(bf_hi(u), inv)),
                   rint_bits(__fmul_rn(bf_lo(w), inv)), rint_bits(__fmul_rn(bf_hi(w), inv)));
  };
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    aq[kk][0] = q4(a[2 * kk][0], a[2 * kk][2], i0);
    aq[kk][1] = q4(a[2 * kk][1], a[2 * kk][3], i1);
    aq[kk][2] = q4(a[2 * kk + 1][0], a[2 * kk + 1][2], i0);
    aq[kk][3] = q4(a[2 * kk + 1][1], a[2 * kk + 1][3], i1);
  }
}

// The epilogue of an int8 layer's columns 8 j0 .. 8 (j0 + NJ) - 1 (its
// accumulator blocks j0 ..) into a's bf16 A fragments: y = (f32(acc)
// (* ax[row])) * (s[col] * (1 / 127)), with `two` + f32(acc2) * (s2[col] *
// (1 / 127)) (the skip product), then bf16(relu(y + bias)): _int8_mm's
// operation order (ops/quant.int8_mm).
template <int NJ>
__device__ __forceinline__ void epilogue_s8(const uint32_t (&acc)[4 * NJ],
                                            const uint32_t (&acc2)[4 * NJ], bool two, bool by_row,
                                            float ax0, float ax1, const float* s, const float* s2,
                                            const float* bias, int j0, int q, uint32_t (&a)[16][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = 8 * (j0 + j) + 2 * q;
    const float2 sv = __ldg(reinterpret_cast<const float2*>(s + col));
    const float s0 = __fmul_rn(sv.x, INV127), s1 = __fmul_rn(sv.y, INV127);
    float v0 = s32_to_f32(acc[4 * j]), v1 = s32_to_f32(acc[4 * j + 1]);
    float v2 = s32_to_f32(acc[4 * j + 2]), v3 = s32_to_f32(acc[4 * j + 3]);
    if (by_row) {
      v0 = __fmul_rn(v0, ax0);
      v1 = __fmul_rn(v1, ax0);
      v2 = __fmul_rn(v2, ax1);
      v3 = __fmul_rn(v3, ax1);
    }
    v0 = __fmul_rn(v0, s0);
    v1 = __fmul_rn(v1, s1);
    v2 = __fmul_rn(v2, s0);
    v3 = __fmul_rn(v3, s1);
    if (two) {
      const float2 tv = __ldg(reinterpret_cast<const float2*>(s2 + col));
      const float t0 = __fmul_rn(tv.x, INV127), t1 = __fmul_rn(tv.y, INV127);
      v0 = __fadd_rn(v0, __fmul_rn(s32_to_f32(acc2[4 * j]), t0));
      v1 = __fadd_rn(v1, __fmul_rn(s32_to_f32(acc2[4 * j + 1]), t1));
      v2 = __fadd_rn(v2, __fmul_rn(s32_to_f32(acc2[4 * j + 2]), t0));
      v3 = __fadd_rn(v3, __fmul_rn(s32_to_f32(acc2[4 * j + 3]), t1));
    }
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
    const int J = j0 + j;
    a[J >> 1][(J & 1) * 2] = pack_bf16(fmaxf(__fadd_rn(v0, b.x), 0.f), fmaxf(__fadd_rn(v1, b.y), 0.f));
    a[J >> 1][(J & 1) * 2 + 1] =
        pack_bf16(fmaxf(__fadd_rn(v2, b.x), 0.f), fmaxf(__fadd_rn(v3, b.y), 0.f));
  }
}

// One column part of a trunk layer 1..7 on the int8-compute route: blocks
// j0 .. j0 + NJ - 1 (8 columns, 8 image rows = 64 descriptor units each) of
// acc = aq @ wt (two chunks of 128 K positions, b0 and b1) and, with SKIP,
// acc2 = encq @ wskip (bs); its epilogue into a.
template <int NJ, bool SKIP>
__device__ __forceinline__ void trunk_part_s8(uint64_t b0, uint64_t b1, uint64_t bs,
                                              uint64_t enc_desc, int j0, uint32_t (&aq)[8][4],
                                              float ax0, float ax1, const float* s,
                                              const float* s2, const float* bias, int q,
                                              uint32_t (&a)[16][4]) {
  uint32_t acc[4 * NJ], acc2[4 * NJ];
  const uint64_t off = uint64_t(j0) * 64;
  fence_regs(acc);
  fence_regs(aq);
  if (SKIP) fence_regs(acc2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_s8(acc, aq[kk], b0 + off + 2 * kk, kk != 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_s8(acc, aq[4 + kk], b1 + off + 2 * kk, 1);
  if (SKIP) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) wgmma_ss_s8(acc2, enc_desc + 2 * kk, bs + off + 2 * kk, kk != 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  if (SKIP) fence_regs(acc2);
  epilogue_s8<NJ>(acc, acc2, SKIP, true, ax0, ax1, s, s2, bias, j0, q, a);
}

// One trunk layer 1..7 on the int8-compute route, in column parts: halves
// of 128, or for the skip layer, whose two products need two accumulator
// sets, quarters of 64 (so that they fit beside aq and a).
template <bool SKIP>
__device__ __forceinline__ void trunk_layer_s8(const Net& net, const float* s, const float* bias,
                                               Ring& ring, bool leader, uint64_t enc_desc, int q,
                                               uint32_t (&aq)[8][4], float ax0, float ax1,
                                               uint32_t (&a)[16][4]) {
  constexpr int NJ = SKIP ? 8 : 16;
  const uint64_t b0 = sw128_desc(ring.acquire());
  const uint64_t b1 = sw128_desc(ring.acquire());
  const uint64_t bs = SKIP ? sw128_desc(ring.acquire()) : 0;
#pragma unroll
  for (int j0 = 0; j0 < 32; j0 += NJ)
    trunk_part_s8<NJ, SKIP>(b0, b1, bs, enc_desc, j0, aq, ax0, ax1, s, net.wskip_s, bias, q, a);
  ring.release(leader);
  ring.release(leader);
  if (SKIP) ring.release(leader);
}

// The trunk on the int8-compute route for one consumer warpgroup: layer 0
// from the s8 encoding tile (enc_desc; K = 64 of its 128, the rest of the
// w0 slab is zero), layers 1..7 from the s8 fragments of the layer before,
// the skip product from the encoding again into its own accumulators. Each
// layer runs in column parts (the B descriptor 16 atoms on for a half).
// Leaves h7 in a, as the other routes do.
__device__ __forceinline__ void trunk_s8(const Net& net, const float* par, Ring& ring, bool leader,
                                         uint64_t enc_desc, int q, uint32_t (&a)[16][4]) {
  uint32_t acc[64], aq[8][4];
  float ax0 = 0.f, ax1 = 0.f;
  {
    const uint64_t b = sw128_desc(ring.acquire());
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_ss_s8(acc, enc_desc + 2 * kk, b + h * 1024 + 2 * kk, kk != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      epilogue_s8<16>(acc, acc, false, false, ax0, ax1, net.w0_s, nullptr, par + P_B0, 16 * h, q, a);
    }
    ring.release(leader);
  }
  for (int i = 1; i < 8; ++i) {
    quantize_rows(a, aq, ax0, ax1);
    const float* s = net.wt_s + (i - 1) * HID;
    const float* bias = par + P_BT + (i - 1) * HID;
    if (i == net.skip_pos)
      trunk_layer_s8<true>(net, s, bias, ring, leader, enc_desc, q, aq, ax0, ax1, a);
    else
      trunk_layer_s8<false>(net, s, bias, ring, leader, enc_desc, q, aq, ax0, ax1, a);
  }
}

// The composited modes' volume rendering of one consumer's rows n0 ..
// stop - 1 of a step ((sigma, r, g, b) of row n at fld[n - n0]): one warp per
// ray segment, its lanes over 32 rows at a time, the exclusive scan of
// log(max(1 - alpha, eps)) by shuffles, continued from the carry. A segment
// that begins mid-ray (only the first) starts from the state `in` (carry,
// r, g, b, depth, acc) its consumer's previous step left; one that ends
// mid-ray (only the last) leaves its state in `out_st`, the other parity's
// slot, since another warp may still be reading `in`; one that reaches the
// ray's last sample writes out.
template <bool ZIN>
__device__ __forceinline__ void composite_step(const RwParams& p, const float* fld,
                                               const float* in, float* out_st, long long n0,
                                               long long stop, int warp, int lane) {
  const long long r_lo = n0 / p.S;
  const int nr = int((stop - 1) / p.S - r_lo) + 1;
  for (int seg = warp; seg < nr; seg += 4) {
    const long long r = r_lo + seg, first = r * p.S;
    const long long a = max(n0, first), b = min(stop, first + p.S);
    const bool cont = a > first, ends = b == first + p.S;
    const float dx = p.rays_d[r * 3], dy = p.rays_d[r * 3 + 1], dzr = p.rays_d[r * 3 + 2];
    const float dnorm =
        sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dzr, dzr)));
    const float* zr = ZIN ? p.z + r * p.z_stride : nullptr;
    float carry = cont ? in[0] : 0.f;
    float sr = 0.f, sg = 0.f, sb = 0.f, sd = 0.f, sa = 0.f;
    for (long long c0 = a; c0 < b; c0 += 32) {
      const long long n = c0 + lane;
      const bool valid = n < b;
      const int s = int(n - first);
      float sigma = 0.f, cr = 0.f, cg = 0.f, cb = 0.f, zs = 0.f, dist = 0.f;
      if (valid) {
        const float4 f = reinterpret_cast<const float4*>(fld)[n - n0];
        sigma = f.x;
        cr = f.y;
        cg = f.z;
        cb = f.w;
        if (ZIN)
          zs = zr[s];
        else
          zs = __fadd_rn(p.near, __fmul_rn(p.span, __fdiv_rn(float(s), float(p.S - 1))));
        if (s == p.S - 1)
          dist = p.sentinel;
        else
          dist = ZIN ? __fsub_rn(zr[s + 1], zs) : p.dz;
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
      if (cont) {
        sr += in[1];
        sg += in[2];
        sb += in[3];
        sd += in[4];
        sa += in[5];
      }
      if (ends) {
        float4* o = static_cast<float4*>(p.out) + 2 * r;
        o[0] = make_float4(sr, sg, sb, sd);
        o[1] = make_float4(sa, 0.f, 0.f, 0.f);
      } else {
        out_st[0] = carry;
        out_st[1] = sr;
        out_st[2] = sg;
        out_st[3] = sb;
        out_st[4] = sd;
        out_st[5] = sa;
      }
    }
  }
}

// One consumer warpgroup (c = 0, 1). The raw forms and the per-sample
// kernel: rows n0 .. n0 + 63 of every tile of this block. The composited
// modes (COMP): the rows of its lane of rays, 64 at a time, in order.
template <int MODE, bool COMP>
__device__ __forceinline__ void consumer(const RwParams& p, unsigned char* sm, int c) {
  constexpr bool RAYS = MODE != SAMPLES;
  static_assert(RAYS || !COMP, "the per-sample kernel has no composited mode");
  const int t = threadIdx.x - 128 * (c + 1);
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const bool leader = t == 0;
  const int bar_id = 1 + c;
  const Net& net = p.net;
  const float* par = reinterpret_cast<const float*>(sm + OFF_PAR);
  unsigned char* enc = sm + OFF_ENC + c * ENC_TILE;
  const uint64_t enc_desc = sw128_desc(smem_u32(enc));
  float* denc = reinterpret_cast<float*>(sm + OFF_DIR) + c * p.nr_max * (KDIR + CH);
  float* cdir = denc + p.nr_max * KDIR;
  unsigned char* dtile = sm + OFF_DENC + c * ENC_TILE;   // per sample: the bf16 encoding tile
  const uint64_t denc_desc = sw128_desc(smem_u32(dtile));
  // composited: the step's fields, in the encoding tile once the trunk has
  // read it, and the state carried from step to step (two slots, by the
  // parity of the step that writes it)
  float* fld = reinterpret_cast<float*>(enc);
  float* st = reinterpret_cast<float*>(sm + state_offset(p.nr_max)) + c * 2 * STATE_FLOATS;
  Ring ring{smem_u32(sm + p.ring_off), smem_u32(sm + OFF_BAR), p.stages, 0, 0u, 0};
  float acc[128];
  uint32_t a[16][4];
  const int steps = COMP ? block_steps(p) : 0;

  // the raw forms: tiles blockIdx.x + k gridDim.x; the composited modes: the
  // lane's steps, its rows derived anew each step (no register held for them)
  for (int tile = blockIdx.x, step = 0; COMP ? step < steps : tile < int(p.tiles);
       tile += gridDim.x, ++step) {
    long long n0, n_end = p.total;   // this step's rows n0 .. n0 + 63, those < n_end
    if constexpr (COMP) {
      lane_rows(p, 2 * blockIdx.x + c, n0, n_end);
      n0 += (long long)step * RW_ROWS;
    } else {
      n0 = (long long)tile * RW_TILE + c * RW_ROWS;
    }
    const bool any = n0 < n_end;
    const long long r_lo = RAYS && any ? n0 / p.S : 0;
    const int nr = RAYS && any ? int((min(n0 + RW_ROWS, n_end) - 1) / p.S - r_lo) + 1 : 0;

    // 1. the ray kernels' direction branch once per ray of these rows:
    //    cdir = bf16(denc) @ wdir
    named_sync(bar_id);   // the previous tile is done with cdir, enc and the encoding tile
    if constexpr (RAYS) {
      for (int e = t; e < nr * KDIR; e += 128) {
        const int sl = e / KDIR, k = e % KDIR;
        const long long r = r_lo + sl;
        float d[3] = {p.rays_d[r * 3], p.rays_d[r * 3 + 1], p.rays_d[r * 3 + 2]};
        if (net.normalize_dirs) normalize_dir(d);
        denc[e] = __bfloat162float(
            __float2bfloat16_rn(encode_xyz(d[0], d[1], d[2], k, net.Ld, net.band_scale)));
      }
      named_sync(bar_id);
      for (int e = t; e < nr * CH; e += 128) {
        const int sl = e / CH, col = e % CH;
        float sum = 0.f;
#pragma unroll 8
        for (int k = 0; k < KDIR; ++k)
          sum = fmaf(denc[sl * KDIR + k], weight_at<HQ>(net.wdir, net.wdir_s, k * CH + col, col), sum);
        cdir[e] = sum;
      }
    }

    // 2. the position (the ray kernels: depth, then pos = o + d z in fp32, no
    //    fma; per sample: read) and its encoding: thread t takes row t % 64
    //    and half t / 64 of its columns (whole warps per half, so the column
    //    pattern is known when compiled); per sample, half 0 also encodes the
    //    row's direction into its bf16 tile
    {
      const int row = t & (RW_ROWS - 1);
      const long long n = n0 + row;
      const bool valid = n < n_end;
      float x0 = 0.f, x1 = 0.f, x2 = 0.f;
      float d[3] = {0.f, 0.f, 0.f};
      if (valid) {
        if constexpr (MODE == SAMPLES) {
          x0 = p.pos[n * 3];
          x1 = p.pos[n * 3 + 1];
          x2 = p.pos[n * 3 + 2];
          if (t < RW_ROWS) {
#pragma unroll
            for (int k = 0; k < 3; ++k) d[k] = p.dirs[n * 3 + k];
            if (net.normalize_dirs) normalize_dir(d);
          }
        } else {
          const long long r = n / p.S;
          const int s = int(n - r * p.S);
          float zz;
          if (MODE == RAYS_Z) {
            zz = p.z[r * p.z_stride + s];
          } else {
            const float u = __fdiv_rn(float(s), float(p.S - 1));
            zz = __fadd_rn(p.near, __fmul_rn(p.span, u));
          }
          x0 = __fadd_rn(p.rays_o[r * 3], __fmul_rn(p.rays_d[r * 3], zz));
          x1 = __fadd_rn(p.rays_o[r * 3 + 1], __fmul_rn(p.rays_d[r * 3 + 1], zz));
          x2 = __fadd_rn(p.rays_o[r * 3 + 2], __fmul_rn(p.rays_d[r * 3 + 2], zz));
        }
      }
      uint32_t v[16];
      if constexpr (MODE == SAMPLES) {
        // the direction's columns 0..31 (KDIR): K 0..31 of the tile, the
        // rest of its 128-byte row never read
        if (t < RW_ROWS) {
          encode_half<0>(d[0], d[1], d[2], valid ? net.Ld : -1, net.band_scale, v);
          unsigned char* ddst = dtile + (row >> 3) * 1024 + (row & 7) * 128;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<uint4*>(ddst + ((j ^ (row & 7)) << 4)) =
                make_uint4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
        }
      }
      if (t < RW_ROWS)
        encode_half<0>(x0, x1, x2, valid ? net.Lp : -1, net.band_scale, v);
      else
        encode_half<1>(x0, x1, x2, valid ? net.Lp : -1, net.band_scale, v);
      const int half = t / RW_ROWS;
      unsigned char* dst = enc + (row >> 3) * 1024 + (row & 7) * 128;
      if constexpr (WQ == WQ_INT8_COMPUTE) {
        // clip(rint(enc * (enc_scale * 127)), +-127) into K 32 half .. + 31
        // of a 128-byte row (16-byte pieces 2 half, 2 half + 1)
        uint32_t w[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t b[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = 4 * j + e;
            const float x = (k & 1) ? bf_hi(v[k >> 1]) : bf_lo(v[k >> 1]);
            const float y = __fmul_rn(x, __fmul_rn(__ldg(net.enc_scale + 32 * half + k), 127.f));
            b[e] = rint_bits(fminf(fmaxf(y, -127.f), 127.f));
          }
          w[j] = pack_s8(b[0], b[1], b[2], b[3]);
        }
#pragma unroll
        for (int pp = 0; pp < 2; ++pp)
          *reinterpret_cast<uint4*>(dst + (((2 * half + pp) ^ (row & 7)) << 4)) =
              make_uint4(w[4 * pp], w[4 * pp + 1], w[4 * pp + 2], w[4 * pp + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ck = half * 4 + j;   // 16-byte column chunk: columns 8 ck .. 8 ck + 7
          *reinterpret_cast<uint4*>(dst + ((ck ^ (row & 7)) << 4)) =
              make_uint4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
        }
      }
    }
    fence_async_smem();   // the encoding is read by the tensor cores' proxy
    named_sync(bar_id);

    if constexpr (WQ == WQ_INT8_COMPUTE) {
      // 3-4. the trunk as s8 x s8 products
      trunk_s8(net, par, ring, leader, enc_desc, q, a);
      // per sample, the accumulators are set only here, so the last tile's
      // are not kept alive through the encodings and the s8 trunk
      if constexpr (MODE == SAMPLES) {
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      }
    } else {
      // 3. layer 0 from the encoding, one chunk (per sample, the
      //    accumulators are set only here, as above)
      if constexpr (MODE == SAMPLES) {
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      }
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

      // 4. trunk layers 1..7, the skip product accumulated at skip_pos
      for (int i = 1; i < 8; ++i) {
        hidden_layer(acc, a, ring, leader, i == net.skip_pos, enc_desc);
        epilogue_to_a(acc, a, par + P_BT + (i - 1) * HID, q, true);
      }
    }

    // 5. density from h7: partial dot products over the thread's 64
    //    columns, summed across the quad
    float sg0 = 0.f, sg1 = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float2 w = *reinterpret_cast<const float2*>(par + P_WSIG + 8 * j + 2 * q);
      const uint32_t u0 = a[j >> 1][(j & 1) * 2], u1 = a[j >> 1][(j & 1) * 2 + 1];
      sg0 = fmaf(bf_hi(u0), w.y, fmaf(bf_lo(u0), w.x, sg0));
      sg1 = fmaf(bf_hi(u1), w.y, fmaf(bf_lo(u1), w.x, sg1));
    }
    sg0 += __shfl_xor_sync(FULL, sg0, 1);
    sg1 += __shfl_xor_sync(FULL, sg1, 1);
    sg0 += __shfl_xor_sync(FULL, sg0, 2);
    sg1 += __shfl_xor_sync(FULL, sg1, 2);
    sg0 += par[P_BSIG];
    sg1 += par[P_BSIG];
    if (net.relu_sigma) {
      sg0 = fmaxf(sg0, 0.f);
      sg1 = fmaxf(sg1, 0.f);
    }

    // 6. bmild bottleneck (no activation)
    if (net.bmild) {
      hidden_layer(acc, a, ring, leader, false, enc_desc);
      epilogue_to_a(acc, a, par + P_BBN, q, false);
    }

    // 7. color layer (128 wide); per sample with the direction term as one
    //    more chunk: denc @ wdir, K = 32 of the encoding tile
    fence_regs(acc);
    fence_regs(a);
    wgmma_fence();
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      const uint64_t b = sw128_desc(ring.acquire());
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n128(acc, a[ch * 4 + kk], b + 2 * kk, (ch | kk) != 0);
      wgmma_commit();
      wgmma_wait<0>();
      ring.release(leader);
    }
    if constexpr (MODE == SAMPLES) {
      const uint64_t b = sw128_desc(ring.acquire());
#pragma unroll
      for (int kk = 0; kk < KDIR / 16; ++kk) wgmma_ss_n128(acc, denc_desc + 2 * kk, b + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      ring.release(leader);
    }
    fence_regs(acc);

    // 8. c = bf16(relu(acc + bc0 (+ cdir))), rgb = sigmoid(c @ wc1 + bc1),
    //    from registers, summed across the quad
    const long long nrow0 = n0 + 16 * warp + g, nrow1 = nrow0 + 8;
    const int sl0 = RAYS && nrow0 < n_end ? int(nrow0 / p.S - r_lo) : 0;
    const int sl1 = RAYS && nrow1 < n_end ? int(nrow1 / p.S - r_lo) : 0;
    const float* cd0 = cdir + sl0 * CH;
    const float* cd1 = cdir + sl1 * CH;
    float c0[3] = {0.f, 0.f, 0.f}, c1[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * q;
      const float2 b = *reinterpret_cast<const float2*>(par + P_BC0 + col);
      float u00 = acc[4 * j] + b.x, u01 = acc[4 * j + 1] + b.y;
      float u10 = acc[4 * j + 2] + b.x, u11 = acc[4 * j + 3] + b.y;
      if constexpr (RAYS) {
        const float2 d0 = *reinterpret_cast<const float2*>(cd0 + col);
        const float2 d1 = *reinterpret_cast<const float2*>(cd1 + col);
        u00 += d0.x;
        u01 += d0.y;
        u10 += d1.x;
        u11 += d1.y;
      }
      const float v00 = __bfloat162float(__float2bfloat16_rn(fmaxf(u00, 0.f)));
      const float v01 = __bfloat162float(__float2bfloat16_rn(fmaxf(u01, 0.f)));
      const float v10 = __bfloat162float(__float2bfloat16_rn(fmaxf(u10, 0.f)));
      const float v11 = __bfloat162float(__float2bfloat16_rn(fmaxf(u11, 0.f)));
      const float* w = par + P_WC1 + col * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        c0[k] = fmaf(v01, w[3 + k], fmaf(v00, w[k], c0[k]));
        c1[k] = fmaf(v11, w[3 + k], fmaf(v10, w[k], c1[k]));
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c0[k] += __shfl_xor_sync(FULL, c0[k], 1);
      c1[k] += __shfl_xor_sync(FULL, c1[k], 1);
      c0[k] += __shfl_xor_sync(FULL, c0[k], 2);
      c1[k] += __shfl_xor_sync(FULL, c1[k], 2);
      c0[k] = 1.f / (1.f + expf(-(c0[k] + par[P_BC1 + k])));
      c1[k] = 1.f / (1.f + expf(-(c1[k] + par[P_BC1 + k])));
    }

    // 9. lane q = 0 of the quad writes row g, q = 1 row g + 8: to the
    //    output, or (composited) to the field slot, which the consumer's
    //    warps then composite
    if constexpr (COMP) {
      if (q < 2)
        reinterpret_cast<float4*>(fld)[16 * warp + g + 8 * q] =
            q ? make_float4(sg1, c1[0], c1[1], c1[2]) : make_float4(sg0, c0[0], c0[1], c0[2]);
      named_sync(bar_id);
      if (any)
        composite_step<MODE == RAYS_Z>(p, fld, st + (step & 1) * STATE_FLOATS,
                                       st + (~step & 1) * STATE_FLOATS, n0,
                                       min(n0 + RW_ROWS, n_end), warp, lane);
    } else if (q < 2) {
      const long long n = q ? nrow1 : nrow0;
      if (n < n_end) {
        const float v[4] = {q ? sg1 : sg0, q ? c1[0] : c0[0], q ? c1[1] : c0[1], q ? c1[2] : c0[2]};
        if (MODE == SAMPLES || p.out_mode == OUT_F32) {
          static_cast<float4*>(p.out)[n] = make_float4(v[0], v[1], v[2], v[3]);
        } else if (p.out_mode == OUT_BF16) {
          __align__(8) bf16 h[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) h[k] = __float2bfloat16_rn(v[k]);
          static_cast<uint2*>(p.out)[n] = *reinterpret_cast<const uint2*>(h);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) static_cast<float*>(p.out)[k * p.total + n] = v[k];
        }
      }
    }
  }
}

// The producer: one thread streams the network once per step of this block
// (block_steps), chunk after chunk, into the ring. Every chunk is 32 KB but
// the last n_small (wc0's four slabs and, per sample, wdir's: 16 KB).
__device__ __forceinline__ void producer(const RwParams& p, unsigned char* sm) {
  const uint32_t ring = smem_u32(sm + p.ring_off), bars = smem_u32(sm + OFF_BAR);
  const int n_big = p.n_chunks - p.n_small, steps = block_steps(p);
  int stage = 0;
  uint32_t phase = 0;
  for (int step = 0; step < steps; ++step) {
    const unsigned char* src = p.wstream;
    for (int j = 0; j < p.n_chunks; ++j) {
      const uint32_t bytes = j < n_big ? CHUNK_BIG : CHUNK_SMALL;
      mbar_wait(bars + 8 * (STAGES_MAX + stage), phase ^ 1);
      mbar_expect_tx(bars + 8 * stage, bytes);
      bulk_load(ring + stage * CHUNK_BIG, src, bytes, bars + 8 * stage);
      src += bytes;
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// ---- the quantized routes' producer ------------------------------------------

// The stream's chunks on a quantized route (ops/ray_wgmma.chunk_schedule,
// sample_chunk_schedule): first n_direct() s8 slabs of 32 KB copied as they
// are (int8 compute), then dequantize chunks, 64-row slabs of 256 columns
// but the last ns of the n (wc0 and, per sample, wdir: 128 columns).
__device__ __forceinline__ int n_direct() { return WQ == WQ_INT8_COMPUTE ? N_DIRECT_S8 : 0; }
__device__ __forceinline__ int conv_cols(int j, int n, int ns) { return j >= n - ns ? CH : HID; }
__device__ __forceinline__ uint32_t chunk_offset(int j, int n, int ns) {
  const int nd = n_direct();
  if (j <= nd) return uint32_t(j) * CHUNK_BIG;
  const int big = min(j, n - ns) - nd, small = max(j - (n - ns), 0);
  return uint32_t(nd) * CHUNK_BIG + uint32_t(big) * conv_bytes(HID) + uint32_t(small) * conv_bytes(CH);
}

// bf16(f32(q) * s) of the intN values of a word, as bf16 pairs: f32(q) is
// built exactly from the bits of 2^23 + (q + 2^(b-1)) (no I2F)
__device__ __forceinline__ float q_at(uint32_t x, uint32_t sel, float bias) {
  return __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, sel)), bias);
}
__device__ __forceinline__ void dequant_word(uint32_t w, float s, uint32_t* out) {
  if constexpr (ES == 1) {
    const uint32_t x = w ^ 0x80808080u;   // s8 -> offset binary
    out[0] = pack_bf16(__fmul_rn(q_at(x, 0x7440, 8388736.f), s), __fmul_rn(q_at(x, 0x7441, 8388736.f), s));
    out[1] = pack_bf16(__fmul_rn(q_at(x, 0x7442, 8388736.f), s), __fmul_rn(q_at(x, 0x7443, 8388736.f), s));
  } else {
    const uint32_t x = w ^ 0x80008000u;   // s16 -> offset binary
    out[0] = pack_bf16(__fmul_rn(q_at(x, 0x7410, 8421376.f), s), __fmul_rn(q_at(x, 0x7432, 8421376.f), s));
  }
}
// the 8 values of one 16-byte output vector: 8 bytes of int8, 16 of int16
__device__ __forceinline__ void dequant_vec(uint2 w, float s, uint32_t (&o)[4]) {
  dequant_word(w.x, s, o);
  dequant_word(w.y, s, o + 2);
}
__device__ __forceinline__ void dequant_vec(uint4 w, float s, uint32_t (&o)[4]) {
  dequant_word(w.x, s, o);
  dequant_word(w.y, s, o + 1);
  dequant_word(w.z, s, o + 2);
  dequant_word(w.w, s, o + 3);
}

// One landed dequantize chunk (`cols` image rows of 64 intN values, then
// `cols` scales) into its bf16 stage, 16 bytes (8 values, one image row's
// scale) a thread and step; CONVERT_BATCH steps load before any converts,
// so their shared-memory latencies overlap.
__device__ __forceinline__ void convert_chunk(const unsigned char* __restrict__ src,
                                              unsigned char* __restrict__ dst, int cols, int t) {
  typedef typename std::conditional<ES == 1, uint2, uint4>::type Word;
  const float* scale = reinterpret_cast<const float*>(src + cols * CHUNK_K * ES);
  for (int v0 = t; v0 < cols * 8; v0 += 128 * CONVERT_BATCH) {
    Word w[CONVERT_BATCH];
    float s[CONVERT_BATCH];
#pragma unroll
    for (int b = 0; b < CONVERT_BATCH; ++b) {
      const int v = v0 + 128 * b;
      w[b] = *reinterpret_cast<const Word*>(src + v * sizeof(Word));
      s[b] = scale[v >> 3];
    }
#pragma unroll
    for (int b = 0; b < CONVERT_BATCH; ++b) {
      uint32_t o[4];
      dequant_vec(w[b], s[b], o);
      *reinterpret_cast<uint4*>(dst + (v0 + 128 * b) * 16) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// The producer warpgroup on a quantized route. Its first thread copies each
// s8 chunk straight into its stage (as on the bf16 route) and requests each
// dequantize chunk into a landing slot, LANDS chunks ahead; all its threads
// convert a landed chunk into its stage, fence the writes for the tensor
// cores' proxy and meet; the first thread then marks the stage full and
// requests the next chunk into the freed slot.
__device__ __forceinline__ void producer_q(const RwParams& p, unsigned char* sm) {
  const int t = threadIdx.x, n = p.n_chunks, nd = n_direct(), nconv = n - nd;
  const int steps = block_steps(p);
  const uint32_t bars = smem_u32(sm + OFF_BAR), lbars = smem_u32(sm + OFF_LBAR);
  int req = 0;   // thread 0: dequantize chunks requested, over this block's steps
  auto request = [&](int slot) {
    const int j = nd + req % nconv;
    if (req / nconv >= steps) return;
    ++req;
    const uint32_t bytes = conv_bytes(conv_cols(j, n, p.n_small));
    fence_async_smem();   // the slot's last reads were the generic proxy's
    mbar_expect_tx(lbars + 8 * slot, bytes);
    bulk_load(smem_u32(sm + p.land_off + slot * LAND_BYTES), p.wstream + chunk_offset(j, n, p.n_small),
              bytes, lbars + 8 * slot);
  };
  if (t == 0)
    for (int s = 0; s < LANDS; ++s) request(s);
  int stage = 0, slot = 0;
  uint32_t phase = 0, lphase = 0;
  for (int step = 0; step < steps; ++step) {
    for (int j = 0; j < n; ++j) {
      const uint32_t full = bars + 8 * stage;
      unsigned char* dst = sm + p.ring_off + stage * CHUNK_BIG;
      // every thread waits for the stage, so none runs a phase of its
      // barrier ahead (a parity wait cannot tell two phases apart)
      mbar_wait(bars + 8 * (STAGES_MAX + stage), phase ^ 1);
      if (j < nd) {
        if (t == 0) {
          mbar_expect_tx(full, CHUNK_BIG);
          bulk_load(smem_u32(dst), p.wstream + uint32_t(j) * CHUNK_BIG, CHUNK_BIG, full);
        }
      } else {
        mbar_wait(lbars + 8 * slot, lphase);
        convert_chunk(sm + p.land_off + slot * LAND_BYTES, dst, conv_cols(j, n, p.n_small), t);
        fence_async_smem();
        producer_sync(PRODUCER_BAR);
        if (t == 0) {
          mbar_arrive(full);
          request(slot);
        }
        if (++slot == LANDS) {
          slot = 0;
          lphase ^= 1;
        }
      }
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

template <int MODE, bool COMP = false>
__device__ __forceinline__ void ray_wgmma_body(const RwParams& p, unsigned char* smem_raw) {
  unsigned char* sm = aligned_smem(smem_raw);
  const Net& net = p.net;
  float* par = reinterpret_cast<float*>(sm + OFF_PAR);
  for (int i = threadIdx.x; i < P_FLOATS; i += RW_THREADS) {
    float v = 0.f;
    if (i < P_BT) v = net.b0[i - P_B0];
    else if (i < P_BBN) v = net.bt[i - P_BT];
    else if (i < P_BC0) v = net.bmild ? net.bbn[i - P_BBN] : 0.f;
    else if (i < P_WSIG) v = net.bc0[i - P_BC0];
    else if (i < P_WC1) v = weight_at<HQ>(net.wsig, net.wsig_s, i - P_WSIG, 0);
    else if (i < P_BSIG) v = weight_at<HQ>(net.wc1, net.wc1_s, i - P_WC1, (i - P_WC1) % 3);
    else if (i == P_BSIG) v = net.bsig[0];
    else if (i < P_BC1 + 3) v = net.bc1[i - P_BC1];
    par[i] = v;
  }
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_u32(sm + OFF_BAR);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bars + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(bars + 8 * (STAGES_MAX + s), 2);   // one arrival per consumer
    }
    for (int s = 0; s < LANDS; ++s) mbar_init(smem_u32(sm + OFF_LBAR) + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if constexpr (CONVERTS)
      producer_q(p, sm);
    else if (threadIdx.x == 0)
      producer(p, sm);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consumer<MODE, COMP>(p, sm, threadIdx.x / 128 - 1);
  }
}

__global__ void __launch_bounds__(RW_THREADS, 1) ray_wgmma_kernel(const __grid_constant__ RwParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  ray_wgmma_body<RAYS_UNIFORM>(p, smem_raw);
}

__global__ void __launch_bounds__(RW_THREADS, 1) ray_z_wgmma_kernel(const __grid_constant__ RwParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  ray_wgmma_body<RAYS_Z>(p, smem_raw);
}

__global__ void __launch_bounds__(RW_THREADS, 1)
    ray_composite_wgmma_kernel(const __grid_constant__ RwParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  ray_wgmma_body<RAYS_UNIFORM, true>(p, smem_raw);
}

__global__ void __launch_bounds__(RW_THREADS, 1)
    ray_z_composite_wgmma_kernel(const __grid_constant__ RwParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  ray_wgmma_body<RAYS_Z, true>(p, smem_raw);
}

__global__ void __launch_bounds__(RW_THREADS, 1) mlp_wgmma_kernel(const __grid_constant__ RwParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  ray_wgmma_body<SAMPLES>(p, smem_raw);
}

// The L2 probe: every block streams a buffer of 32 KB chunks `reps` times
// through the same ring, the producer's way (bulk copies, full/empty
// barriers), and a consumer that only hands each stage back: the rate at
// which L2 feeds the SMs' weight rings.
__global__ void __launch_bounds__(64, 1) l2_probe_kernel(const unsigned char* buf, int chunks, int reps) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t ring = smem_u32(sm), bars = smem_u32(sm + PROBE_STAGES * CHUNK_BIG);
  if (threadIdx.x == 0) {
    for (int s = 0; s < PROBE_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (PROBE_STAGES + s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int stage = 0;
  uint32_t phase = 0;
  const int total = chunks * reps;
  if (threadIdx.x == 0) {
    for (int j = 0; j < total; ++j) {
      mbar_wait(bars + 8 * (PROBE_STAGES + stage), phase ^ 1);
      mbar_expect_tx(bars + 8 * stage, CHUNK_BIG);
      bulk_load(ring + stage * CHUNK_BIG, buf + size_t(j % chunks) * CHUNK_BIG, CHUNK_BIG,
                bars + 8 * stage);
      if (++stage == PROBE_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else if (threadIdx.x == 32) {
    for (int j = 0; j < total; ++j) {
      mbar_wait(bars + 8 * stage, phase);
      mbar_arrive(bars + 8 * (PROBE_STAGES + stage));
      if (++stage == PROBE_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// Offset of the weight ring after the direction branch: the ray kernels'
// nr_max rays per consumer and the composited modes' state, or (nr_max = 0)
// the per-sample kernel's two encoding tiles; and the stages that fit
// beside it.
int ring_offset(int nr_max) {
  const int end = nr_max ? state_offset(nr_max) + 2 * 2 * STATE_FLOATS * int(sizeof(float))
                         : OFF_DENC + 2 * ENC_TILE;
  return (end + 1023) / 1024 * 1024;
}
// the 32 KB stages that fit beside the landing slots
int ring_stages(int nr_max) {
  const int n = (SMEM_MAX - 1024 - ring_offset(nr_max) - LANDS * LAND_BYTES) / CHUNK_BIG;
  return n < STAGES_MAX ? n : STAGES_MAX;
}
// The composited modes' grid: two lanes of rays a block, one block an SM,
// but no more blocks than half the rays, rounded up
// (ops/ray_wgmma.composited_grid)
int composited_grid(long long n_rays) {
  const long long g = (n_rays + 1) / 2, sms = sm_count();
  return int(g < 1 ? 1 : g < sms ? g : sms);
}
int land_offset(int nr_max) { return ring_offset(nr_max) + ring_stages(nr_max) * CHUNK_BIG; }
size_t rw_smem_bytes(int nr_max) { return 1024 + land_offset(nr_max) + size_t(LANDS) * LAND_BYTES; }

// Chunks of the weight stream (ops/ray_wgmma.chunk_schedule): w0, 7 trunk
// layers of 4 slabs (2 on the int8-compute route), wskip, 4 bottleneck
// slabs (bmild), 4 color slabs.
int stream_chunks(int bmild) {
  return 1 + 7 * (WQ == WQ_INT8_COMPUTE ? 2 : 4) + 1 + (bmild ? 4 : 0) + 4;
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Dynamic shared memory of a launch at n_samples depths per ray, the
// stages of its weight ring, its landing slots, this build's weight route.
long long ray_wgmma_smem_bytes(int n_samples) {
  return (long long)rw_smem_bytes((RW_ROWS - 1) / n_samples + 2);
}
// the composited modes' consumer lanes at n_rays rays (2 x grid)
int ray_wgmma_composited_lanes(int n_rays) { return 2 * composited_grid(n_rays); }
int ray_wgmma_stages(int n_samples) { return ring_stages((RW_ROWS - 1) / n_samples + 2); }
int ray_wgmma_landing_slots() { return LANDS; }
int ray_wgmma_route() { return WQ; }
// registers a thread after setmaxnreg: a consumer's (1) or the producer's (0)
int ray_wgmma_registers(int consumer) { return consumer ? CONSUMER_REGS : PRODUCER_REGS; }

// The per-sample kernel's: its shared memory and ring stages, and the chunks
// of its stream (ops/ray_wgmma.sample_chunk_schedule).
long long mlp_wgmma_smem_bytes() { return (long long)rw_smem_bytes(0); }
int mlp_wgmma_stages() { return ring_stages(0); }
int mlp_wgmma_stream_chunks(int bmild) { return stream_chunks(bmild) + 1; }

// `scales`: null on the bf16 route, else the eight matrices' scales and
// enc_scale (mlp_body.cuh make_net); the matrices' own pointers serve the
// resident heads and wdir, the stream the rest. `composited`: out is [R, 8]
// fp32 (out_mode 0) and w [R, S] or null; dz is K1's constant step.
int ray_wgmma_render(const float* rays_o, const float* rays_d, const float* z, long long z_stride,
                     int n_rays, int n_samples, float near, float span, const void* wstream,
                     const void* const* weights, const void* const* scales, int Lp, int Ld,
                     int skip_pos, int bmild, int relu_sigma, int normalize_dirs, float band_scale,
                     int out_mode, int composited, float dz, float sentinel, float eps, void* out,
                     float* w, void* stream) {
  RwParams p;
  p.net = make_net(weights, scales, Lp, Ld, skip_pos, bmild, relu_sigma, normalize_dirs,
                   band_scale);
  p.wstream = static_cast<const unsigned char*>(wstream);
  p.rays_o = rays_o;
  p.rays_d = rays_d;
  p.z = z;
  p.z_stride = z_stride;
  p.pos = p.dirs = nullptr;
  p.out = out;
  p.w = composited ? w : nullptr;
  p.total = (long long)n_rays * n_samples;
  p.tiles = (p.total + RW_TILE - 1) / RW_TILE;
  p.n_rays = n_rays;
  p.S = n_samples;
  p.nr_max = (RW_ROWS - 1) / n_samples + 2;
  p.n_chunks = stream_chunks(bmild);
  p.n_small = N_SMALL_RAYS;
  p.out_mode = out_mode;
  const long long grid =
      composited ? composited_grid(n_rays) : (p.tiles < sm_count() ? p.tiles : sm_count());
  p.composited = composited ? 1 : 0;
  p.lanes = int(2 * grid);
  p.near = near;
  p.span = span;
  p.dz = dz;
  p.sentinel = sentinel;
  p.eps = eps;
  p.ring_off = ring_offset(p.nr_max);
  p.stages = ring_stages(p.nr_max);
  p.land_off = land_offset(p.nr_max);
  // the int8-compute skip layer holds three chunks at once
  if (p.stages < (WQ == WQ_INT8_COMPUTE ? 3 : 2) || !net_has_scales(p.net, WQ) ||
      n_samples < (z ? 1 : 2) || !net_fits(p.net) || out_mode < OUT_F32 || out_mode > OUT_PLANAR ||
      (composited && out_mode != OUT_F32) || n_rays < 0 || !wstream ||
      (bmild && (!p.net.wbn || !p.net.bbn)) || skip_pos < 1 || skip_pos > 7)
    return int(cudaErrorInvalidValue);
  if (p.total == 0) return int(cudaSuccess);
  if (p.tiles > 0x7fffffff) return int(cudaErrorInvalidValue);
  void (*kernel)(const RwParams) =
      composited ? (z ? ray_z_composite_wgmma_kernel : ray_composite_wgmma_kernel)
                 : (z ? ray_z_wgmma_kernel : ray_wgmma_kernel);
  const size_t smem = rw_smem_bytes(p.nr_max);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<unsigned(grid), RW_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

// The per-sample kernel (K4; K7 on the quantized builds): out[n] = (sigma,
// r, g, b) of pos[n], dirs[n] for n < N, fp32 [N, 4]. `wstream`: the
// per-sample stream, or one that begins with it (K5's); weights and scales
// as ray_wgmma_render's.
int mlp_wgmma_forward(const float* pos, const float* dirs, long long n, const void* wstream,
                      const void* const* weights, const void* const* scales, int Lp, int Ld,
                      int skip_pos, int bmild, int relu_sigma, int normalize_dirs,
                      float band_scale, float* out, void* stream) {
  RwParams p;
  p.net = make_net(weights, scales, Lp, Ld, skip_pos, bmild, relu_sigma, normalize_dirs,
                   band_scale);
  p.wstream = static_cast<const unsigned char*>(wstream);
  p.rays_o = p.rays_d = p.z = nullptr;
  p.z_stride = 0;
  p.pos = pos;
  p.dirs = dirs;
  p.out = out;
  p.w = nullptr;
  p.total = n;
  p.tiles = (n + RW_TILE - 1) / RW_TILE;
  p.n_rays = 0;
  p.composited = p.lanes = 0;
  p.dz = p.sentinel = p.eps = 0.f;
  p.S = 1;
  p.nr_max = 0;
  p.n_chunks = stream_chunks(bmild) + 1;
  p.n_small = N_SMALL_SAMPLES;
  p.out_mode = OUT_F32;
  p.near = p.span = 0.f;
  p.ring_off = ring_offset(0);
  p.stages = ring_stages(0);
  p.land_off = land_offset(0);
  if (p.stages < (WQ == WQ_INT8_COMPUTE ? 3 : 2) || !net_has_scales(p.net, WQ) || n < 0 ||
      !net_fits(p.net) || !wstream || !pos || !dirs || !out || (bmild && (!p.net.wbn || !p.net.bbn)) ||
      skip_pos < 1 || skip_pos > 7)
    return int(cudaErrorInvalidValue);
  if (n == 0) return int(cudaSuccess);
  if (p.tiles > 0x7fffffff) return int(cudaErrorInvalidValue);
  const size_t smem = rw_smem_bytes(0);
  cudaError_t err = cudaFuncSetAttribute(mlp_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long grid = p.tiles < sm_count() ? p.tiles : sm_count();
  mlp_wgmma_kernel<<<unsigned(grid), RW_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

// `blocks` blocks each stream `bytes` (a multiple of 32 KB) `reps` times.
int l2_stream_probe(const void* buf, long long bytes, int reps, int blocks, void* stream) {
  if (bytes <= 0 || bytes % CHUNK_BIG || reps < 1 || blocks < 1)
    return int(cudaErrorInvalidValue);
  const size_t smem = 1024 + size_t(PROBE_STAGES) * CHUNK_BIG + 2 * PROBE_STAGES * 8;
  cudaError_t err = cudaFuncSetAttribute(l2_probe_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  l2_probe_kernel<<<blocks, 64, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(buf), int(bytes / CHUNK_BIG), reps);
  return int(cudaGetLastError());
}

}  // extern "C"
