// Hopper building blocks shared by the kernels that run the NeRF MLP on
// warpgroup wgmma (ray_wgmma.cu: K1/K3; mlp_backward_wgmma.cu: K5): mbarriers
// and bulk copies, the wgmma forms (B K-major in the 128-byte swizzle; A from
// shared memory or from registers), the consumers' view of a weight ring, the
// position encoding of a row as bf16 pairs, and the epilogue that hands a
// layer's accumulators on as the next product's A fragments.
//
// They share the network's constants, its weights (Net, make_net) and the
// element a product sees of a matrix (weight_at). Weight routes (template
// parameter WQ, the -DNERF_WQ of ray_wgmma.cu's builds;
// nerf_tpu_torch/ops/quant.py has the plain versions):
// - WQ_BF16: bf16 matrices;
// - WQ_INT8, WQ_INT16 (the TPU kernels' `quant_w_dict`): the matrices are
//   int8 / int16 in global memory with one fp32 scale per output column, and
//   a product sees bf16(f32(q) * s[col]); the scalar heads dequantize the
//   same way;
// - WQ_INT8_COMPUTE (the TPU kernels' `_int8_mm` hook): layer 0, the trunk
//   layers and the skip product are s8 x s8 -> s32 products. The encoding
//   is quantized at a fixed scale, clip(rint(enc * (enc_scale[k] * 127)),
//   +-127); the bf16 activations per layer and row,
//   rint(a * (127 / max(max|a|, 1e-20))). The s32 result goes to fp32 as
//   (acc * ax[row]) * (s[col] * (1 / 127)), without ax for the encoding
//   products. The skip layer's two products carry different scales, so each
//   is scaled to fp32 before they are added. The heads, the bottleneck, the
//   color layers and the direction branch take WQ_INT8 (head_route).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int M = 128;          // rows (samples) per tile
constexpr int HID = 256;
constexpr int CH = 128;         // color layer width
constexpr int KPOS = 64;        // padded position-encoding width
constexpr int KDIR = 32;        // padded direction-encoding width
constexpr unsigned FULL = 0xffffffffu;

// weight routes
constexpr int WQ_BF16 = 0, WQ_INT8 = 1, WQ_INT16 = 2, WQ_INT8_COMPUTE = 3;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Waits for the phase of `bar` with the given parity to complete. A wait of
// more than 2^35 cycles (~17 s) traps, so a schedule that could never
// complete fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    if (clock64() - t0 > (1ll << 35)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// bytes from global to shared memory, completion counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
// the producer warpgroup's barrier, for threads that may reach it out of
// step within a warp
__device__ __forceinline__ void producer_sync(int id) {
  asm volatile("barrier.sync %0, 128;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving register reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major tile with the 128-byte
// swizzle: rows of 64 bf16 (128 bytes), 8-row groups 1024 bytes apart; the
// tile starts 1024-aligned. Adding 2 advances K by 16 (32 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// ---- the products (m64nNk16, bf16 in, fp32 accumulate; B K-major, no transpose) ----

__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d: the first 64 of an accumulator set of at least 64
template <int NA>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[NA], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  static_assert(NA >= 64, "m64n128 needs 64 accumulators a thread");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The consumers' view of the weight ring: acquire() waits for the next
// chunk and returns its shared address; release() hands the oldest chunk in
// use back to the producer (one arrival per warpgroup, by its first thread,
// after the products that read it have completed).
template <int STRIDE, int SLOTS>
struct RingT {
  uint32_t base, bars;   // full barriers at bars + 8 s, empty at bars + 8 (SLOTS + s)
  int stages, stage;
  uint32_t phase;
  int rel;
  __device__ __forceinline__ uint32_t acquire() {
    mbar_wait(bars + 8 * stage, phase);
    const uint32_t addr = base + stage * STRIDE;
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
    return addr;
  }
  __device__ __forceinline__ void release(bool leader) {
    if (leader) mbar_arrive(bars + 8 * (SLOTS + rel));
    if (++rel == stages) rel = 0;
  }
};

// d: the first 64 of an accumulator set of at least 64
template <int NA>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[NA], uint64_t da, uint64_t db, int scale_d) {
  static_assert(NA >= 64, "m64n128 needs 64 accumulators a thread");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n8(float (&d)[4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// encode_col on a point held as three scalars: the same
// operations, with the coordinate chosen by selects, not by an index into a
// local array
__device__ __forceinline__ float encode_xyz(float x0, float x1, float x2, int k, int L,
                                            float scale) {
  if (k < 3) return k == 0 ? x0 : (k == 1 ? x1 : x2);
  const int j = k - 3;
  if (j >= 6 * L) return 0.f;
  const int band = j / 6, w = j % 6, c = w % 3;
  const float phase = __fmul_rn(c == 0 ? x0 : (c == 1 ? x1 : x2), ldexpf(scale, band));
  return w < 3 ? sinf(phase) : cosf(phase);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Columns 32 H .. 32 H + 31 of a row's position encoding, as bf16 pairs:
// encode_xyz's values, but the phase of each (band, coordinate) whose sine
// and cosine both fall in this half is reduced once (sincosf). L < 0: a
// padding row, all zeros. Every index is known when compiled.
template <int H>
__device__ __forceinline__ void encode_half(float x0, float x1, float x2, int L, float scale,
                                            uint32_t (&out)[16]) {
  constexpr int BANDS = (KPOS - 3) / 6;       // the widest encoding KPOS holds
  float sv[BANDS][3], cv[BANDS][3];
#pragma unroll
  for (int b = 0; b < BANDS; ++b) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int cs = 3 + 6 * b + c, cc = cs + 3;      // columns of sin and cos
      const bool ns = cs >= 32 * H && cs < 32 * H + 32;
      const bool nc = cc >= 32 * H && cc < 32 * H + 32;
      sv[b][c] = 0.f;
      cv[b][c] = 0.f;
      if ((ns || nc) && b < L) {
        const float ph = __fmul_rn(c == 0 ? x0 : (c == 1 ? x1 : x2), ldexpf(scale, b));
        if (ns && nc)
          sincosf(ph, &sv[b][c], &cv[b][c]);
        else if (ns)
          sv[b][c] = sinf(ph);
        else
          cv[b][c] = cosf(ph);
      }
    }
  }
  float col[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int kk = 32 * H + k;
    if (kk < 3) {
      col[k] = L < 0 ? 0.f : (kk == 0 ? x0 : (kk == 1 ? x1 : x2));
    } else {
      const int j = kk - 3, b = j / 6, w = j % 6;
      col[k] = b >= BANDS ? 0.f : (w < 3 ? sv[b][w] : cv[b][w - 3]);
    }
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) out[k] = pack_bf16(col[2 * k], col[2 * k + 1]);
}
__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// Accumulator layout of m64nNk16 (per thread of warp w, g = lane / 4, q =
// lane % 4): acc[4j + e] is row 16w + g (e = 0, 1) or 16w + g + 8 (e = 2, 3),
// column 8j + 2q + (e & 1). The A fragment of k-step kk is a[kk] = {row g,
// cols 16kk + 2q..; row g + 8, same; row g, cols 16kk + 8 + 2q..; row g + 8,
// same}: block j of the accumulators is half j & 1 of k-step j / 2. So
// a[j / 2][2 (j & 1) + i] = bf16 pair of acc[4j + 2i], acc[4j + 2i + 1].
__device__ __forceinline__ void epilogue_to_a(const float (&acc)[128], uint32_t (&a)[16][4],
                                              const float* bias, int q, bool relu) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * q);
    float v0 = acc[4 * j] + b.x, v1 = acc[4 * j + 1] + b.y;
    float v2 = acc[4 * j + 2] + b.x, v3 = acc[4 * j + 3] + b.y;
    if (relu) {
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
      v2 = fmaxf(v2, 0.f);
      v3 = fmaxf(v3, 0.f);
    }
    a[j >> 1][(j & 1) * 2] = pack_bf16(v0, v1);
    a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(v2, v3);
  }
}

// acc = A @ W for a 256-wide layer: A in registers (the previous layer), W
// in four 64-row chunks from the ring; with `skip`, + enc @ wskip from one
// more chunk. One commit group per chunk, waited for before the chunk is
// released (a second group in flight made ptxas serialize the products and
// spill, and was slower on the H100).
template <typename Ring>
__device__ __forceinline__ void hidden_layer(float (&acc)[128], uint32_t (&a)[16][4], Ring& ring,
                                             bool leader, bool skip, uint64_t enc_desc) {
  fence_regs(acc);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    const uint64_t b = sw128_desc(ring.acquire());
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n256(acc, a[ch * 4 + kk], b + 2 * kk, (ch | kk) != 0);
    wgmma_commit();
    wgmma_wait<0>();
    ring.release(leader);
  }
  if (skip) {
    const uint64_t b = sw128_desc(ring.acquire());
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss_n256(acc, enc_desc + 2 * kk, b + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    ring.release(leader);
  }
  fence_regs(acc);
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

}  // namespace
