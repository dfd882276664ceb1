// The dequantize prologue of the Hopper MLP kernels on int8 and int16
// weights: the intN weight stream of a quantized network -> the bf16 stream
// of its dequantized weights, and the resident parameters the bf16 build of
// ray_wgmma.cu reads beside it, once a kernel call.
//
// Replaces the `dq` / `_TrunkView` half of `quant_w_dict`
// (nerf_tpu/ops/quant.py:273-300), which dequantizes every matrix inside
// VMEM per grid step of the TPU kernels `_ray_kernel`, `_ray_z_kernel` and
// `_quant_kernel` (K1, K3, K7 on quantized weights). A TPU grid step covers
// thousands of rows; a Hopper tile covers 128, so converting the network
// once a tile (as the producer warpgroup of ray_wgmma.cu's NERF_WQ = 1, 2
// builds did) converted the same 0.53 M weights 24,576 times in one K3
// launch of 16,384 rays x 192 samples. This kernel converts them once a
// call into scratch the wrapper allocates, which L2 then holds for the bf16
// build (ray_wgmma.cu, NERF_WQ = 0) that runs next.
// Wrapper, plain PyTorch version and the dispatch:
// nerf_tpu_torch/ops/dequant_stream.py; the streams' layout and chunk
// schedules: nerf_tpu_torch/ops/ray_wgmma.py.
//
// What bounds it: bytes. A call reads the intN stream (0.56 MB int8, 1.08
// MB int16, the reference network's ray stream) and writes the bf16 stream
// (1.05 MB) and 9 KB of resident parameters: ~1.6 MB int8, ~0.5 us at 3.35
// TB/s, so in practice the launch floor.
//
// Design: the input and the output share one layout. A dequantize chunk of
// the stream is the bf16 chunk's shared-memory image (K-major, 128-byte
// swizzle) element for element in intN, followed by one fp32 scale per
// image row, and an image row is one output column. So each 16-byte piece
// of the bf16 image is bf16(f32(q) * s[row]) of the 8 (int8) or 16 (int16)
// bytes at the same position of the intN image: a flat map, one 16-byte
// store a thread, neighbouring threads on neighbouring addresses, with no
// re-swizzle. The chunks of 256 columns come first, then those of 128 (wc0
// and, on the per-sample stream, wdir), as ops/ray_wgmma.chunk_schedule
// orders them. The threads past the stream's pieces write the resident
// wsig [256], wc1 [128, 3] and wdir [32, 128], one value each, in that
// order into one bf16 buffer.
//
// Arithmetic: bf16(f32(q) * s[col]), round to nearest even: the integer to
// float by the exact construction ray_wgmma.cu's producer uses (the bits of
// 2^23 + (q + 2^(b-1)), minus that offset), the product by __fmul_rn; the
// resident values by ray_wgmma.cu's weight_at (wgmma_common.cuh). The values are
// those the quantized builds put in front of their tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK_K = 64;       // weight rows of a chunk (one image row: 64 values)
constexpr int HID = 256, CH = 128;
constexpr int DIR_ROWS = 32;      // the direction encoding's padded width
constexpr int VEC_BIG = HID * CHUNK_K / 8;     // 16-byte output pieces of a 256-column chunk
constexpr int VEC_SMALL = CH * CHUNK_K / 8;    // of a 128-column chunk
// the resident parameters, in values: wsig, then wc1, then wdir
constexpr int R_WC1 = HID, R_WDIR = R_WC1 + CH * 3, RESIDENT = R_WDIR + DIR_ROWS * CH;

// bytes of a dequantize chunk of n columns: its intN image, then n scales
template <int ES>
__host__ __device__ constexpr int conv_bytes(int n) { return n * (CHUNK_K * ES + 4); }

struct Params {
  const unsigned char* in;   // the intN stream
  uint4* out;                // the bf16 stream, 16 bytes a piece
  __nv_bfloat16* res;        // the resident parameters [RESIDENT]
  const void* wsig;          // int8 or int16, with their fp32 scales
  const float* wsig_s;
  const void* wc1;
  const float* wc1_s;
  const void* wdir;
  const float* wdir_s;
  int n_big, n_small;        // chunks of 256 and of 128 columns
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
// f32(q) from the byte(s) `sel` picks of the offset-binary word x: exact
__device__ __forceinline__ float q_at(uint32_t x, uint32_t sel, float bias) {
  return __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, sel)), bias);
}
// bf16(f32(q) * s) of the intN values of a word, as bf16 pairs
template <int ES>
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

template <int ES>
__global__ void __launch_bounds__(THREADS) dequant_stream_kernel(const __grid_constant__ Params p) {
  typedef typename std::conditional<ES == 1, uint2, uint4>::type Word;   // 8 values in
  typedef typename std::conditional<ES == 1, int8_t, int16_t>::type Q;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int big = p.n_big * VEC_BIG, pieces = big + p.n_small * VEC_SMALL;
  if (i < pieces) {
    int chunk, local, cols;
    size_t base;
    if (i < big) {
      chunk = i / VEC_BIG;
      local = i - chunk * VEC_BIG;
      cols = HID;
      base = size_t(chunk) * conv_bytes<ES>(HID);
    } else {
      chunk = (i - big) / VEC_SMALL;
      local = i - big - chunk * VEC_SMALL;
      cols = CH;
      base = size_t(p.n_big) * conv_bytes<ES>(HID) + size_t(chunk) * conv_bytes<ES>(CH);
    }
    const unsigned char* src = p.in + base;
    const Word w = reinterpret_cast<const Word*>(src)[local];
    const float s = reinterpret_cast<const float*>(src + cols * CHUNK_K * ES)[local >> 3];
    uint32_t o[4];
    if constexpr (ES == 1) {
      dequant_word<1>(w.x, s, o);
      dequant_word<1>(w.y, s, o + 2);
    } else {
      dequant_word<2>(w.x, s, o);
      dequant_word<2>(w.y, s, o + 1);
      dequant_word<2>(w.z, s, o + 2);
      dequant_word<2>(w.w, s, o + 3);
    }
    p.out[i] = make_uint4(o[0], o[1], o[2], o[3]);
  } else if (i - pieces < RESIDENT) {
    const int r = i - pieces;
    float q, s;
    if (r < R_WC1) {
      q = float(static_cast<const Q*>(p.wsig)[r]);
      s = p.wsig_s[0];
    } else if (r < R_WDIR) {
      q = float(static_cast<const Q*>(p.wc1)[r - R_WC1]);
      s = p.wc1_s[(r - R_WC1) % 3];
    } else {
      q = float(static_cast<const Q*>(p.wdir)[r - R_WDIR]);
      s = p.wdir_s[(r - R_WDIR) % CH];
    }
    p.res[r] = __float2bfloat16_rn(__fmul_rn(q, s));
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// The values a call writes besides the stream (wsig, wc1, wdir).
int dequant_stream_resident() { return RESIDENT; }

// `in`: the intN stream of n_big 256-column and then n_small 128-column
// dequantize chunks, `bits` 8 or 16, 16-byte aligned; `out`: its bf16
// stream, (n_big * 256 + n_small * 128) * 64 values, 16-byte aligned;
// `resident`: wsig_q, wsig_s, wc1_q, wc1_s, wdir_q, wdir_s; `res`: RESIDENT
// bf16 values.
int dequant_stream(const void* in, int bits, int n_big, int n_small,
                   const void* const* resident, void* out, void* res, void* stream) {
  if (!in || !out || !res || !resident || (bits != 8 && bits != 16) || n_big < 0 ||
      n_small < 0 || (reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) % 16)
    return int(cudaErrorInvalidValue);
  Params p;
  p.in = static_cast<const unsigned char*>(in);
  p.out = static_cast<uint4*>(out);
  p.res = static_cast<__nv_bfloat16*>(res);
  p.wsig = resident[0];
  p.wsig_s = static_cast<const float*>(resident[1]);
  p.wc1 = resident[2];
  p.wc1_s = static_cast<const float*>(resident[3]);
  p.wdir = resident[4];
  p.wdir_s = static_cast<const float*>(resident[5]);
  p.n_big = n_big;
  p.n_small = n_small;
  for (int k = 0; k < 6; ++k)
    if (!resident[k]) return int(cudaErrorInvalidValue);
  const long long threads = (long long)n_big * VEC_BIG + (long long)n_small * VEC_SMALL + RESIDENT;
  if (threads > 0x7fffffffll) return int(cudaErrorInvalidValue);
  const unsigned blocks = unsigned((threads + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 8)
    dequant_stream_kernel<1><<<blocks, THREADS, 0, s>>>(p);
  else
    dequant_stream_kernel<2><<<blocks, THREADS, 0, s>>>(p);
  return int(cudaGetLastError());
}

}  // extern "C"
