// Mip-NeRF 360's NeRF pass (models/mip360.py, the `mip360` variant's last
// level): its interval encoding, its 8 x 1,024 trunk with the skip after
// layer 4, the density head, the bottleneck and the color layer, on
// warpgroup wgmma, for Hopper (sm_90a). It replaces no TPU kernel: the JAX
// package has no Mip-NeRF 360. Wrapper, plain version (nerf_mip360_plain)
// and the layouts: nerf_tpu_torch/ops/mip360_kernel.py.
//
// What bounds it: tensor-core operations. An interval is 8,668,544
// multiply-adds, 87% of a frame's; at 32 intervals a 16,384-ray chunk is
// M = 524,288 rows, and each trunk layer a product of M x 1,024 x 1,024 (K
// 504 + 1,024 at the skip), ~0.5 KFLOP a byte of activations moved: far
// above the card's 295 FLOP/B line.
//
// Why not the ray kernels' body (ray_wgmma.cu), which keeps a layer's output
// in the consumers' registers: at width 1,024 a 64-row tile's fp32
// accumulators are 256 KB, the SM's whole register file, and its bf16
// activations with the encoding, (1,024 + 512) x 64 x 2 = 196 KB, leave no
// room for a weight ring within 227 KB. So each layer is its own persistent
// GEMM, its activations in device memory (L2 holds the weights, 17 MB in
// bf16, and the rows a wave of blocks shares):
// - activations are bf16 in the image wgmma's A descriptor reads: a tile of
//   128 rows and 64 features is one 16 KB block, rows of 128 bytes, 8-row
//   groups 1 KB apart, the 16-byte pieces of row r at position piece ^ (r %
//   8) (the 128-byte swizzle); a tensor [M, K] is [M / 128][K / 64] such
//   blocks. Every kernel here writes that image, so a producer lands a
//   chunk of A by one bulk copy, as it lands the weights, which the host
//   lays out the same way (ops/ray_wgmma.py's slab images);
// - mip360_encode_kernel: one thread a row and 64-feature chunk (a warp's
//   threads share the chunk, so the basis's index is uniform): the row's
//   contracted Gaussian (mip360.cuh), its 504 features in the kernels' pair
//   order (mip360.cuh; the rows of w0 and of the skip layer's encoding part
//   are laid out to match), K padded to 512;
// - mip360_dense_wgmma_kernel: one block an SM walking 128 x N tiles (N 256,
//   128 for the color layer), the column tiles of a row tile in a row so the
//   wave re-reads A from L2; a producer thread lands A (16 KB) and B (32 KB)
//   a K step by cp.async.bulk into a ring of four stages (full and empty
//   mbarriers); two consumer warpgroups of 64 rows each run m64nNk16
//   products from shared memory, one K step in flight behind the next, the
//   accumulators in registers (setmaxnreg: 232 a consumer thread, 40 the
//   producer's, whose tile walk keeps more addresses than 24 hold). The skip
//   layer reads its K steps from two images, h (16 steps) then the encoding
//   (8). The epilogue, by template:
//   - RELU (trunk): bf16(relu(acc + b)) into the next layer's image;
//   - BOTTLENECK: bf16(acc + b) into the bottleneck's image, and beside it an
//     m64n8k16 product of the same A with wsig (column 0 of an 8-column
//     slab) for density softplus(acc + bsig + density_bias), one fp32 a row
//     into raw[:, 0];
//   - COLOR: c = bf16(relu(acc + bc0 + cdir[ray])), then rgb =
//     sigmoid(c . wc1 + bc1) * rgb_scale - rgb_padding, the three dot
//     products summed across the quad by shuffles, into raw[:, 1:4];
// - mip360_dir_kernel: the direction term once a ray, cdir = bf16(dir_enc(d /
//   |d|)) @ wdir in fp32 (27 x 128), for the color epilogue.
//
// Arithmetic contract (the plain version's): bf16 products with fp32
// accumulation; the fp32 bias (and the direction term) added before the
// bf16 rounding; the encoding in fp32 without FMA (mip360.cuh), rounded to
// bf16 once. The sums run in another order than the plain version's, so the
// two agree to bf16's rounding, not bit for bit.

#include "wgmma_common.cuh"
#include "mip360.cuh"

namespace {

constexpr int G_THREADS = 384;             // producer + two consumer warpgroups
constexpr int G_TILE = 128;                // rows a tile
constexpr int A_CHUNK = G_TILE * 128;      // 16 KB: 128 rows x 64 bf16, one K step of A
constexpr int G_STAGES = 4;
constexpr int ENC_CHUNKS = 8;              // the encoding: K 512
constexpr int MAX_BASIS = 32;
constexpr int EPI_RELU = 0, EPI_BOTTLENECK = 1, EPI_COLOR = 2;
constexpr int COLOR_W = 128;               // the color layer's width

__host__ __device__ constexpr int tile_cols(int epi) { return epi == EPI_COLOR ? COLOR_W : 256; }
__host__ __device__ constexpr int b_bytes(int epi) { return tile_cols(epi) * 128; }
__host__ __device__ constexpr int d_bytes(int epi) { return epi == EPI_BOTTLENECK ? 1024 : 0; }
__host__ __device__ constexpr int stage_bytes(int epi) {
  return A_CHUNK + b_bytes(epi) + d_bytes(epi);
}
__host__ __device__ constexpr int dense_smem(int epi) {
  return 1024 + G_STAGES * stage_bytes(epi) + 2 * G_STAGES * 8;
}

struct EncParams {
  const float* rays_o;     // [R, 3]
  const float* rays_d;
  const float* t;          // metric edges [R, S + 1], row stride t_stride
  long long t_stride;
  long long rows, rows_pad;   // R * S, and rounded up to the tile
  int S, n_deg, n_basis;
  float radius;
  float basis[3 * MAX_BASIS];   // [3][n_basis], row-major
  unsigned char* out;      // the encoding's image, ENC_CHUNKS chunks a tile
};

struct DenseParams {
  const unsigned char* a1;   // A's image: kc1 K steps a tile from a1, then kc2 from a2
  const unsigned char* a2;
  int kc1, kc2;
  const unsigned char* b;    // B's slab images [n_tiles][kc1 + kc2][b_bytes]
  const unsigned char* d;    // BOTTLENECK: wsig's 8-column slab images [kc1][1 KB]
  const float* bias;         // [n_tiles * N] (COLOR: bc0 [128])
  unsigned char* out;        // RELU, BOTTLENECK: the output's image, kco K steps a tile
  int kco;
  int m_tiles, n_tiles;
  long long rows;            // rows that are written to raw
  int S;                     // COLOR: intervals a ray
  float* raw;                // [rows, 4] fp32: (density, r, g, b)
  const float* bsig;
  float density_bias;
  const float* cdir;         // COLOR: [R, 128] fp32
  const float* wc1;          // [128, 3] fp32 (the bf16 weights' values)
  const float* bc1;          // [3]
  float rgb_scale, rgb_padding;
};

// ---- the encoder ----------------------------------------------------------

__global__ void __launch_bounds__(256) mip360_encode_kernel(const __grid_constant__ EncParams p) {
  const long long total = p.rows_pad * ENC_CHUNKS;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < total;
       i += (long long)gridDim.x * 256) {
    const int kc = int(i / p.rows_pad);   // the same for a warp: rows_pad is a multiple of 128
    const long long n = i - (long long)kc * p.rows_pad;
    const bool valid = n < p.rows;
    float m[3] = {0.f, 0.f, 0.f}, c[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (valid) {
      const long long r = n / p.S;
      const int s = int(n - r * p.S);
      const float* tr = p.t + r * p.t_stride;
      gaussian_360(p.rays_o + r * 3, p.rays_d + r * 3, tr[s], tr[s + 1], p.radius, m, c);
    }
    const int rr = int(n & (G_TILE - 1));
    unsigned char* dst = p.out + ((n >> 7) * ENC_CHUNKS + kc) * (long long)A_CHUNK +
                         (rr >> 3) * 1024 + (rr & 7) * 128;
    Ipe360Run run;
    run.start(32 * kc, p.n_deg);   // the chunk's 32 pairs
#pragma unroll 1
    for (int pc = 0; pc < 8; ++pc)
      *reinterpret_cast<uint4*>(dst + ((pc ^ (rr & 7)) << 4)) =
          run.next4(m, c, p.basis, p.n_basis, p.n_deg, valid);
  }
}

// ---- the direction term ---------------------------------------------------

// Column k of the published pos_enc of a unit direction: [v, sin(2^l v),
// sin(2^l v + pi / 2)], degree-major, L degrees
__device__ __forceinline__ float dir_feature(const float (&v)[3], int k, int L) {
  if (k < 3) return v[k];
  const int j = k - 3, i = j % (3 * L), band = i / 3, c = i % 3;
  float ph = __fmul_rn(v[c], __int_as_float((127 + band) << 23));
  if (j >= 3 * L) ph = __fadd_rn(ph, M360_HALF_PI);
  return sinf(ph);
}

// One block a ray: cdir[r] = bf16(dir_enc(d / |d|)) @ wdir, fp32 sums in k order
__global__ void __launch_bounds__(COLOR_W) mip360_dir_kernel(const float* __restrict__ rays_d,
                                                             const float* __restrict__ wdir,
                                                             int n_rays, int L,
                                                             float* __restrict__ cdir) {
  __shared__ float enc[64];
  const int kdir = 3 + 6 * L;
  for (int r = blockIdx.x; r < n_rays; r += gridDim.x) {
    __syncthreads();
    if (threadIdx.x < kdir) {
      const float dx = rays_d[r * 3], dy = rays_d[r * 3 + 1], dz = rays_d[r * 3 + 2];
      const float nrm =
          sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
      const float v[3] = {__fdiv_rn(dx, nrm), __fdiv_rn(dy, nrm), __fdiv_rn(dz, nrm)};
      enc[threadIdx.x] = __bfloat162float(__float2bfloat16_rn(dir_feature(v, threadIdx.x, L)));
    }
    __syncthreads();
    float sum = 0.f;
    for (int k = 0; k < kdir; ++k) sum = fmaf(enc[k], wdir[k * COLOR_W + threadIdx.x], sum);
    cdir[(long long)r * COLOR_W + threadIdx.x] = sum;
  }
}

// ---- the layers -----------------------------------------------------------

template <int EPI>
__device__ __forceinline__ void dense_producer(const DenseParams& p, uint32_t base, uint32_t bars) {
  constexpr int STAGE = stage_bytes(EPI), BB = b_bytes(EPI), DB = d_bytes(EPI);
  const int kc_all = p.kc1 + p.kc2, tiles = p.m_tiles * p.n_tiles;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long mt = tile / p.n_tiles;
    const int nt = tile % p.n_tiles;
    for (int kc = 0; kc < kc_all; ++kc) {
      const uint32_t st = base + stage * STAGE, full = bars + 8 * stage;
      mbar_wait(bars + 8 * (G_STAGES + stage), phase ^ 1);
      mbar_expect_tx(full, STAGE);
      const unsigned char* a = kc < p.kc1 ? p.a1 + (mt * p.kc1 + kc) * A_CHUNK
                                          : p.a2 + (mt * p.kc2 + (kc - p.kc1)) * A_CHUNK;
      bulk_load(st, a, A_CHUNK, full);
      bulk_load(st + A_CHUNK, p.b + ((long long)nt * kc_all + kc) * BB, BB, full);
      if constexpr (DB > 0) bulk_load(st + A_CHUNK + BB, p.d + (long long)kc * DB, DB, full);
      if (++stage == G_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// The byte of row r (of a 128-row tile), column col (of a 64-wide K step)
// in its 16 KB image block
__device__ __forceinline__ int image_offset(int r, int col) {
  return (r >> 3) * 1024 + (r & 7) * 128 + ((((col >> 3) & 7) ^ (r & 7)) << 4) + (col & 7) * 2;
}

template <int EPI>
__device__ __forceinline__ void dense_consumer(const DenseParams& p, uint32_t base, uint32_t bars,
                                               int c) {
  constexpr int STAGE = stage_bytes(EPI), BB = b_bytes(EPI), NW = tile_cols(EPI);
  const int t = threadIdx.x - 128 * (c + 1);
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const bool leader = t == 0;
  RingT<STAGE, G_STAGES> ring{base, bars, G_STAGES, 0, 0u, 0};
  float acc[128];
  float accd[4] = {0.f, 0.f, 0.f, 0.f};
  const int kc_all = p.kc1 + p.kc2, tiles = p.m_tiles * p.n_tiles;
  const int r0 = 64 * c + 16 * warp + g, r1 = r0 + 8;   // this thread's rows of the tile
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long mt = tile / p.n_tiles;
    const int nt = tile % p.n_tiles;
    fence_regs(acc);
    fence_regs(accd);
    wgmma_fence();
    for (int kc = 0; kc < kc_all; ++kc) {
      const uint32_t st = ring.acquire();
      const uint64_t ad = sw128_desc(st + c * (A_CHUNK / 2));
      const uint64_t bd = sw128_desc(st + A_CHUNK);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (NW == 256)
          wgmma_ss_n256(acc, ad + 2 * kk, bd + 2 * kk, (kc | kk) != 0);
        else
          wgmma_ss_n128(acc, ad + 2 * kk, bd + 2 * kk, (kc | kk) != 0);
        if constexpr (EPI == EPI_BOTTLENECK)
          wgmma_ss_n8(accd, ad + 2 * kk, sw128_desc(st + A_CHUNK + BB) + 2 * kk, (kc | kk) != 0);
      }
      wgmma_commit();
      // one K step in flight: the step before is done, its stage goes back
      wgmma_wait<1>();
      if (kc > 0) ring.release(leader);
    }
    wgmma_wait<0>();
    ring.release(leader);
    fence_regs(acc);
    fence_regs(accd);

    const long long row0 = mt * G_TILE + r0, row1 = mt * G_TILE + r1;
    if constexpr (EPI == EPI_COLOR) {
      const long long ray0 = row0 < p.rows ? row0 / p.S : 0, ray1 = row1 < p.rows ? row1 / p.S : 0;
      const float* cd0 = p.cdir + ray0 * COLOR_W;
      const float* cd1 = p.cdir + ray1 * COLOR_W;
      float s0[3] = {0.f, 0.f, 0.f}, s1[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < COLOR_W / 8; ++j) {
        const int col = 8 * j + 2 * q;
        const float2 b = __ldg(reinterpret_cast<const float2*>(p.bias + col));
        const float2 d0 = __ldg(reinterpret_cast<const float2*>(cd0 + col));
        const float2 d1 = __ldg(reinterpret_cast<const float2*>(cd1 + col));
        const float v00 = __bfloat162float(__float2bfloat16_rn(fmaxf(acc[4 * j] + b.x + d0.x, 0.f)));
        const float v01 = __bfloat162float(__float2bfloat16_rn(fmaxf(acc[4 * j + 1] + b.y + d0.y, 0.f)));
        const float v10 = __bfloat162float(__float2bfloat16_rn(fmaxf(acc[4 * j + 2] + b.x + d1.x, 0.f)));
        const float v11 = __bfloat162float(__float2bfloat16_rn(fmaxf(acc[4 * j + 3] + b.y + d1.y, 0.f)));
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float w0 = __ldg(p.wc1 + col * 3 + k), w1 = __ldg(p.wc1 + (col + 1) * 3 + k);
          s0[k] = fmaf(v01, w1, fmaf(v00, w0, s0[k]));
          s1[k] = fmaf(v11, w1, fmaf(v10, w0, s1[k]));
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s0[k] += __shfl_xor_sync(FULL, s0[k], 1);
        s1[k] += __shfl_xor_sync(FULL, s1[k], 1);
        s0[k] += __shfl_xor_sync(FULL, s0[k], 2);
        s1[k] += __shfl_xor_sync(FULL, s1[k], 2);
        const float bk = __ldg(p.bc1 + k);
        s0[k] = __fsub_rn(__fmul_rn(1.f / (1.f + expf(-(s0[k] + bk))), p.rgb_scale), p.rgb_padding);
        s1[k] = __fsub_rn(__fmul_rn(1.f / (1.f + expf(-(s1[k] + bk))), p.rgb_scale), p.rgb_padding);
      }
      // lane q = 0 of the quad writes row r0, q = 1 row r1
      const long long n = q ? row1 : row0;
      if (q < 2 && n < p.rows) {
        float* o = p.raw + n * 4;
        o[1] = q ? s1[0] : s0[0];
        o[2] = q ? s1[1] : s0[1];
        o[3] = q ? s1[2] : s0[2];
      }
    } else {
      unsigned char* img = p.out + (mt * p.kco + nt * (NW / 64)) * A_CHUNK;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int col = 8 * j + 2 * q;   // of the tile
        const float2 b = __ldg(reinterpret_cast<const float2*>(p.bias + nt * NW + col));
        float v0 = acc[4 * j] + b.x, v1 = acc[4 * j + 1] + b.y;
        float v2 = acc[4 * j + 2] + b.x, v3 = acc[4 * j + 3] + b.y;
        if constexpr (EPI == EPI_RELU) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
          v2 = fmaxf(v2, 0.f);
          v3 = fmaxf(v3, 0.f);
        }
        unsigned char* blk = img + (j >> 3) * A_CHUNK;
        *reinterpret_cast<uint32_t*>(blk + image_offset(r0, col)) = pack_bf16(v0, v1);
        *reinterpret_cast<uint32_t*>(blk + image_offset(r1, col)) = pack_bf16(v2, v3);
      }
      if constexpr (EPI == EPI_BOTTLENECK) {
        // column 0 of the density product: q = 0 holds it for rows r0, r1
        if (q == 0) {
          const float bs = __ldg(p.bsig);
          if (row0 < p.rows)
            p.raw[row0 * 4] = softplus_360(__fadd_rn(__fadd_rn(accd[0], bs), p.density_bias));
          if (row1 < p.rows)
            p.raw[row1 * 4] = softplus_360(__fadd_rn(__fadd_rn(accd[2], bs), p.density_bias));
        }
      }
    }
  }
}

template <int EPI>
__device__ __forceinline__ void dense_body(const DenseParams& p, unsigned char* smem_raw) {
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(sm), bars = smem_u32(sm + G_STAGES * stage_bytes(EPI));
  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                 // the producer's expect_tx
      mbar_init(bars + 8 * (G_STAGES + s), 2);    // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) dense_producer<EPI>(p, base, bars);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    dense_consumer<EPI>(p, base, bars, threadIdx.x / 128 - 1);
  }
}

template <int EPI>
__global__ void __launch_bounds__(G_THREADS, 1) mip360_dense_wgmma_kernel(const __grid_constant__ DenseParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  dense_body<EPI>(p, smem_raw);
}

template <int EPI>
int launch_dense(const DenseParams& p, cudaStream_t stream) {
  const int smem = dense_smem(EPI);
  cudaError_t err = cudaFuncSetAttribute(mip360_dense_wgmma_kernel<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const long long tiles = (long long)p.m_tiles * p.n_tiles;
  const int grid = tiles < sm_count() ? int(tiles) : sm_count();
  mip360_dense_wgmma_kernel<EPI><<<grid, G_THREADS, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// The layout the wrapper shares: rows a tile, the encoding's K steps, the ring's stages, a layer kernel's dynamic shared
// memory (epi: 0 trunk, 1 bottleneck, 2 color)
int mip360_tile_rows() { return G_TILE; }
int mip360_enc_chunks() { return ENC_CHUNKS; }
int mip360_stages() { return G_STAGES; }
long long mip360_dense_smem(int epi) {
  return epi == EPI_RELU ? dense_smem(EPI_RELU)
                         : epi == EPI_BOTTLENECK ? dense_smem(EPI_BOTTLENECK) : dense_smem(EPI_COLOR);
}

// The encoding of the rows n = r S + s < rows of intervals [t[r, s], t[r, s +
// 1]] into out, rows_pad / 128 tiles of ENC_CHUNKS image blocks; rows past
// `rows` are zeros. basis: [3][n_basis] fp32.
int mip360_encode(const float* rays_o, const float* rays_d, const float* t, long long t_stride,
                  int n_rays, int S, float radius, const float* basis, int n_basis, int n_deg,
                  void* out, long long rows_pad, void* stream) {
  EncParams p;
  p.rays_o = rays_o;
  p.rays_d = rays_d;
  p.t = t;
  p.t_stride = t_stride;
  p.rows = (long long)n_rays * S;
  p.rows_pad = rows_pad;
  p.S = S;
  p.n_deg = n_deg;
  p.n_basis = n_basis;
  p.radius = radius;
  p.out = static_cast<unsigned char*>(out);
  if (S < 1 || n_rays < 0 || n_basis < 1 || n_basis > MAX_BASIS || n_deg < 1 ||
      2 * n_basis * n_deg > ENC_CHUNKS * 64 || rows_pad < p.rows || rows_pad % G_TILE || !out)
    return int(cudaErrorInvalidValue);
  for (int i = 0; i < 3 * MAX_BASIS; ++i) p.basis[i] = i < 3 * n_basis ? basis[i] : 0.f;
  if (rows_pad == 0) return int(cudaSuccess);
  const long long threads = rows_pad * ENC_CHUNKS;
  const long long want = (threads + 255) / 256, cap = 16LL * sm_count();
  mip360_encode_kernel<<<unsigned(want < cap ? want : cap), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

// A trunk layer: out = bf16(relu(A @ W + b)), A from a1 (kc1 K steps a tile)
// and a2 (kc2, may be 0), W's slab images [n_tiles][kc1 + kc2][32 KB], out
// with n_tiles * 4 K steps a tile.
int mip360_dense(const void* a1, int kc1, const void* a2, int kc2, const void* w, const float* bias,
                 int n_tiles, int m_tiles, void* out, void* stream) {
  DenseParams p = {};
  p.a1 = static_cast<const unsigned char*>(a1);
  p.a2 = static_cast<const unsigned char*>(a2);
  p.kc1 = kc1;
  p.kc2 = kc2;
  p.b = static_cast<const unsigned char*>(w);
  p.bias = bias;
  p.out = static_cast<unsigned char*>(out);
  p.kco = 4 * n_tiles;
  p.m_tiles = m_tiles;
  p.n_tiles = n_tiles;
  if (kc1 < 1 || kc2 < 0 || (kc2 && !a2) || !a1 || !w || !bias || !out || n_tiles < 1 || m_tiles < 0)
    return int(cudaErrorInvalidValue);
  if (m_tiles == 0) return int(cudaSuccess);
  return launch_dense<EPI_RELU>(p, static_cast<cudaStream_t>(stream));
}

// The heads from h (kc K steps a tile): the bottleneck bf16(h @ wbn + bbn)
// into out (4 K steps a tile), and density softplus(h . wsig + bsig +
// density_bias) into raw[n, 0] for n < rows. wbn: slab images [kc][32 KB];
// wsig: 8-column slab images [kc][1 KB], wsig in column 0.
int mip360_bottleneck(const void* h, int kc, const void* wbn, const float* bbn, const void* wsig,
                      const float* bsig, float density_bias, int m_tiles, long long rows,
                      void* out, float* raw, void* stream) {
  DenseParams p = {};
  p.a1 = static_cast<const unsigned char*>(h);
  p.kc1 = kc;
  p.b = static_cast<const unsigned char*>(wbn);
  p.d = static_cast<const unsigned char*>(wsig);
  p.bias = bbn;
  p.out = static_cast<unsigned char*>(out);
  p.kco = 4;
  p.m_tiles = m_tiles;
  p.n_tiles = 1;
  p.rows = rows;
  p.raw = raw;
  p.bsig = bsig;
  p.density_bias = density_bias;
  if (kc < 1 || !h || !wbn || !bbn || !wsig || !bsig || !out || !raw || m_tiles < 0 ||
      rows > (long long)m_tiles * G_TILE)
    return int(cudaErrorInvalidValue);
  if (m_tiles == 0) return int(cudaSuccess);
  return launch_dense<EPI_BOTTLENECK>(p, static_cast<cudaStream_t>(stream));
}

// The direction term of each ray: cdir [R, 128] = bf16(dir_enc(d / |d|)) @
// wdir, wdir [3 + 6 L, 128] fp32 (the bf16 weights' values)
int mip360_dir(const float* rays_d, const float* wdir, int n_rays, int L, float* cdir,
               void* stream) {
  if (n_rays < 0 || L < 0 || 3 + 6 * L > 64 || !rays_d || !wdir || !cdir)
    return int(cudaErrorInvalidValue);
  if (n_rays == 0) return int(cudaSuccess);
  const int cap = 16 * sm_count();
  mip360_dir_kernel<<<n_rays < cap ? n_rays : cap, COLOR_W, 0, static_cast<cudaStream_t>(stream)>>>(
      rays_d, wdir, n_rays, L, cdir);
  return int(cudaGetLastError());
}

// The color layer and rgb from the bottleneck b (4 K steps a tile): raw[n,
// 1:4] for n < rows; wc0: slab images [4][16 KB] of its first 256 rows.
int mip360_color(const void* b, const void* wc0, const float* bc0, const float* cdir, int S,
                 const float* wc1, const float* bc1, float rgb_scale, float rgb_padding,
                 int m_tiles, long long rows, float* raw, void* stream) {
  DenseParams p = {};
  p.a1 = static_cast<const unsigned char*>(b);
  p.kc1 = 4;
  p.b = static_cast<const unsigned char*>(wc0);
  p.bias = bc0;
  p.cdir = cdir;
  p.S = S;
  p.wc1 = wc1;
  p.bc1 = bc1;
  p.rgb_scale = rgb_scale;
  p.rgb_padding = rgb_padding;
  p.m_tiles = m_tiles;
  p.n_tiles = 1;
  p.rows = rows;
  p.raw = raw;
  if (!b || !wc0 || !bc0 || !cdir || S < 1 || !wc1 || !bc1 || !raw || m_tiles < 0 ||
      rows > (long long)m_tiles * G_TILE)
    return int(cudaErrorInvalidValue);
  if (m_tiles == 0) return int(cudaSuccess);
  return launch_dense<EPI_COLOR>(p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
