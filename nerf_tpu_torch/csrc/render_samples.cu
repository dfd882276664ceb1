// Fused ray kernels: samples along each ray + the whole NeRF MLP, and
// optionally the volume rendering of those samples, on the WMMA body of
// mlp_body.cuh. Every form and mode, on every weight route, runs on the
// Hopper kernels of ray_wgmma.cu (warpgroup wgmma, weights streamed by a
// producer warpgroup, persistent blocks; the composited modes with whole
// rays per consumer warpgroup); the entries here are kept built and are
// timed beside them, but no wrapper sends a launch to them unless asked
// (`library=`).
//
// Replaces the Pallas TPU kernels of nerf_tpu/ops/render_kernel.py:
// - ray_kernel: `_ray_kernel` (uniform depths, `fused_render_samples`);
// - ray_z_kernel: `_ray_z_kernel` (per-ray depths z [R, S] read from memory,
//   `_zvals_forward` -> `fused_render_zvals_raw`);
// - ray_composite_kernel / ray_z_composite_kernel: their `composited=True`
//   modes (`_composite_flat` + `_segmented_cumsum_excl`), which write per ray
//   (r, g, b, depth, acc, 0, 0, 0) and optionally the weights [R, S].
// Plain PyTorch twins and wrappers: nerf_tpu_torch/ops/render_kernel.py;
// weight layout: ops/mlp_kernel.py. The MLP on a tile (products, epilogues,
// heads) is mlp_body.cuh, shared with the per-sample kernels.
//
// What bounds it: tensor-core operations. Per sample the MLP is ~0.52 M
// multiply-adds (8 x 256 trunk, skip, heads) against 24 bytes of ray input
// and 16 bytes of output, about 25,000 operations per byte moved.
//
// Design (simple first; ray_wgmma.cu has the Hopper design that replaced
// it):
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
//
// Raw output forms (the TPU kernels' `raw_dtype` and `_write_planar`): the
// interleaved (sigma, r, g, b) per sample in fp32 or rounded to bf16, or
// four fp32 planes [R, S]. A row's flat index n = ray * S + s is also its
// index in a plane, so the planar form is four coalesced stores a thread of
// the same values: the TPU kernel's one-hot scatter product has no
// counterpart.
//
// Weight routes: this source is built once per route of the shared body
// (-DNERF_WQ=0..3, see mlp_body.cuh): bf16 weights; int8 or int16 weights
// dequantized as they are staged (the TPU kernels' `_weights_for` ->
// `quant_w_dict`); int8 compute (`int8_w_dict` + `_int8_mm`). The per-ray
// direction term is computed from the dequantized wdir.

#include "mlp_body.cuh"

#ifndef NERF_WQ
#define NERF_WQ 0
#endif

namespace {

constexpr int WQ = NERF_WQ;
constexpr int HQ = head_route(WQ);
constexpr size_t FIXED_BYTES = ACT_BYTES + ENC_BYTES + WBUF_BYTES + STAGE_BYTES +
                               qtile_bytes(WQ) + M * sizeof(float) + M * sizeof(int) +
                               M * 3 * sizeof(float) + M * sizeof(float);
constexpr int OUT_F32 = 0, OUT_BF16 = 1, OUT_PLANAR = 2;   // raw output forms
constexpr int STATE = 6;        // per ray: log-transmittance carry, r, g, b, depth, acc

struct Params {
  Net net;
  const float* rays_o;
  const float* rays_d;
  const float* z;        // per-ray depths (ray_z kernels), row stride z_stride
  long long z_stride;
  void* out;             // raw [R * S, 4] (fp32 or bf16) or [4, R * S], or composited [R, 8]
  float* w;              // composited weights [R, S], or null
  long long total;       // n_rays * S
  int n_rays, S, nr_max, rb, out_mode;
  float near, span, dz, sentinel, eps;
};

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
  QTile q;       // the int8-compute route's s8 tiles
};

__device__ __forceinline__ Tile carve(unsigned char* smem, const Params& p) {
  Tile t;
  t.act = reinterpret_cast<bf16*>(smem);
  t.enc = reinterpret_cast<bf16*>(smem + ACT_BYTES);
  t.wbuf = reinterpret_cast<bf16*>(smem + ACT_BYTES + ENC_BYTES);
  unsigned char* rest = smem + ACT_BYTES + ENC_BYTES + WBUF_BYTES;
  t.stage = reinterpret_cast<float*>(rest);
  t.q = QTile();
  if (WQ == WQ_INT8_COMPUTE) t.q = carve_qtile(rest + STAGE_BYTES);
  t.sig = reinterpret_cast<float*>(rest + STAGE_BYTES + qtile_bytes(WQ));
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
  const Net& net = p.net;
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
  encode_pos_tile(t.enc, t.pos, n_end - n0, net.Lp, net.band_scale);

  // 2. direction branch once per ray of the tile: cdir = bf16(denc) @ wdir
  for (int e = tid; e < nr * KDIR; e += THREADS) {
    const int sl = e / KDIR, k = e % KDIR;
    const long long r = r_lo + sl;
    float d[3] = {p.rays_d[r * 3], p.rays_d[r * 3 + 1], p.rays_d[r * 3 + 2]};
    if (net.normalize_dirs) normalize_dir(d);
    t.denc[e] = __bfloat162float(__float2bfloat16_rn(encode_col(d, k, net.Ld, net.band_scale)));
  }
  __syncthreads();
  for (int e = tid; e < nr * CH; e += THREADS) {
    const int sl = e / CH, col = e % CH;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < KDIR; ++k)
      acc = fmaf(t.denc[sl * KDIR + k], weight_at<HQ>(net.wdir, net.wdir_s, k * CH + col, col), acc);
    t.cdir[e] = acc;
  }
  __syncthreads();

  // 3. the MLP: trunk, density, color layer with the per-ray direction term, rgb
  mlp_tile<false, false, WQ>(net, t.act, t.enc, t.wbuf, t.stage, t.sig, t.cdir, t.slot, nullptr,
                             nullptr, t.q);
}

// Raw modes: one 128-row tile per block, out row = (sigma, r, g, b) in fp32
// or bf16, or one element of each of the four planes.
template <bool ZIN>
__device__ void raw_body(const Params& p, unsigned char* smem) {
  const Tile t = carve(smem, p);
  const int tid = threadIdx.x;
  const long long n0 = (long long)blockIdx.x * M;
  eval_tile<ZIN>(p, t, n0, p.total);
  if (tid < M && n0 + tid < p.total) {
    const long long n = n0 + tid;
    const float* res = t.stage + tid * 4;
    const float v[4] = {t.sig[tid], res[1], res[2], res[3]};
    if (p.out_mode == OUT_F32) {
      static_cast<float4*>(p.out)[n] = make_float4(v[0], v[1], v[2], v[3]);
    } else if (p.out_mode == OUT_BF16) {
      __align__(8) bf16 h[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) h[c] = __float2bfloat16_rn(v[c]);
      static_cast<uint2*>(p.out)[n] = *reinterpret_cast<const uint2*>(h);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) static_cast<float*>(p.out)[c * p.total + n] = v[c];
    }
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
    static_cast<float*>(p.out)[(r_first + rl) * 8 + k] = k < 5 ? t.state[rl * STATE + 1 + k] : 0.f;
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
               int n_rays, int n_samples, float near, float span, const void* const* weights,
               const void* const* scales, int Lp, int Ld, int skip_pos, int bmild,
               int relu_sigma, int normalize_dirs, float band_scale, int composited,
               int out_mode, float dz, float sentinel, float eps, void* out, float* w,
               void* stream) {
  Params p;
  p.net = make_net(weights, scales, Lp, Ld, skip_pos, bmild, relu_sigma, normalize_dirs,
                   band_scale);
  p.rays_o = rays_o;
  p.rays_d = rays_d;
  p.z = z;
  p.z_stride = z_stride;
  p.out = out;
  p.w = w;
  p.total = (long long)n_rays * n_samples;
  p.n_rays = n_rays;
  p.S = n_samples;
  p.nr_max = (M - 1) / n_samples + 2;
  p.rb = composited ? M / gcd(n_samples, M) : 0;
  p.out_mode = out_mode;
  p.near = near;
  p.span = span;
  p.dz = dz;
  p.sentinel = sentinel;
  p.eps = eps;
  if (n_samples < (z ? 1 : 2) || !net_fits(p.net) || !net_has_scales(p.net, WQ) ||
      out_mode < OUT_F32 || out_mode > OUT_PLANAR || (composited && out_mode != OUT_F32))
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
