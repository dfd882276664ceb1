// The accel engine's grid-guided depths: for each group of `stride` rays,
// the probe profile of its leader ray through the occupancy grid, the
// weights of the probes, sample_pdf's CDF over them and its inverse at the
// group's draws, in one launch a chunk.
//
// Replaces no TPU kernel: nerf_tpu/ops/occupancy.py grid_guided_z_vals is
// jnp, which XLA fuses into a few TPU ops. In eager PyTorch the same chain
// (the probe points, the cell lookup, the weights, sample_pdf's normalise,
// cumsum, cat, searchsorted, four gathers and the lerp, then the repeat of
// the groups) is about 70 ATen launches a chunk, which a few microseconds
// of device work cannot hide: the host's launches set the pace of the
// accel frame. Wrapper, plain PyTorch version and the dispatch:
// nerf_tpu_torch/ops/occupancy.py.
//
// What bounds it: latency, then bytes. A 16,384-ray chunk at the engine's
// defaults (96 probes, stride 4, 32 depths) reads 4,096 leader rays (98 KB)
// and at most the 64^3 float32 probe grid (1 MB, which stays in L2), and
// writes 2 MB of depths: under a microsecond at 3.35 TB/s, so in practice
// the launch and one warp's chain of dependent steps.
//
// Design: one warp a stride group, WARPS groups a block, nothing shared
// between warps. Lane l takes the run of K = ceil(P / 32) probes from l * K,
// so a lane's sums followed by a warp scan of the runs give the inclusive
// sums in order. The P + 1 knots of the CDF (the leading zero first) live in
// the warp's slice of shared memory; each lane then inverts the draws j =
// l, l + 32, ... by a binary search over the knots and writes each depth to
// every row of the group. The midpoint draws are increasing and the
// inverse CDF is monotone, so the depths come out sorted; the stochastic
// form inverts each ray's own draws against the group's CDF and sorts them
// in the warp (bitonic, in a second slice of shared memory).
//
// Arithmetic: the probe depths, points and cells as ops/occupancy.py's
// plain version computes them, each operation rounded once (__fmul_rn,
// __fadd_rn, __fdiv_rn: nvcc contracts none of them into an FMA), so equal
// float32 points fall in equal cells in both. The sums differ from ATen's
// cumsum and sum in order only.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;               // stride groups a block
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_PROBES = 1024;       // P + 1 knots a warp in shared memory (4 KB)
constexpr int MAX_SORTED = 256;        // depths a ray in the stochastic form's sort
constexpr unsigned FULL = 0xffffffffu;

enum WeightMode { OCCUPANCY = 0, ALPHA = 1, TRANSMITTANCE = 2 };

struct Params {
  const float* grid;     // [G^3], x-major
  const float* lo;       // [3]: the box's corners, on the device
  const float* hi;       // [3]
  const float* ro;       // [N, 3]
  const float* rd;       // [N, 3]
  const float* u;        // [N, S] draws, or null: the midpoints (j + 0.5) / S
  float* out;            // [N, S]
  int g, n_rays, n_groups, stride, n_probe, n_samples, mode, s_pad;
  float near, span, dz_scale, pdf_floor;   // span: far - near; dz_scale: span / P
};

// probe i's depth: near + (far - near) * ((i + 0.5) / P)
__device__ __forceinline__ float probe_z(const Params& p, int i) {
  const float t = __fdiv_rn(__fadd_rn(float(i), 0.5f), float(p.n_probe));
  return __fadd_rn(p.near, __fmul_rn(p.span, t));
}

// the grid's value at the cell of o + d z, 0 outside the box
__device__ __forceinline__ float probe_occupancy(const Params& p, const float (&o)[3],
                                                 const float (&d)[3], const float (&lo)[3],
                                                 const float (&ext)[3], float z) {
  int idx[3];
  bool inside = true;
  for (int a = 0; a < 3; ++a) {
    const float x = __fadd_rn(o[a], __fmul_rn(d[a], z));
    const float c = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(x, lo[a]), ext[a]), float(p.g)));
    inside = inside && c >= 0.f && c < float(p.g);    // false for NaN too
    idx[a] = inside ? int(c) : 0;
  }
  return inside ? __ldg(p.grid + (idx[0] * p.g + idx[1]) * p.g + idx[2]) : 0.f;
}

__device__ __forceinline__ float opacity(float occ, float dz) {
  return __fsub_rn(1.f, expf(__fmul_rn(-occ, dz)));
}

__device__ __forceinline__ float log_transmittance(float alpha) {
  return log1pf(-fminf(alpha, 0.9999999f));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// the sum of the runs of the lanes before this one
__device__ __forceinline__ float warp_exclusive(float v, int lane) {
  float incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl = __fadd_rn(incl, n);
  }
  const float excl = __shfl_up_sync(FULL, incl, 1);
  return lane == 0 ? 0.f : excl;
}

// sample_pdf's inverse CDF at u: the last knot j < P with cdf[j] <= u (the
// final knot counts as +inf), a bin narrower than 1e-5 counted 1 wide
__device__ __forceinline__ float invert(const Params& p, const float* cdf, float u) {
  int a = 0, b = p.n_probe;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (cdf[mid] <= u) a = mid + 1; else b = mid;
  }
  const int below = max(a - 1, 0), above = min(below + 1, p.n_probe - 1);
  const float cb = cdf[below];
  float denom = __fsub_rn(cdf[below + 1], cb);
  if (denom < 1e-5f) denom = 1.f;
  const float t = __fdiv_rn(__fsub_rn(u, cb), denom);
  const float zb = probe_z(p, below);
  return __fadd_rn(zb, __fmul_rn(t, __fsub_rn(probe_z(p, above), zb)));
}

__global__ void __launch_bounds__(THREADS) occupancy_z_kernel(Params p) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = blockIdx.x * WARPS + warp;
  if (group >= p.n_groups) return;                    // a whole warp
  const int P = p.n_probe, S = p.n_samples;
  float* cdf = smem + warp * (P + 1 + p.s_pad);       // knots [P + 1], then the sort's slice

  const int leader = min(group * p.stride, p.n_rays - 1);
  float o[3], d[3], lo[3], ext[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = p.ro[3 * leader + a];
    d[a] = p.rd[3 * leader + a];
    lo[a] = __ldg(p.lo + a);
    ext[a] = __fsub_rn(__ldg(p.hi + a), lo[a]);
  }
  const float dz = __fmul_rn(
      p.dz_scale,
      __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                           __fmul_rn(d[2], d[2]))));
  const int K = (P + 31) >> 5;
  const int i0 = min(lane * K, P), i1 = min(i0 + K, P);

  // the probes' weights + 1e-5 into knots 1..P, and their run's sum
  float run = 0.f;
  if (p.mode == TRANSMITTANCE) {
    float run_log = 0.f;
    for (int i = i0; i < i1; ++i) {
      const float alpha = opacity(probe_occupancy(p, o, d, lo, ext, probe_z(p, i)), dz);
      cdf[i + 1] = alpha;
      run_log = __fadd_rn(run_log, log_transmittance(alpha));
    }
    // the plain version's exclusive sum: the inclusive cumsum minus the term
    float incl = warp_exclusive(run_log, lane);
    for (int i = i0; i < i1; ++i) {
      const float alpha = cdf[i + 1], lt = log_transmittance(alpha);
      incl = __fadd_rn(incl, lt);
      const float w = __fadd_rn(__fmul_rn(alpha, expf(__fsub_rn(incl, lt))), p.pdf_floor);
      cdf[i + 1] = __fadd_rn(w, 1e-5f);
      run = __fadd_rn(run, cdf[i + 1]);
    }
  } else {
    for (int i = i0; i < i1; ++i) {
      float w = probe_occupancy(p, o, d, lo, ext, probe_z(p, i));
      if (p.mode == ALPHA) w = opacity(w, dz);
      w = __fadd_rn(__fadd_rn(w, p.pdf_floor), 1e-5f);
      cdf[i + 1] = w;
      run = __fadd_rn(run, w);
    }
  }

  // the CDF: each knot the inclusive sum of the normalised weights
  const float total = warp_sum(run);
  float run_pdf = 0.f;
  for (int i = i0; i < i1; ++i) run_pdf = __fadd_rn(run_pdf, __fdiv_rn(cdf[i + 1], total));
  float acc = warp_exclusive(run_pdf, lane);
  for (int i = i0; i < i1; ++i) {
    acc = __fadd_rn(acc, __fdiv_rn(cdf[i + 1], total));
    cdf[i + 1] = acc;
  }
  if (lane == 0) cdf[0] = 0.f;
  __syncwarp();

  const int first = group * p.stride;
  const int rows = min(p.stride, p.n_rays - first);
  if (p.u == nullptr) {
    for (int j = lane; j < S; j += 32) {
      const float z = invert(p, cdf, __fdiv_rn(__fadd_rn(float(j), 0.5f), float(S)));
      for (int r = 0; r < rows; ++r) p.out[size_t(first + r) * S + j] = z;
    }
    return;
  }
  // stochastic: each row its own draws, then a bitonic sort of its depths
  float* buf = cdf + P + 1;
  const int n = p.s_pad;
  for (int r = 0; r < rows; ++r) {
    const size_t row = size_t(first + r) * S;
    for (int j = lane; j < n; j += 32) buf[j] = j < S ? invert(p, cdf, p.u[row + j]) : INFINITY;
    __syncwarp();
    for (int k = 2; k <= n; k <<= 1) {
      for (int h = k >> 1; h > 0; h >>= 1) {
        for (int i = lane; i < n; i += 32) {
          const int m = i ^ h;
          if (m > i) {
            const float x = buf[i], y = buf[m];
            if ((x > y) == ((i & k) == 0)) {
              buf[i] = y;
              buf[m] = x;
            }
          }
        }
        __syncwarp();
      }
    }
    for (int j = lane; j < S; j += 32) p.out[row + j] = buf[j];
    __syncwarp();
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int occupancy_max_probes() { return MAX_PROBES; }
int occupancy_max_sorted() { return MAX_SORTED; }

// `grid`: [g^3] float32, x-major; `lo`, `hi`: [3] float32 on the device;
// `ro`, `rd`: [n_rays, 3] float32; `u`: [n_rays, n_samples] float32 draws or
// null (the midpoints); `out`: [n_rays, n_samples] float32. `mode`: 0
// occupancy, 1 alpha, 2 transmittance. `near`, `span` (far - near),
// `dz_scale` ((far - near) / n_probe) and `pdf_floor` as the wrapper rounded
// them to float32.
int occupancy_z_vals(const void* grid, int g, const void* lo, const void* hi, const void* ro,
                     const void* rd, int n_rays, int stride, int n_probe, int n_samples, int mode,
                     float near, float span, float dz_scale, float pdf_floor, const void* u,
                     void* out, void* stream) {
  if (!grid || !lo || !hi || !ro || !rd || !out || g < 1 || n_rays < 1 || stride < 1 ||
      n_probe < 1 || n_probe > MAX_PROBES || n_samples < 1 || mode < OCCUPANCY ||
      mode > TRANSMITTANCE || (u && n_samples > MAX_SORTED))
    return int(cudaErrorInvalidValue);
  Params p;
  p.grid = static_cast<const float*>(grid);
  p.lo = static_cast<const float*>(lo);
  p.hi = static_cast<const float*>(hi);
  p.ro = static_cast<const float*>(ro);
  p.rd = static_cast<const float*>(rd);
  p.u = static_cast<const float*>(u);
  p.out = static_cast<float*>(out);
  p.g = g;
  p.n_rays = n_rays;
  p.n_groups = (n_rays - 1) / stride + 1;
  p.stride = stride;
  p.n_probe = n_probe;
  p.n_samples = n_samples;
  p.mode = mode;
  p.s_pad = 0;
  if (u)
    for (p.s_pad = 1; p.s_pad < n_samples; p.s_pad <<= 1) {}
  p.near = near;
  p.span = span;
  p.dz_scale = dz_scale;
  p.pdf_floor = pdf_floor;
  const unsigned blocks = unsigned((p.n_groups + WARPS - 1) / WARPS);
  const size_t shared = size_t(WARPS) * (n_probe + 1 + p.s_pad) * sizeof(float);
  occupancy_z_kernel<<<blocks, THREADS, shared, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

}  // extern "C"
