// Mip-NeRF 360's interval encoding on the card, shared by the proposal entry
// of the ray kernels' body (ray_wgmma.cu, ray_z_prop360_wgmma_kernel) and the
// NeRF pass's encoder (mip360_wgmma.cu, mip360_encode_kernel).
//
// google-research/multinerf: the frustum's full-covariance Gaussian
// (render.conical_frustum_to_gaussian, stable, lift_gaussian with
// diag=False), the scene contraction and its Jacobian applied to the
// covariance (coord.contract, track_linearize), the projection on the
// basis (coord.lift_and_diagonalize) and the integrated positional encoding
// (coord.integrated_pos_enc). fp32 without FMA, each step in the order of
// the plain version (nerf_tpu_torch/models/encoding.py
// encode_intervals_360): products of three terms summed ((x0 + x1) + x2),
// the 3 x 3 products (J cov) then (J cov) J^T, every entry kept (the result
// need not be symmetric bit for bit). sinf and expf at full accuracy.

#pragma once

#include "wgmma_common.cuh"

namespace {

constexpr float M360_EPS = 1.1920928955078125e-07f;       // float32 eps
constexpr float M360_EPS2 = M360_EPS * M360_EPS;
constexpr float M360_C5_48 = float(5.0 / 48.0);
constexpr float M360_HALF_PI = 1.5707963705062866f;       // fp32(pi / 2)

// The contracted Gaussian of the interval [t0, t1] of the ray (o, d) whose
// cone has base radius `radius`: its mean m and covariance c (row-major 3 x 3)
__device__ __forceinline__ void gaussian_360(const float* o, const float* d, float t0, float t1,
                                             float radius, float (&m)[3], float (&c)[9]) {
  const float s = __fadd_rn(t0, t1), dl = __fsub_rn(t1, t0);
  const float s2 = __fmul_rn(s, s), d2 = __fmul_rn(dl, dl);
  const float rho = __fdiv_rn(d2, fmaxf(__fadd_rn(__fmul_rn(3.f, s2), d2), M360_EPS2));
  const float t_mean = __fmul_rn(s, __fadd_rn(0.5f, rho));
  const float t_var =
      __fsub_rn(__fdiv_rn(d2, 12.f),
                __fdiv_rn(__fmul_rn(__fmul_rn(rho, rho), __fsub_rn(__fmul_rn(12.f, s2), d2)), 15.f));
  const float r_var =
      __fmul_rn(__fmul_rn(radius, radius),
                __fadd_rn(__fdiv_rn(s2, 16.f), __fmul_rn(d2, __fsub_rn(M360_C5_48, __fdiv_rn(rho, 15.f)))));
  float x[3], dv[3], dm[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) dv[i] = d[i];
  const float mag = fmaxf(
      __fadd_rn(__fadd_rn(__fmul_rn(dv[0], dv[0]), __fmul_rn(dv[1], dv[1])), __fmul_rn(dv[2], dv[2])),
      1e-10f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    x[i] = __fadd_rn(__fmul_rn(dv[i], t_mean), o[i]);
    dm[i] = __fdiv_rn(dv[i], mag);
  }
  float cov[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float pr = __fmul_rn(dv[i], dm[j]);
      const float nul = i == j ? __fsub_rn(1.f, pr) : -pr;
      cov[3 * i + j] = __fadd_rn(__fmul_rn(t_var, __fmul_rn(dv[i], dv[j])), __fmul_rn(r_var, nul));
    }
  // the contraction: J = a I + b x x^T outside the unit ball, I inside
  const float mm = fmaxf(
      __fadd_rn(__fadd_rn(__fmul_rn(x[0], x[0]), __fmul_rn(x[1], x[1])), __fmul_rn(x[2], x[2])),
      M360_EPS);
  const float q = sqrtf(mm);
  const bool inside = mm <= 1.f;
  const float a = inside ? 1.f : __fdiv_rn(__fsub_rn(__fmul_rn(2.f, q), 1.f), mm);
  const float b = inside ? 0.f : __fdiv_rn(__fmul_rn(2.f, __fsub_rn(1.f, q)), __fmul_rn(mm, mm));
  float J[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float bx = __fmul_rn(b, __fmul_rn(x[i], x[j]));
      J[3 * i + j] = i == j ? __fadd_rn(a, bx) : bx;
    }
  float JC[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      JC[3 * i + j] = __fadd_rn(__fadd_rn(__fmul_rn(J[3 * i], cov[j]), __fmul_rn(J[3 * i + 1], cov[3 + j])),
                                __fmul_rn(J[3 * i + 2], cov[6 + j]));
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = __fadd_rn(__fadd_rn(__fmul_rn(JC[3 * i], J[3 * j]), __fmul_rn(JC[3 * i + 1], J[3 * j + 1])),
                               __fmul_rn(JC[3 * i + 2], J[3 * j + 2]));
#pragma unroll
  for (int i = 0; i < 3; ++i) m[i] = __fmul_rn(a, x[i]);
}

// The kernels' order of the encoding's features: pair q = k n_deg + l holds
// direction k of the basis at degree l, its sine then its shifted sine, so
// one attenuation serves both and a thread projects the Gaussian on a
// direction once for its run of degrees; the host lays the rows of the
// matrices that multiply the encoding out in that order
// (ops/mip360_kernel.enc_order). The plain version keeps the published
// order (the sines of every degree and direction, then the shifted sines).
//
// The Gaussian (m, c) seen along direction k of basis [3][nb] (row-major):
// its mean mb and variance var
__device__ __forceinline__ void project_360(const float (&m)[3], const float (&c)[9],
                                            const float* basis, int nb, int k, float& mb,
                                            float& var) {
  const float b0 = basis[k], b1 = basis[nb + k], b2 = basis[2 * nb + k];
  mb = __fadd_rn(__fadd_rn(__fmul_rn(m[0], b0), __fmul_rn(m[1], b1)), __fmul_rn(m[2], b2));
  float cb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    cb[i] = __fadd_rn(__fadd_rn(__fmul_rn(c[3 * i], b0), __fmul_rn(c[3 * i + 1], b1)),
                      __fmul_rn(c[3 * i + 2], b2));
  var = __fadd_rn(__fadd_rn(__fmul_rn(b0, cb[0]), __fmul_rn(b1, cb[1])), __fmul_rn(b2, cb[2]));
}

// The pair of features at degree l of a direction's (mb, var), as a bf16
// pair: exp(-(4^l var) / 2) sin(2^l mb), then the same at 2^l mb + pi / 2;
// zeros where the attenuation is 0. The powers of two are built from their
// bits
__device__ __forceinline__ uint32_t ipe360_pair(float mb, float var, int l) {
  const float y = __fmul_rn(mb, __int_as_float((127 + l) << 23));                   // 2^l mb
  const float att = expf(__fmul_rn(-0.5f, __fmul_rn(var, __int_as_float((127 + 2 * l) << 23))));
  if (att == 0.f) return 0u;
  return pack_bf16(__fmul_rn(att, sinf(y)), __fmul_rn(att, sinf(__fadd_rn(y, M360_HALF_PI))));
}

// A thread's run of pairs through the encoding: start(q0) at pair q0, then
// each next4 gives the next four pairs as one 16-byte piece (zeros past nb
// n_deg pairs, or for a padding row), projecting on a direction once
struct Ipe360Run {
  int k, l, held;
  float mb, var;
  __device__ __forceinline__ void start(int q0, int n_deg) {
    k = q0 / n_deg;
    l = q0 - k * n_deg;
    held = -1;
    mb = var = 0.f;
  }
  __device__ __forceinline__ uint4 next4(const float (&m)[3], const float (&c)[9],
                                         const float* basis, int nb, int n_deg, bool valid) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t v = 0u;
      if (valid && k < nb) {
        if (k != held) {
          project_360(m, c, basis, nb, k, mb, var);
          held = k;
        }
        v = ipe360_pair(mb, var, l);
      }
      w[e] = v;
      if (++l == n_deg) {
        l = 0;
        ++k;
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float softplus_360(float x) {
  return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
}

}  // namespace
