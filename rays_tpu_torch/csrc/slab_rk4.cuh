// Per-ray physics and RK4 trajectory of the slab ECH main path, with or
// without fundamental-ECH damping.
//
// Replaces rays_tpu/tracing/fused_slab.py::trace_batch_fused (the Pallas
// kernel; its physics closures are make_slab_physics there), extended to
// the damping slots the Pallas kernel lacked.  Its plain counterpart is the
// generic chain of the port:
// models/slab.py -> models/base.equilibrium -> wave/deriv_cold.py ->
// wave/damping.py -> tracing/rhs.py -> tracing/rk4.py ->
// tracing/trace.trace_batch, and every formula below follows that chain's
// order of operations.
//
// This header compiles both as CUDA (nvcc, slab_rk4.cu: one thread per ray)
// and as plain C++ (g++, host_shim.cpp: a loop over rays), so the CPU tests
// check exactly this arithmetic before it runs on the card.
//
// What bounds it on an H100: FP64 (or FP32) arithmetic, about 1.4k flops
// per ray step and four equilibrium evaluations per step; damping adds a
// Dawson sum of 84 terms (168 exponentials) to each evaluation, kept as a
// loop.  Nothing is read from device memory between steps: the NV-slot
// state, the carried first RK stage and the summaries stay in registers for
// the whole trajectory.  With save_trajectory on, each accepted step writes
// NV words of state and one residual per ray, in a (step, slot, ray) layout
// that coalesces.
//
// The damping variant is a template parameter DAMP, and it fixes the state
// width (core/types.Config.nv): DAMP_NONE 7 slots (x, k, ray parameter),
// DAMP_ECH 8 (+ total absorption), DAMP_ECH_MULTI 8 + S (+ absorption per
// species).

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define RAYS_HD __host__ __device__ __forceinline__
#else
#define RAYS_HD inline
#endif

namespace rays {

// StopCode values (tracing/stop.py)
enum : int32_t {
  ST_OK = 0,
  ST_X_OUT_OF_BOUNDS = 1,
  ST_Y_OUT_OF_BOUNDS = 2,
  ST_Z_OUT_OF_BOUNDS = 3,
  ST_NEGATIVE_DENS = 6,
  ST_NEGATIVE_TEMP = 7,
  ST_INFINITE_VG = 10,
  ST_RAY_STALLED = 11,
  ST_DISPERSION_RESIDUAL = 20,
  ST_TOTAL_ABSORPTION = 21,
  ST_SOUT_GT_SMAX = 30,
  ST_NSTEP_MAX = 31,
};

// Profile models, numbered as in tracing/fused_slab.py (_BY_MODELS, ...).
enum : int32_t { BY_ZERO = 0, BY_CONSTANT = 1, BY_TOROID = 2, BY_LINEAR_SHEAR = 3 };
enum : int32_t { BZ_ZERO = 0, BZ_CONSTANT = 1, BZ_TOROID = 2, BZ_LINEAR = 3, BZ_LINEAR_2 = 4 };
enum : int32_t { N_CONSTANT = 0, N_LINEAR = 1, N_GAUSSIAN = 2 };
enum : int32_t { T_ZERO = 0, T_CONSTANT = 1, T_LINEAR = 2, T_LINEAR_2 = 3, T_PARABOLIC = 4 };

// Damping variants (tracing/fused_slab.py::_variant)
enum : int { DAMP_NONE = 0, DAMP_ECH = 1, DAMP_ECH_MULTI = 2 };

constexpr int MAX_SPECIES = 6;  // NSPEC0 = 5 ions plus electrons

// state width: x, y, z, kx, ky, kz, ray parameter [, absorption [, per species]]
template <int S, int DAMP>
constexpr int state_width() {
  return DAMP == DAMP_NONE ? 7 : (DAMP == DAMP_ECH ? 8 : 8 + S);
}

// Run constants, read once from Params on the host and passed by value.
// The field order is mirrored by tracing/fused_slab.py::_run_struct.
template <typename T>
struct SlabRun {
  T xmin, xmax, ymin, ymax, zmin, zmax;
  T rmaj, rmin, x0, by0, bz0, lby_shear_scale, lbz_scale, dbzdx;
  T ln_scale, alphan1, lt_scale, dtdx;
  T alpha_coef[MAX_SPECIES], gamma_coef[MAX_SPECIES], n0s[MAX_SPECIES];
  T t0s[MAX_SPECIES], alphat1[MAX_SPECIES], alphat2[MAX_SPECIES], t_min[MAX_SPECIES];
  T omgrf, omgrf_ref, k0, ds, s_max, dispersion_resid_limit;
  T total_damping_limit, ms0, clight;  // damping: limit, electron mass, c
  int32_t by_model, bz_model, dens_model, time_param, nstep_max, save_trajectory;
  int32_t t_model[MAX_SPECIES];
};

RAYS_HD double r_sqrt(double a) { return sqrt(a); }
RAYS_HD float r_sqrt(float a) { return sqrtf(a); }
RAYS_HD double r_exp(double a) { return exp(a); }
RAYS_HD float r_exp(float a) { return expf(a); }
RAYS_HD double r_pow(double a, double b) { return pow(a, b); }
RAYS_HD float r_pow(float a, float b) { return powf(a, b); }
RAYS_HD double r_abs(double a) { return fabs(a); }
RAYS_HD float r_abs(float a) { return fabsf(a); }
// torch.clamp_min / torch.clamp / torch.sign semantics, NaN passing through
template <typename T> RAYS_HD T r_clamp_min(T a, T lo) { return a < lo ? lo : a; }
template <typename T> RAYS_HD T r_clamp(T a, T lo, T hi) { return a < lo ? lo : (a > hi ? hi : a); }
template <typename T> RAYS_HD T r_sign(T a) { return a > T(0) ? T(1) : (a < T(0) ? T(-1) : a); }

// models/profiles.py::parabolic, value only (the kernel needs T_s for its
// sign check alone)
template <typename T>
RAYS_HD T parabolic(T rho, T f_min, T alpha1, T alpha2) {
  const T tiny = T(1e-30);
  const T r = r_abs(rho);
  const T r_safe = r_clamp(r, tiny, T(1));
  const T base = r_clamp_min(T(1) - r_pow(r_safe, alpha2), tiny);
  T f = r < T(1) ? r_pow(base, alpha1) : T(0);
  return f < f_min ? f_min : f;
}

// models/slab.py::fields_and_jac restricted to what the kernel supports:
// By, Bz, n_s and their x-derivatives (Bx is zero, y and z derivatives are
// zero in a slab).
template <typename T, int S>
RAYS_HD void slab_fields(const SlabRun<T>& r, T x, T& by, T& dby, T& bz, T& dbz,
                         T* ns, T* dns) {
  switch (r.by_model) {
    case BY_CONSTANT: by = r.by0; dby = T(0); break;
    case BY_TOROID: by = r.by0 / (T(1) + x / r.rmaj); dby = -by / (r.rmaj + x); break;
    case BY_LINEAR_SHEAR: by = r.by0 * x / r.lby_shear_scale; dby = r.by0 / r.lby_shear_scale; break;
    default: by = T(0); dby = T(0); break;
  }
  switch (r.bz_model) {
    case BZ_CONSTANT: bz = r.bz0; dbz = T(0); break;
    case BZ_TOROID: bz = r.bz0 / (T(1) + x / r.rmaj); dbz = -bz / (r.rmaj + x); break;
    case BZ_LINEAR: bz = r.bz0 * (T(1) + x / r.lbz_scale); dbz = r.bz0 / r.lbz_scale; break;
    case BZ_LINEAR_2: bz = r.bz0 + r.dbzdx * (x - r.x0); dbz = r.dbzdx; break;
    default: bz = T(0); dbz = T(0); break;
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    switch (r.dens_model) {
      case N_LINEAR:
        ns[s] = r.n0s[s] * (T(1) + x / r.ln_scale);
        dns[s] = r.n0s[s] / r.ln_scale;
        break;
      case N_GAUSSIAN: {
        const T q = x / r.rmin;
        ns[s] = r.n0s[s] * r_exp(T(-3) * r.alphan1 * (q * q));
        dns[s] = ns[s] * (T(-6) * r.alphan1 * x / (r.rmin * r.rmin));
        break;
      }
      default: ns[s] = r.n0s[s]; dns[s] = T(0); break;
    }
  }
}

// models/slab.py::_temperature, value only: T_s at x
template <typename T>
RAYS_HD T temperature(const SlabRun<T>& r, int s, T x) {
  switch (r.t_model[s]) {
    case T_CONSTANT: return r.t0s[s];
    case T_LINEAR: return r.t0s[s] * (T(1) + x / r.lt_scale);
    case T_LINEAR_2: return r.t0s[s] + r.dtdx * (x - r.x0);
    case T_PARABOLIC:
      return r.t0s[s] * parabolic((x - r.x0) / r.rmin, r.t_min[s], r.alphat1[s], r.alphat2[s]);
    default: return T(0);
  }
}

// models/slab.py::geom_err layered under models/base.py::_combine_err:
// x, y, z bounds, then negative density, then negative temperature.
template <typename T, int S>
RAYS_HD int32_t point_err(const SlabRun<T>& r, T x, T y, T z, const T* ns) {
  if (x < r.xmin || x > r.xmax) return ST_X_OUT_OF_BOUNDS;
  if (y < r.ymin || y > r.ymax) return ST_Y_OUT_OF_BOUNDS;
  if (z < r.zmin || z > r.zmax) return ST_Z_OUT_OF_BOUNDS;
  bool neg_dens = false, neg_temp = false;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    neg_dens |= ns[s] < T(0);
    neg_temp |= temperature(r, s, x) < T(0);
  }
  if (neg_dens) return ST_NEGATIVE_DENS;
  if (neg_temp) return ST_NEGATIVE_TEMP;
  return ST_OK;
}

// ops/zfun.py::dawsn: Rybicki's sum over the 84 odd n at h = 0.25, a loop
// (not unrolled: 168 exponentials per call would bloat every RK stage)
template <typename T>
RAYS_HD T dawsn(T x) {
  T acc = T(0);
#pragma unroll 1
  for (int j = 0; j < 84; ++j) {
    const T n = T(2 * j + 1);
    const T nh = n * T(0.25);
    const T a = x - nh, b = x + nh;
    acc += (r_exp(-(a * a)) - r_exp(-(b * b))) / n;
  }
  return acc / T(1.7724538509055159);  // math.sqrt(math.pi)
}

// wave/damping.py::damp_fund_ech for one ray: k_i of the weak fundamental
// ECH absorption, from the equilibrium of eval_point (bunit = (0, buy,
// buz), electron alpha, gamma, T_e and omega_ce) and the group velocity.
// The no-damping masks and the clamps before them are the plain version's.
template <typename T>
RAYS_HD T damp_fund_ech(const SlabRun<T>& r, T kx, T ky, T kz, T buy, T buz, T alpha0,
                        T gamma0, T te, T omgc0, T vgx, T vgy, T vgz) {
  const T tiny = T(1e-30);
  const T k0 = r.k0;
  const T nx = kx / k0, ny = ky / k0, nz = kz / k0;
  const T k3 = kx * T(0) + ky * buy + kz * buz;
  const T k1x = kx - k3 * T(0), k1y = ky - k3 * buy, k1z = kz - k3 * buz;
  const T k1sq = k1x * k1x + k1y * k1y + k1z * k1z;
  const T r3 = k3 / k0;
  const T r1s = k1sq / (k0 * k0);
  const T r3s = r3 * r3;
  const T rs = r1s + r3s;

  const T b1 = gamma0;
  const T betae = b1 * b1;
  const T vth = r_sqrt(T(2) * r_clamp_min(te, tiny) / r.ms0);
  const T vt = vth / r.clight;
  const T safe_k3 = k3 == T(0) ? T(1) : k3;
  const T xi = (r.omgrf + omgc0) / (safe_k3 * vth);
  const T xi_z = r_clamp(xi, T(-6), T(6));
  const T zr = T(-2) * dawsn(xi_z);
  const T zi = T(1.7724538509055159) * r_exp(-(xi_z * xi_z)) * r_sign(safe_k3);
  const T zmag2 = r_clamp_min(zr * zr + zi * zi, tiny);

  const T p = alpha0;
  const T q = p / T(2) / (T(1) - b1);
  const T safe_r3s = r3s == T(0) ? T(1) : r3s;
  const T safe_r3 = r3 == T(0) ? T(1) : r3;
  const T omp = T(1) - p, omq = T(1) - q, om2q = T(1) - T(2) * q;
  const T lam1 = omq * rs * r1s + omp * rs * r3s - omq * omp * (rs + r3s) - om2q * r1s +
                 om2q * omp;
  const T lam2 = -p / b1 * (rs * r1s - om2q * r1s) +
                 p * p / T(4) / betae * r1s / safe_r3s * (rs + r3s - T(2) * om2q);
  const T lam5 = p * (rs * r3s - omq * (rs + r3s) + om2q);
  const T f_real = -(T(1) - b1) * r3 * vt *
                   (lam1 + lam2 + r1s / T(2) / safe_r3 / betae * vt * xi_z * lam5);
  const T d_warm_im = f_real * (-zi / zmag2);

  // cold directional derivative of D along vg
  const T a = omp - betae;
  const T ab = a + omp * (T(1) - betae);
  const T b = -(omp * a + omp * omp - betae) + ab * r3s;
  const T ddnx2 = T(2) * a * r1s + b;
  const T ddnz = T(2) * r3 * (ab * r1s + omp * (T(2) * (T(1) - betae) * r3s - T(2) * a));
  const T dpx = T(2) * (nx - r3 * T(0)), dpy = T(2) * (ny - r3 * buy),
          dpz = T(2) * (nz - r3 * buz);
  const T ddx = ddnx2 * dpx + ddnz * T(0), ddy = ddnx2 * dpy + ddnz * buy,
          ddz = ddnx2 * dpz + ddnz * buz;
  const T vg_mag = r_clamp_min(r_sqrt(vgx * vgx + vgy * vgy + vgz * vgz), tiny);
  const T denom = ddx * (vgx / vg_mag) + ddy * (vgy / vg_mag) + ddz * (vgz / vg_mag);
  const T safe_denom = denom == T(0) ? T(1) : denom;
  const T ki0 = k0 * (-d_warm_im / safe_denom);

  const bool live = k3 != T(0) && r_abs(xi) <= T(5) && te > T(0) && denom != T(0);
  return live ? ki0 : T(0);
}

// One equilibrium evaluation at v, then eqn_ray (tracing/rhs.py) and, with
// CHECK, check_save from the same evaluation (rhs.eqn_ray_and_check).
template <typename T, int S, int DAMP, bool CHECK>
RAYS_HD void eval_point(const SlabRun<T>& r, const T* v, T* f, int32_t& rhs_status,
                        T& resid, int32_t& check_status) {
  const T tiny = T(1e-30);  // constants.SAFE_TINY
  const T x = v[0], y = v[1], z = v[2], kx = v[3], ky = v[4], kz = v[5];

  // equilibrium (models/base.equilibrium, core/eq_point.derive_eq_point)
  T by, dby, bz, dbz, ns[S], dns[S];
  slab_fields<T, S>(r, x, by, dby, bz, dbz, ns, dns);
  const int32_t err = point_err<T, S>(r, x, y, z, ns);
  const T bmag = r_sqrt(by * by + bz * bz);
  const T bsafe = r_clamp_min(bmag, tiny);
  const T buy = by / bsafe, buz = bz / bsafe;
  const T gbm = dby * buy + dbz * buz;           // d|B|/dx
  const T gbu_y = (dby - gbm * buy) / bsafe;     // d(bunit_y)/dx
  const T gbu_z = (dbz - gbm * buz) / bsafe;
  const T wratio = r.omgrf_ref / r.omgrf;
  const T w2 = wratio * wratio;
  T alpha[S], gamma[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    alpha[s] = r.alpha_coef[s] * ns[s] * w2;
    gamma[s] = r.gamma_coef[s] * bmag * wratio;
  }

  // deriv_cold (wave/deriv_cold.py); bunit_x = 0 and only d/dx survives
  const T k0 = r.k0, w = r.omgrf;
  const T nx = kx / k0, ny = ky / k0, nz = kz / k0;
  const T n3 = ny * buy + nz * buz;
  const T py = ny - n3 * buy, pz = nz - n3 * buz;  // nperp = (nx, py, pz)
  const T n1sq = nx * nx + py * py + pz * pz;
  const T dn3dx = gbu_y * ny + gbu_z * nz;
  const T dn12dx = T(-2) * n3 * dn3dx;
  const T gbm_over_b = gbm / bsafe;
  const T dn3dw = -n3 / w;
  const T dn12dw = T(-2) * n1sq / w;

  T p = T(0), t = T(1);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    p += alpha[s];
    t *= T(1) - gamma[s] * gamma[s];
  }
  p = T(1) - p;

  T dq1da[S], dq2da[S];
#pragma unroll
  for (int s1 = 0; s1 < S; ++s1) {
    T m1 = T(1), m2 = T(1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s != s1) {
        m1 *= T(1) + gamma[s];
        m2 *= T(1) - gamma[s];
      }
    }
    dq1da[s1] = m1;
    dq2da[s1] = m2;
  }
  T q1 = T(0), q2 = T(0), uacc = T(0);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    q1 += alpha[s] * dq1da[s];
    q2 += alpha[s] * dq2da[s];
    uacc += alpha[s] * dq1da[s] * dq2da[s];
  }
  const T u = t - uacc;
  const T q = T(2) * u - t + q1 * q2;
  const T n3sq = n3 * n3, n1sq2 = n1sq * n1sq;
  const T n3q = n3sq * n3sq;

  T sum_ax = T(0), sum_gx = T(0), sum_w = T(0);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const T duda = -dq1da[s] * dq2da[s];
    const T dqda = T(2) * duda + dq1da[s] * q2 + q1 * dq2da[s];
    const T ddda = -t * n3q + (T(2) * (u - p * duda) + (-t + duda) * n1sq) * n3sq - q +
                   p * dqda - (dqda - u + p * duda) * n1sq + duda * n1sq2;

    // leave-two-out products against species s
    T acc_pm = T(0), acc_p = T(0), acc_m = T(0);
#pragma unroll
    for (int s1 = 0; s1 < S; ++s1) {
      T gp = T(1), gm = T(1);
#pragma unroll
      for (int i = 0; i < S; ++i) {
        if (i != s1 && i != s) {
          gp *= T(1) + gamma[i];
          gm *= T(1) - gamma[i];
        }
      }
      acc_pm += alpha[s1] * (gp * gm);
      acc_p += alpha[s1] * gp;
      acc_m += alpha[s1] * gm;
    }
    const T dtdg = T(2) * gamma[s] * duda;
    const T dudg = dtdg + T(2) * gamma[s] * (acc_pm + alpha[s] * duda);
    const T dq1dg = acc_p - alpha[s] * dq1da[s];
    const T dq2dg = -acc_m + alpha[s] * dq2da[s];
    const T dqdg = T(2) * dudg - dtdg + dq1dg * q2 + q1 * dq2dg;
    const T dddg = dtdg * p * n3q + (T(-2) * p * dudg + (dtdg * p + dudg) * n1sq) * n3sq +
                   p * dqdg - (dqdg + p * dudg) * n1sq + dudg * n1sq2;

    const T dadx = alpha[s] * dns[s] / r_clamp_min(ns[s], tiny);
    const T dgdx = gamma[s] * gbm_over_b;
    const T dadw = T(-2) * alpha[s] / w;
    const T dgdw = -gamma[s] / w;
    sum_ax += ddda * dadx;
    sum_gx += dddg * dgdx;
    sum_w += ddda * dadw + dddg * dgdw;
  }

  const T dddn3 = (T(4) * t * p * n3sq + T(2) * (T(-2) * p * u + (t * p + u) * n1sq)) * n3;
  const T dddn12 = (t * p + u) * n3sq - (q + p * u) + T(2) * u * n1sq;
  const T dddk_x = dddn12 * (T(2) * nx / k0);
  const T dddk_y = dddn3 * (buy / k0) + dddn12 * (T(2) * py / k0);
  const T dddk_z = dddn3 * (buz / k0) + dddn12 * (T(2) * pz / k0);
  const T dddx_x = sum_ax + sum_gx + dddn3 * dn3dx + dddn12 * dn12dx;
  const T dddw = sum_w + dddn3 * dn3dw + dddn12 * dn12dw;

  // eqn_ray (tracing/rhs.py): group velocity and the ray equations
  const T dk_mag = r_sqrt(dddk_x * dddk_x + dddk_y * dddk_y + dddk_z * dddk_z);
  if (r.time_param) {
    const T safe_w = dddw == T(0) ? T(1) : dddw;
    f[0] = -dddk_x / safe_w;
    f[1] = -dddk_y / safe_w;
    f[2] = -dddk_z / safe_w;
    f[3] = dddx_x / safe_w;
    f[6] = r_sqrt(f[0] * f[0] + f[1] * f[1] + f[2] * f[2]);  // |vg|
  } else {
    const T sgn = dddw >= T(0) ? T(1) : T(-1);  // Fortran sign(1., dddw)
    const T m = r_clamp_min(dk_mag, tiny);
    f[0] = -sgn * dddk_x / m;
    f[1] = -sgn * dddk_y / m;
    f[2] = -sgn * dddk_z / m;
    f[3] = sgn * dddx_x / m;
    f[6] = T(1);
  }
  f[4] = T(0);
  f[5] = T(0);
  if constexpr (DAMP != DAMP_NONE) {
    // damping slots (rhs._eqn_ray_from_eq, wave/damping.py)
    const T safe_w = dddw == T(0) ? T(1) : dddw;
    const T omgc0 = r.gamma_coef[0] * bmag * r.omgrf_ref;
    const T ki = damp_fund_ech(r, kx, ky, kz, buy, buz, alpha[0], gamma[0],
                               temperature(r, 0, x), omgc0, -dddk_x / safe_w,
                               -dddk_y / safe_w, -dddk_z / safe_w);
    const T one_minus_p = T(1) - v[7];
    f[7] = f[6] * T(2) * ki * one_minus_p;
    if constexpr (DAMP == DAMP_ECH_MULTI) {
      // only the electrons absorb: ksi = (ki, 0, ..., 0)
      f[8] = f[6] * T(2) * ki * one_minus_p;
#pragma unroll
      for (int s = 1; s < S; ++s) f[8 + s] = f[6] * T(2) * T(0) * one_minus_p;
    }
  }
  int32_t st = ST_OK;
  if (!r.time_param && dk_mag == T(0)) st = ST_RAY_STALLED;
  if (dddw == T(0)) st = ST_INFINITE_VG;
  if (err != ST_OK) st = err;
  rhs_status = st;

  if (CHECK) {
    // check_save (tracing/rhs._check_from_point, wave/dispersion.residual)
    const T k3 = ky * buy + kz * buz;
    const T k1y = ky - k3 * buy, k1z = kz - k3 * buz;
    const T n1 = r_sqrt(kx * kx + k1y * k1y + k1z * k1z) / k0;
    const T n3c = k3 / k0;
    T ra = T(0), la = T(0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      ra += alpha[s] / (T(1) + gamma[s]);
      la += alpha[s] / (T(1) - gamma[s]);
    }
    const T R = T(1) - ra, L = T(1) - la;
    const T Sst = (R + L) / T(2), Dst = (R - L) / T(2);
    const T nsq = n1 * n1 + n3c * n3c;
    const T m11 = Sst + n1 * n1 - nsq;
    const T m22 = Sst - nsq;
    const T m33 = p + n3c * n3c - nsq;
    const T m13 = n1 * n3c;
    const T det = m33 * (m11 * m22 - Dst * Dst) - m13 * m13 * m22;
    const T en11 = r_abs(Sst) + n1 * n1;
    const T en22 = r_abs(Sst);
    const T en33 = r_abs(p) + n3c * n3c;
    const T en12 = r_abs(Dst);
    const T en13 = r_abs(m13);
    const T denom = en33 * (en11 * en22) + en33 * (en12 * en12) + en13 * (en22 * en13);
    resid = r_abs(det) / denom;
    int32_t cst = ST_OK;
    if constexpr (DAMP != DAMP_NONE) {
      if (v[7] > r.total_damping_limit) cst = ST_TOTAL_ABSORPTION;
    }
    if (resid > r.dispersion_resid_limit) cst = ST_DISPERSION_RESIDUAL;
    if (err != ST_OK) cst = err;
    check_status = cst;
  }
}

// The whole trajectory of ray i (tracing/trace.trace_batch for one ray).
// v0: (B, NV) row-major.  Outputs: v_out (B, NV), stop/npoints/end/max
// (B,); with save_trajectory, traj (nstep_max+1, NV, B) and traj_res
// (nstep_max+1, B), which the caller has zeroed.
template <typename T, int S, int DAMP>
RAYS_HD void trace_one(const SlabRun<T>& r, int64_t i, int64_t B, const T* v0,
                       const int32_t* status0, T* v_out, int32_t* stop_out,
                       int32_t* npoints_out, T* end_res_out, T* max_res_out, T* traj,
                       T* traj_res) {
  constexpr int NV = state_width<S, DAMP>();
  T v[NV], f1[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = v0[i * NV + j];

  // initial check; the same evaluation seeds the first step's k1
  int32_t st1, chk;
  T resid;
  eval_point<T, S, DAMP, true>(r, v, f1, st1, resid, chk);
  int32_t status = status0[i] != 0 ? status0[i] : chk;
  if (r.save_trajectory) {
#pragma unroll
    for (int j = 0; j < NV; ++j) traj[j * B + i] = v[j];
  }

  int32_t nstep = 0;
  T end_res = T(0), max_res = T(0);
  const T ds = r.ds;
  for (int k = 0; k < r.nstep_max && status == ST_OK; ++k) {
    if (T(k + 1) * ds > r.s_max) {
      status = ST_SOUT_GT_SMAX;
      break;
    }
    // RK4 stages 2-4 (tracing/rk4.rk4_step_carried)
    T vt[NV], f2[NV], f3[NV], f4[NV];
    int32_t st2, st3, st4, unused_st;
    T unused_res;
#pragma unroll
    for (int j = 0; j < NV; ++j) vt[j] = v[j] + ds * f1[j] / T(2);
    eval_point<T, S, DAMP, false>(r, vt, f2, st2, unused_res, unused_st);
#pragma unroll
    for (int j = 0; j < NV; ++j) vt[j] = v[j] + ds * f2[j] / T(2);
    eval_point<T, S, DAMP, false>(r, vt, f3, st3, unused_res, unused_st);
#pragma unroll
    for (int j = 0; j < NV; ++j) vt[j] = v[j] + ds * f3[j];
    eval_point<T, S, DAMP, false>(r, vt, f4, st4, unused_res, unused_st);
    const int32_t solver_st = st1 != 0 ? st1 : (st2 != 0 ? st2 : (st3 != 0 ? st3 : st4));
    if (solver_st != 0) {
      status = solver_st;
      break;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j)
      vt[j] = v[j] + ds * (f1[j] + T(2) * f2[j] + T(2) * f3[j] + f4[j]) / T(6);

    // endpoint: check_save, and the next step's first stage
    T fn[NV];
    int32_t stn;
    eval_point<T, S, DAMP, true>(r, vt, fn, stn, resid, chk);
    if (chk != 0) {
      status = chk;
      break;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      v[j] = vt[j];
      f1[j] = fn[j];
    }
    st1 = stn;
    ++nstep;
    end_res = resid;
    // torch.maximum: a NaN residual propagates
    max_res = (resid > max_res || resid != resid) ? resid : max_res;
    if (r.save_trajectory) {
      const int64_t row = (int64_t)(k + 1);
#pragma unroll
      for (int j = 0; j < NV; ++j) traj[(row * NV + j) * B + i] = v[j];
      traj_res[row * B + i] = resid;
    }
  }
  // still-live rays exhausted the step budget
  if (status == ST_OK) status = ST_NSTEP_MAX;

#pragma unroll
  for (int j = 0; j < NV; ++j) v_out[i * NV + j] = v[j];
  stop_out[i] = status;
  npoints_out[i] = 1 + nstep;
  end_res_out[i] = end_res;
  max_res_out[i] = max_res;
}

}  // namespace rays
