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
// What bounds it on an H100: arithmetic, not memory.  A ray reads its NV
// words once and writes its summaries once; between steps nothing touches
// device memory, so the byte bound is microseconds.  At S = 2 an RK4 step
// is four evaluations of about 340 FP64 (or FP32) operations each plus
// the RK sums: 1,383 operations per ray step, of which 11 are divisions
// and 9 square roots (counted by running this header on a type that counts
// its arithmetic: host_shim.cpp, rays_slab_count_ops).  So the card is
// held by instructions per step and by the warps an SM has to hide their
// latency.  What the design does about it:
//  - Divisions are subroutines of a dozen or more dependent instructions,
//    so everything that divides by a constant of the run multiplies by a
//    reciprocal that load_run() computed once on the host (SlabRun's
//    second block of fields), and groups that share a denominator (|B|,
//    dD/dw or |dD/dk|, the Z-function's |Z|^2, ...) take one reciprocal.
//    Two divisions per evaluation are left (1/|B| and 1/(dD/dw) or
//    1/|dD/dk|), S + 1 more in the residual check once per step.
//  - Registers decide how many warps an SM holds.  The RK sum is folded
//    into one running accumulator as each stage ends, and the slots that
//    cannot move in a slab (ky, kz, the absorption of the ions) are carried
//    as constants, so a ray keeps v, the carried first stage, the
//    accumulator and the stage point: 4 * (NV - 2 or 3) words.  The launch
//    shape (block size, register cap) is slab_rk4.cu's.
//  - Damping adds a Dawson sum to each evaluation (ops/zfun.py: 84 terms,
//    two exponentials and a division each).  It is decided first whether
//    damping is live at the point (k_par != 0, T_e > 0, |xi| <= 5); where it
//    is not, the result is 0 whatever the sum, and the sum is skipped.
//    Where it is, the sum stops at the first term that can no longer
//    change it in the working type (dawsn below: bit-equal to all 84),
//    multiplies by a table of 1 / n instead of dividing, and holds four
//    terms in the loop body so that their exponentials overlap.  The loop
//    is still about two thirds of a damped float64 step.
// With save_trajectory on, each accepted step writes NV words of state and
// one residual per ray, in a (step, slot, ray) layout that coalesces.
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

// terms of the Dawson sum (ops/zfun.py: the 84 odd n up to n h = 41.75)
#ifndef RAYS_DAWSN_TERMS
#define RAYS_DAWSN_TERMS 84
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
RAYS_HD constexpr int state_width() {
  return DAMP == DAMP_NONE ? 7 : (DAMP == DAMP_ECH ? 8 : 8 + S);
}

// Slots whose derivative is not identically zero in a slab: x, y, z, kx
// (the slab varies in x only, so dky/ds = dkz/ds = 0), the ray parameter,
// the total absorption and the electrons' (only they absorb, so the ions'
// slots keep their initial value).  The others are carried unchanged.
template <int DAMP>
RAYS_HD constexpr bool slot_moves(int j) {
  return j < 4 || j == 6 || (DAMP != DAMP_NONE && j == 7) || (DAMP == DAMP_ECH_MULTI && j == 8);
}

// The packed run constants: the Params values that a slab run reads, one
// row each (ms: the first species', the electrons'), and those per species
// S rows each, in this order (tracing/fused_slab.py packs them from tables
// of the same names, which its bind checks against rays_slab_row_names).
// The slab VJP differentiates the first two lists, and its accumulator has
// their rows; the step kernel and B1 read all four.
#define RAYS_DIFF_ROWS(X)                                                                   \
  X(rmaj) X(rmin) X(x0) X(by0) X(bz0) X(lby_shear_scale) X(lbz_scale) X(dbzdx) X(ln_scale) \
  X(alphan1) X(omgrf) X(omgrf_ref) X(k0) X(ds)
#define RAYS_DIFF_SPECIES_ROWS(X) X(alpha_coef) X(gamma_coef) X(n0s)
#define RAYS_FWD_ROWS(X)                                                                   \
  X(xmin) X(xmax) X(ymin) X(ymax) X(zmin) X(zmax) X(s_max) X(dispersion_resid_limit)     \
  X(lt_scale) X(dtdx) X(total_damping_limit) X(ms)
#define RAYS_FWD_SPECIES_ROWS(X) X(t0s) X(alphat1) X(alphat2) X(t_min)

// R_<name>: a scalar's row within its list, or a species field's index
// among its list's fields (field f of species s is row f * S + s of them)
#define RAYS_ROW_ENUM(name) R_##name,
enum : int { RAYS_DIFF_ROWS(RAYS_ROW_ENUM) N_DIFF_ROWS };
enum : int { RAYS_DIFF_SPECIES_ROWS(RAYS_ROW_ENUM) N_DIFF_SPECIES };
enum : int { RAYS_FWD_ROWS(RAYS_ROW_ENUM) N_FWD_ROWS };
enum : int { RAYS_FWD_SPECIES_ROWS(RAYS_ROW_ENUM) N_FWD_SPECIES };
#undef RAYS_ROW_ENUM

// rows of the first two lists: the slab VJP's accumulator
template <int S>
RAYS_HD constexpr int vjp_rows() { return N_DIFF_ROWS + N_DIFF_SPECIES * S; }
// the row of species s of a field of the second list
template <int S>
RAYS_HD constexpr int diff_species_row(int field, int s) { return N_DIFF_ROWS + field * S + s; }

// the row names, the four lists apart by " | "
#define RAYS_ROW_NAME(name) " " #name
inline const char* row_names() {
  return RAYS_DIFF_ROWS(RAYS_ROW_NAME) " |" RAYS_DIFF_SPECIES_ROWS(RAYS_ROW_NAME)
      " |" RAYS_FWD_ROWS(RAYS_ROW_NAME) " |" RAYS_FWD_SPECIES_ROWS(RAYS_ROW_NAME);
}
#undef RAYS_ROW_NAME

// The codes of a run's profile models and ray parameter, in this order
// (tracing/fused_slab.py::model_codes): By, Bz, density, time parameter,
// then the temperature model of each species.
enum : int { C_BY = 0, C_BZ, C_DENS, C_TIME, C_T, N_CODES = C_T + MAX_SPECIES };

constexpr double kClight = 2.997930e8;  // constants.CLIGHT

// Run constants, in registers or passed to a kernel by value.  The first
// block holds the rows of the packed vector and c, the second what
// load_run derives from them.
template <typename T>
struct SlabRun {
  T xmin, xmax, ymin, ymax, zmin, zmax;
  T rmaj, rmin, x0, by0, bz0, lby_shear_scale, lbz_scale, dbzdx;
  T ln_scale, alphan1, lt_scale, dtdx;
  T alpha_coef[MAX_SPECIES], gamma_coef[MAX_SPECIES], n0s[MAX_SPECIES];
  T t0s[MAX_SPECIES], alphat1[MAX_SPECIES], alphat2[MAX_SPECIES], t_min[MAX_SPECIES];
  T omgrf, omgrf_ref, k0, ds, s_max, dispersion_resid_limit;
  T total_damping_limit, ms, clight;  // damping: limit, electron mass, c
  // derived: reciprocals and products of the fields above
  T inv_k0, inv_k0sq, inv_omgrf, inv_rmaj, inv_rmin, inv_lby, inv_lbz, inv_ln, inv_lt;
  T gauss_coef;                // -3 alphan1 / rmin^2
  T half_ds, sixth_ds;
  T omgc_coef;                 // gamma_coef[0] * omgrf_ref: omega_ce / |B|
  T two_over_ms0, inv_clight;
  T alpha_w2[MAX_SPECIES];     // alpha_coef * (omgrf_ref / omgrf)^2
  T gamma_w[MAX_SPECIES];      // gamma_coef * (omgrf_ref / omgrf)
  T dn_linear[MAX_SPECIES];    // n0s / ln_scale
  int32_t by_model, bz_model, dens_model, time_param, nstep_max, save_trajectory;
  int32_t t_model[MAX_SPECIES];
};

// The run constants of S species from the packed vector pv (the four row
// lists) and the model codes (N_CODES), and the derived fields from them, in
// the working precision.  B1's launchers call it on the host, the step and
// VJP kernels on the device (a captured launch reads each run's values).
// nstep_max and save_trajectory are B1's, set by its launchers; the fields
// of species past S stay as they were.  A scale length that its model does
// not use may be 0: its reciprocal is then inf and is never read.
template <typename T, int S>
RAYS_HD void load_run(const T* pv, const int32_t* codes, SlabRun<T>& r) {
  const T* pf = pv + vjp_rows<S>();
#define RAYS_LOAD(name) r.name = pv[R_##name];
  RAYS_DIFF_ROWS(RAYS_LOAD)
#undef RAYS_LOAD
#define RAYS_LOAD(name) r.name = pf[R_##name];
  RAYS_FWD_ROWS(RAYS_LOAD)
#undef RAYS_LOAD
#pragma unroll
  for (int s = 0; s < S; ++s) {
#define RAYS_LOAD(name) r.name[s] = pv[diff_species_row<S>(R_##name, s)];
    RAYS_DIFF_SPECIES_ROWS(RAYS_LOAD)
#undef RAYS_LOAD
#define RAYS_LOAD(name) r.name[s] = pf[N_FWD_ROWS + R_##name * S + s];
    RAYS_FWD_SPECIES_ROWS(RAYS_LOAD)
#undef RAYS_LOAD
    r.t_model[s] = codes[C_T + s];
  }
  r.by_model = codes[C_BY];
  r.bz_model = codes[C_BZ];
  r.dens_model = codes[C_DENS];
  r.time_param = codes[C_TIME];
  r.clight = T(kClight);

  const T wratio = r.omgrf_ref / r.omgrf;
  r.inv_k0 = T(1) / r.k0;
  r.inv_k0sq = T(1) / (r.k0 * r.k0);
  r.inv_omgrf = T(1) / r.omgrf;
  r.inv_rmaj = T(1) / r.rmaj;
  r.inv_rmin = T(1) / r.rmin;
  r.inv_lby = T(1) / r.lby_shear_scale;
  r.inv_lbz = T(1) / r.lbz_scale;
  r.inv_ln = T(1) / r.ln_scale;
  r.inv_lt = T(1) / r.lt_scale;
  r.gauss_coef = T(-3) * r.alphan1 / (r.rmin * r.rmin);
  r.half_ds = r.ds / T(2);
  r.sixth_ds = r.ds / T(6);
  r.omgc_coef = r.gamma_coef[0] * r.omgrf_ref;
  r.two_over_ms0 = T(2) / r.ms;
  r.inv_clight = T(1) / r.clight;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    r.alpha_w2[s] = r.alpha_coef[s] * (wratio * wratio);
    r.gamma_w[s] = r.gamma_coef[s] * wratio;
    r.dn_linear[s] = r.n0s[s] / r.ln_scale;
  }
}

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
  // 1 / (1 + x / rmaj), shared by the two toroid models
  T tor = T(1);
  if (r.by_model == BY_TOROID || r.bz_model == BZ_TOROID)
    tor = T(1) / (T(1) + x * r.inv_rmaj);
  switch (r.by_model) {
    case BY_CONSTANT: by = r.by0; dby = T(0); break;
    case BY_TOROID: by = r.by0 * tor; dby = -by * (tor * r.inv_rmaj); break;
    case BY_LINEAR_SHEAR: by = r.by0 * x * r.inv_lby; dby = r.by0 * r.inv_lby; break;
    default: by = T(0); dby = T(0); break;
  }
  switch (r.bz_model) {
    case BZ_CONSTANT: bz = r.bz0; dbz = T(0); break;
    case BZ_TOROID: bz = r.bz0 * tor; dbz = -bz * (tor * r.inv_rmaj); break;
    case BZ_LINEAR: bz = r.bz0 * (T(1) + x * r.inv_lbz); dbz = r.bz0 * r.inv_lbz; break;
    case BZ_LINEAR_2: bz = r.bz0 + r.dbzdx * (x - r.x0); dbz = r.dbzdx; break;
    default: bz = T(0); dbz = T(0); break;
  }
  switch (r.dens_model) {
    case N_LINEAR: {
      const T shape = T(1) + x * r.inv_ln;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        ns[s] = r.n0s[s] * shape;
        dns[s] = r.dn_linear[s];
      }
      break;
    }
    case N_GAUSSIAN: {
      const T shape = r_exp(r.gauss_coef * (x * x));
      const T slope = T(2) * r.gauss_coef * x;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        ns[s] = r.n0s[s] * shape;
        dns[s] = ns[s] * slope;
      }
      break;
    }
    default:
#pragma unroll
      for (int s = 0; s < S; ++s) {
        ns[s] = r.n0s[s];
        dns[s] = T(0);
      }
      break;
  }
}

// models/slab.py::_temperature, value only: T_s at x
template <typename T>
RAYS_HD T temperature(const SlabRun<T>& r, int s, T x) {
  switch (r.t_model[s]) {
    case T_CONSTANT: return r.t0s[s];
    case T_LINEAR: return r.t0s[s] * (T(1) + x * r.inv_lt);
    case T_LINEAR_2: return r.t0s[s] + r.dtdx * (x - r.x0);
    case T_PARABOLIC:
      return r.t0s[s] * parabolic((x - r.x0) * r.inv_rmin, r.t_min[s], r.alphat1[s], r.alphat2[s]);
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

// 1 / n for the odd n of the Dawson sum, n = 2 j + 1: a division per term
// costs about a quarter of the term's instructions (two exponentials and
// the division), a constant-memory load none of the FP pipe's.
#define RAYS_INV_ODD_4(T, n) T(1) / T(n), T(1) / T((n) + 2), T(1) / T((n) + 4), T(1) / T((n) + 6)
#define RAYS_INV_ODD(T)                                                                  \
  RAYS_INV_ODD_4(T, 1), RAYS_INV_ODD_4(T, 9), RAYS_INV_ODD_4(T, 17), RAYS_INV_ODD_4(T, 25),   \
  RAYS_INV_ODD_4(T, 33), RAYS_INV_ODD_4(T, 41), RAYS_INV_ODD_4(T, 49), RAYS_INV_ODD_4(T, 57), \
  RAYS_INV_ODD_4(T, 65), RAYS_INV_ODD_4(T, 73), RAYS_INV_ODD_4(T, 81), RAYS_INV_ODD_4(T, 89), \
  RAYS_INV_ODD_4(T, 97), RAYS_INV_ODD_4(T, 105), RAYS_INV_ODD_4(T, 113),                      \
  RAYS_INV_ODD_4(T, 121), RAYS_INV_ODD_4(T, 129), RAYS_INV_ODD_4(T, 137),                     \
  RAYS_INV_ODD_4(T, 145), RAYS_INV_ODD_4(T, 153), RAYS_INV_ODD_4(T, 161)
static const double kInvOddHost64[84] = {RAYS_INV_ODD(double)};
static const float kInvOddHost32[84] = {RAYS_INV_ODD(float)};
#ifdef __CUDACC__
__device__ __constant__ double kInvOdd64[84] = {RAYS_INV_ODD(double)};
__device__ __constant__ float kInvOdd32[84] = {RAYS_INV_ODD(float)};
#endif
static_assert(RAYS_DAWSN_TERMS <= 84, "the reciprocal table holds 84 terms");

template <typename T> RAYS_HD T inv_odd(int j);
template <> RAYS_HD double inv_odd<double>(int j) {
#ifdef __CUDA_ARCH__
  return kInvOdd64[j];
#else
  return kInvOddHost64[j];
#endif
}
template <> RAYS_HD float inv_odd<float>(int j) {
#ifdef __CUDA_ARCH__
  return kInvOdd32[j];
#else
  return kInvOddHost32[j];
#endif
}

// ops/zfun.py::dawsn, all of it: Rybicki's sum over the 84 odd n at
// h = 0.25 in rising order.  What dawsn below is held to by the tests.
template <typename T>
RAYS_HD T dawsn_full(T x) {
  T acc = T(0);
#pragma unroll 1
  for (int j = 0; j < RAYS_DAWSN_TERMS; ++j) {
    const T nh = T(2 * j + 1) * T(0.25);
    const T a = x - nh, b = x + nh;
    acc += (r_exp(-(a * a)) - r_exp(-(b * b))) * inv_odd<T>(j);
  }
  return acc / T(1.7724538509055159);  // math.sqrt(math.pi)
}

// How far past |x| the sum must run, in units of n h: a term with
// n h > |x| + margin is below exp(-margin^2) / n while the sum so far is
// sqrt(pi) dawsn(x) (and every term scales with x as x -> 0), so it is
// under half an ulp of the sum and adding it changes nothing: exp(-49)
// against 2^-53 in double, exp(-25) against 2^-24 in float.
template <typename T> struct DawsnMargin { static constexpr double value = 7.0; };
template <> struct DawsnMargin<float> { static constexpr double value = 5.0; };

// Terms of the sum that the loop body holds: their exponentials are
// independent and overlap, the sum still adds them in order.  Four was 8%
// faster than one with the card filled (float64; PERF.md, Findings).
constexpr int kDawsnUnroll = 4;

// ops/zfun.py::dawsn for |x| <= 6 with only the terms that count: the sum
// of dawsn_full in the same order, a loop (unrolled by kDawsnUnroll only:
// it is inlined into every RK stage), ended at the first term that cannot
// change it.  Equal bit for bit to dawsn_full, at about 2 (|x| + margin)
// terms.  (Also skipping, within a term, the exponential that is under a quarter
// ulp of the other was tried and was no faster on the card: PERF.md.)
template <typename T>
RAYS_HD T dawsn(T x) {
#ifdef RAYS_DAWSN_ALL_TERMS  // a measurement switch: what the cut-off saves
  return dawsn_full(x);
#else
  const T reach = r_abs(x) + T(DawsnMargin<T>::value);
  T acc = T(0);
#pragma unroll kDawsnUnroll
  for (int j = 0; j < RAYS_DAWSN_TERMS; ++j) {
    const T nh = T(2 * j + 1) * T(0.25);
    if (nh > reach) break;
    const T a = x - nh, b = x + nh;
    acc += (r_exp(-(a * a)) - r_exp(-(b * b))) * inv_odd<T>(j);
  }
  return acc / T(1.7724538509055159);
#endif
}

// wave/damping.py::damp_fund_ech for one ray: k_i of the weak fundamental
// ECH absorption, from the equilibrium of eval_point (bunit = (0, buy,
// buz), electron alpha, gamma, T_e, |B|) and the direction of the group
// velocity, u / u_norm (u_norm is read for the time parameter only: for arc
// length u is a unit vector already).  The plain version computes everything and
// masks at the end (its clamps keep reverse mode free of NaN); the kernel
// has no backward, so it decides the mask first and returns the masked 0
// before the Dawson sum.
template <typename T>
RAYS_HD T damp_fund_ech(const SlabRun<T>& r, T kx, T ky, T kz, T buy, T buz, T alpha0,
                        T gamma0, T te, T bmag, T ux, T uy, T uz, T u_norm) {
  const T tiny = T(1e-30);
  const T k3 = ky * buy + kz * buz;
  if (!(k3 != T(0) && te > T(0))) return T(0);
  const T vth = r_sqrt(r_clamp_min(te, tiny) * r.two_over_ms0);
  const T omgc0 = r.omgc_coef * bmag;
  const T xi = (r.omgrf + omgc0) / (k3 * vth);
  if (!(r_abs(xi) <= T(5))) return T(0);

  const T nx = kx * r.inv_k0, ny = ky * r.inv_k0, nz = kz * r.inv_k0;
  const T k1y = ky - k3 * buy, k1z = kz - k3 * buz;
  const T k1sq = kx * kx + k1y * k1y + k1z * k1z;
  const T r3 = k3 * r.inv_k0;
  const T r1s = k1sq * r.inv_k0sq;
  const T r3s = r3 * r3;
  const T rs = r1s + r3s;

  const T b1 = gamma0;
  const T inv_b1 = T(1) / b1;
  const T betae = b1 * b1, inv_betae = inv_b1 * inv_b1;
  const T vt = vth * r.inv_clight;
  const T zr = T(-2) * dawsn(xi);
  const T zi = T(1.7724538509055159) * r_exp(-(xi * xi)) * r_sign(k3);
  const T zmag2 = r_clamp_min(zr * zr + zi * zi, tiny);

  const T p = alpha0;
  const T q = p * T(0.5) / (T(1) - b1);
  // r3 != 0 here; r3s can still underflow to 0, and is then replaced by 1
  const T inv_r3 = T(1) / r3;
  const T inv_safe_r3s = r3s == T(0) ? T(1) : inv_r3 * inv_r3;
  const T omp = T(1) - p, omq = T(1) - q, om2q = T(1) - T(2) * q;
  const T lam1 = omq * rs * r1s + omp * rs * r3s - omq * omp * (rs + r3s) - om2q * r1s +
                 om2q * omp;
  const T lam2 = -p * inv_b1 * (rs * r1s - om2q * r1s) +
                 p * p * T(0.25) * inv_betae * r1s * inv_safe_r3s * (rs + r3s - T(2) * om2q);
  const T lam5 = p * (rs * r3s - omq * (rs + r3s) + om2q);
  const T f_real = -(T(1) - b1) * r3 * vt *
                   (lam1 + lam2 + r1s * T(0.5) * inv_r3 * inv_betae * vt * xi * lam5);
  const T d_warm_im = f_real * (-zi / zmag2);

  // cold directional derivative of D along vg
  const T a = omp - betae;
  const T ab = a + omp * (T(1) - betae);
  const T b = -(omp * a + omp * omp - betae) + ab * r3s;
  const T ddnx2 = T(2) * a * r1s + b;
  const T ddnz = T(2) * r3 * (ab * r1s + omp * (T(2) * (T(1) - betae) * r3s - T(2) * a));
  const T dpx = T(2) * nx, dpy = T(2) * (ny - r3 * buy), dpz = T(2) * (nz - r3 * buz);
  const T ddx = ddnx2 * dpx, ddy = ddnx2 * dpy + ddnz * buy, ddz = ddnx2 * dpz + ddnz * buz;
  const T inv_u = r.time_param ? T(1) / r_clamp_min(u_norm, tiny) : T(1);
  const T denom = (ddx * ux + ddy * uy + ddz * uz) * inv_u;
  if (denom == T(0)) return T(0);
  return r.k0 * (-d_warm_im / denom);
}

// One equilibrium evaluation at v, then eqn_ray (tracing/rhs.py) and, with
// CHECK, check_save from the same evaluation (rhs.eqn_ray_and_check).
// Writes f[j] for the slots that move (slot_moves) and no other.
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
  const T inv_b = T(1) / r_clamp_min(bmag, tiny);
  const T buy = by * inv_b, buz = bz * inv_b;
  const T gbm = dby * buy + dbz * buz;           // d|B|/dx
  const T gbu_y = (dby - gbm * buy) * inv_b;     // d(bunit_y)/dx
  const T gbu_z = (dbz - gbm * buz) * inv_b;
  T alpha[S], gamma[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    alpha[s] = r.alpha_w2[s] * ns[s];
    gamma[s] = r.gamma_w[s] * bmag;
  }

  // deriv_cold (wave/deriv_cold.py); bunit_x = 0 and only d/dx survives
  const T nx = kx * r.inv_k0, ny = ky * r.inv_k0, nz = kz * r.inv_k0;
  const T n3 = ny * buy + nz * buz;
  const T py = ny - n3 * buy, pz = nz - n3 * buz;  // nperp = (nx, py, pz)
  const T n1sq = nx * nx + py * py + pz * pz;
  const T dn3dx = gbu_y * ny + gbu_z * nz;
  const T dn12dx = T(-2) * n3 * dn3dx;

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

  // sums over species of dD/dalpha dalpha/dx, dD/dalpha alpha and
  // dD/dgamma gamma: dgamma/dx = gamma gbm / |B|, dalpha/dw = -2 alpha / w,
  // dgamma/dw = -gamma / w share their factors outside the sums
  T sum_ax = T(0), sum_a = T(0), sum_g = T(0);
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

    // dalpha/dx = alpha dn/dx / max(n, tiny), and alpha / n = alpha_w2
    const T n_floor = ns[s] < tiny ? ns[s] * T(1e30) : T(1);
    sum_ax += ddda * (r.alpha_w2[s] * dns[s] * n_floor);
    sum_a += ddda * alpha[s];
    sum_g += dddg * gamma[s];
  }

  const T dddn3 = (T(4) * t * p * n3sq + T(2) * (T(-2) * p * u + (t * p + u) * n1sq)) * n3;
  const T dddn12 = (t * p + u) * n3sq - (q + p * u) + T(2) * u * n1sq;
  const T dddn3_k = dddn3 * r.inv_k0, dddn12_k = T(2) * dddn12 * r.inv_k0;
  const T dddk_x = dddn12_k * nx;
  const T dddk_y = dddn3_k * buy + dddn12_k * py;
  const T dddk_z = dddn3_k * buz + dddn12_k * pz;
  const T dddx_x = sum_ax + sum_g * (gbm * inv_b) + dddn3 * dn3dx + dddn12 * dn12dx;
  const T dddw = -(T(2) * sum_a + sum_g + dddn3 * n3 + T(2) * dddn12 * n1sq) * r.inv_omgrf;

  // eqn_ray (tracing/rhs.py): group velocity and the ray equations
  int32_t st = ST_OK;
  if (r.time_param) {
    const T inv_w = T(1) / (dddw == T(0) ? T(1) : dddw);
    f[0] = -dddk_x * inv_w;
    f[1] = -dddk_y * inv_w;
    f[2] = -dddk_z * inv_w;
    f[3] = dddx_x * inv_w;
    f[6] = r_sqrt(f[0] * f[0] + f[1] * f[1] + f[2] * f[2]);  // |vg|
  } else {
    const T dk_mag = r_sqrt(dddk_x * dddk_x + dddk_y * dddk_y + dddk_z * dddk_z);
    const T sgn = dddw >= T(0) ? T(1) : T(-1);  // Fortran sign(1., dddw)
    const T inv_m = sgn / r_clamp_min(dk_mag, tiny);
    f[0] = -dddk_x * inv_m;
    f[1] = -dddk_y * inv_m;
    f[2] = -dddk_z * inv_m;
    f[3] = dddx_x * inv_m;
    f[6] = T(1);
    if (dk_mag == T(0)) st = ST_RAY_STALLED;
  }
  if constexpr (DAMP != DAMP_NONE) {
    // damping slots (rhs._eqn_ray_from_eq, wave/damping.py).  The group
    // velocity -dD/dk / (dD/dw) is f[0..2] itself for the time parameter,
    // of magnitude f[6]; for arc length f[0..2] is already its direction.
    const T ki = damp_fund_ech(r, kx, ky, kz, buy, buz, alpha[0], gamma[0],
                               temperature(r, 0, x), bmag, f[0], f[1], f[2], f[6]);
    // only the electrons absorb: ksi = (ki, 0, ..., 0)
    f[7] = f[6] * T(2) * ki * (T(1) - v[7]);
    if constexpr (DAMP == DAMP_ECH_MULTI) f[8] = f[7];
  }
  if (dddw == T(0)) st = ST_INFINITE_VG;
  if (err != ST_OK) st = err;
  rhs_status = st;

  if (CHECK) {
    // check_save (tracing/rhs._check_from_point, wave/dispersion.residual)
    const T k3 = ky * buy + kz * buz;
    const T k1y = ky - k3 * buy, k1z = kz - k3 * buz;
    const T n1 = r_sqrt(kx * kx + k1y * k1y + k1z * k1z) * r.inv_k0;
    const T n3c = k3 * r.inv_k0;
    T ra = T(0), la = T(0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // alpha / (1 + gamma) and alpha / (1 - gamma) from one reciprocal
      const T gp = T(1) + gamma[s], gm = T(1) - gamma[s];
      const T a_over = alpha[s] / (gp * gm);
      ra += a_over * gm;
      la += a_over * gp;
    }
    const T R = T(1) - ra, L = T(1) - la;
    const T Sst = (R + L) * T(0.5), Dst = (R - L) * T(0.5);
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
  // state, stage point (its unmoving slots stay v's), carried first stage
  T v[NV], vt[NV], f1[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) vt[j] = v[j] = v0[i * NV + j];

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
    // RK4 stages 2-4 (tracing/rk4.rk4_step_carried), the weighted sum
    // f1 + 2 f2 + 2 f3 + f4 gathered in that order as the stages end
    T f[NV], acc[NV];
    int32_t st2, st3, st4, unused_st;
    T unused_res;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (slot_moves<DAMP>(j)) vt[j] = v[j] + r.half_ds * f1[j];
    eval_point<T, S, DAMP, false>(r, vt, f, st2, unused_res, unused_st);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (slot_moves<DAMP>(j)) {
        acc[j] = f1[j] + T(2) * f[j];
        vt[j] = v[j] + r.half_ds * f[j];
      }
    }
    eval_point<T, S, DAMP, false>(r, vt, f, st3, unused_res, unused_st);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (slot_moves<DAMP>(j)) {
        acc[j] += T(2) * f[j];
        vt[j] = v[j] + ds * f[j];
      }
    }
    eval_point<T, S, DAMP, false>(r, vt, f, st4, unused_res, unused_st);
    const int32_t solver_st = st1 != 0 ? st1 : (st2 != 0 ? st2 : (st3 != 0 ? st3 : st4));
    if (solver_st != 0) {
      status = solver_st;
      break;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (slot_moves<DAMP>(j)) vt[j] = v[j] + r.sixth_ds * (acc[j] + f[j]);

    // endpoint: check_save, and the next step's first stage
    eval_point<T, S, DAMP, true>(r, vt, f1, st1, resid, chk);
    if (chk != 0) {
      status = chk;
      break;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (slot_moves<DAMP>(j)) v[j] = vt[j];
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
