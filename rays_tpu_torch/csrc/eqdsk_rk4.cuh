// Per-ray physics and one outer RK4 step of the axisymmetric toroid whose
// field is read from a G-EQDSK through the bicubic psi spline
// (models/axisym_toroid.py, magnetics_model 'eqdsk_magnetics_spline_interp'
// with its per-cell coefficient table), cold plasma, no damping.
//
// Its plain counterpart is the generic chain of the port:
// ops/splines.eval_cell_2d_second -> models/axisym_toroid._magnetics_and_jac
// and _profiles_and_jac -> models/base.equilibrium (_combine_err) ->
// core/eq_point.derive_eq_point -> wave/deriv_cold.py -> tracing/rhs.py
// (eqn_ray, check_save) -> tracing/rk4.py -> tracing/trace.step, and every
// formula below follows that chain's order of operations, up to the
// reciprocals noted where they stand.  Unlike the slab (slab_rk4.cuh, whose
// evaluation keeps d/dx alone), the field varies in R and Z: the equilibrium
// point carries the full 3 x 3 jacobian of B and the gradients of psiN and
// of the densities, and every slot of the state moves.
//
// This header compiles both as CUDA (nvcc, eqdsk_rk4.cu: one thread per
// ray) and as plain C++ (g++, eqdsk_rk4_host.cpp: a loop over rays), so the
// CPU tests hold exactly this arithmetic to the generic chain before it runs
// on the card.  The adjoint graph's "step" piece on the card is
// toroid_step_fwd below; a VJP of the step recomputes it with
// toroid_rk4_stages.  It takes the slab kernels' scalar helpers and their
// D-gradient block (cold_dgrad, the same deriv_cold algebra) from their
// headers, which it leaves as they are.
//
// What bounds it on an H100: like the slab step, the latency of one
// dependent chain per ray (32,768 rays give about 8 warps an SM), with the
// arithmetic of four evaluations and the row fetches.  Each evaluation
// fetches one row of the cell table, all of it: the 16 bicubic coefficients
// of psi and the 16 of R*Bphi, as 16-byte read-only loads.
// build_cell_spline_2d writes R*Bphi's 1-D segment into its row q = 0
// and zeros elsewhere, but a gradient step on the table makes them nonzero,
// and the plain chain evaluates all 16 (eval_cell_2d_second), so the
// kernel does too.  Neighbouring rays of a fan fall in the same or
// neighbouring cells, and the table (4.2 MB in float64 at 129 x 129)
// stays in L2.  The parabolic
// profiles' powers are the costliest part of an evaluation; a temperature
// profile whose exponents equal the density's reuses its powers (the same
// inputs, the same bits).
//
// Params come from a packed device vector that the wrapper
// (tracing/eqdsk_step.py) fills at each run's load, in the row order of the
// X-macros below, which the wrapper checks by name; the cell table is read
// in place.  A captured launch thus answers for the Params of each run and
// nothing is read on the host.

#pragma once

#include "slab_rk4_vjp.cuh"

namespace rays {

// StopCode values of the toroid's geometry check (tracing/stop.py)
enum : int32_t { ST_R_OUT_OF_BOX = 4, ST_Z_OUT_OF_BOX = 5, ST_OUT_OF_PLASMA = 9 };

// Profile models of models/axisym_toroid.py that the kernel takes, numbered
// as in tracing/eqdsk_step.py (_PROFILE_MODELS)
enum : int32_t { PROF_ZERO = 0, PROF_CONSTANT = 1, PROF_PARABOLIC = 2 };

// The packed run constants: one row each for the first list, S rows each
// (species-major within a field) for the second.
#define RAYS_TOROID_ROWS(X)                                                              \
  X(cell_r0) X(cell_dr) X(cell_z0) X(cell_dz) X(psib) X(plasma_psi_limit) X(alphan1)   \
  X(alphan2) X(d_scrape_off) X(t_scrape_off) X(box_rmin) X(box_rmax) X(box_zmin)       \
  X(box_zmax) X(omgrf) X(omgrf_ref) X(k0) X(ds) X(s_max) X(dispersion_resid_limit)
#define RAYS_TOROID_SPECIES_ROWS(X) X(n0s) X(t0s) X(alpha_coef) X(gamma_coef) X(alphat1) X(alphat2)

#define RAYS_ROW_ENUM(name) T_##name,
enum : int { RAYS_TOROID_ROWS(RAYS_ROW_ENUM) N_TOROID_ROWS };
enum : int { RAYS_TOROID_SPECIES_ROWS(RAYS_ROW_ENUM) N_TOROID_SPECIES };
#undef RAYS_ROW_ENUM

// the row names, the two lists apart by " | "
#define RAYS_ROW_NAME(name) " " #name
inline const char* toroid_row_names() {
  return RAYS_TOROID_ROWS(RAYS_ROW_NAME) " |" RAYS_TOROID_SPECIES_ROWS(RAYS_ROW_NAME);
}
#undef RAYS_ROW_NAME

// The codes of a run's models, in this order (tracing/eqdsk_step.py,
// model_codes): density, time parameter, then the temperature model of
// each species.
enum : int { TC_DENS = 0, TC_TIME, TC_T, N_TOROID_CODES = TC_T + MAX_SPECIES };

constexpr double kAxisGuard = 1e-12;  // models/axisym_toroid._AXIS_GUARD
constexpr double kSafeTiny = 1e-30;   // constants.SAFE_TINY

RAYS_HD double r_floor(double a) { return floor(a); }
RAYS_HD float r_floor(float a) { return floorf(a); }
// a floored coordinate as a cell index (the host build's counting type
// brings its own)
RAYS_HD int32_t as_index(double a) { return (int32_t)a; }
RAYS_HD int32_t as_index(float a) { return (int32_t)a; }

// Run constants in registers: the rows of the packed vector, the codes and
// the cell table's shape, and what load_toroid derives from them.
template <typename T>
struct ToroidRun {
#define RAYS_FIELD(name) T name;
  RAYS_TOROID_ROWS(RAYS_FIELD)
#undef RAYS_FIELD
#define RAYS_FIELD(name) T name[MAX_SPECIES];
  RAYS_TOROID_SPECIES_ROWS(RAYS_FIELD)
#undef RAYS_FIELD
  // derived: reciprocals of the grid spacings (their products for the
  // second derivatives) and omgrf_ref / omgrf
  T inv_dr, inv_dz, inv_dr2, inv_drdz, inv_dz2, wratio;
  const T* cells;  // (nxm, nym, 2, 4, 4): channel 0 psi, channel 1 R*Bphi
  int32_t nxm, nym;
  int32_t dens_model, time_param;
  int32_t t_model[MAX_SPECIES];
};

template <typename T, int S>
RAYS_HD void load_toroid(const T* pv, const int32_t* codes, const T* cells, int32_t nxm,
                         int32_t nym, ToroidRun<T>& r) {
#define RAYS_LOAD(name) r.name = pv[T_##name];
  RAYS_TOROID_ROWS(RAYS_LOAD)
#undef RAYS_LOAD
  const T* ps = pv + N_TOROID_ROWS;
#pragma unroll
  for (int s = 0; s < S; ++s) {
#define RAYS_LOAD(name) r.name[s] = ps[T_##name * S + s];
    RAYS_TOROID_SPECIES_ROWS(RAYS_LOAD)
#undef RAYS_LOAD
    r.t_model[s] = codes[TC_T + s];
  }
  r.dens_model = codes[TC_DENS];
  r.time_param = codes[TC_TIME];
  r.cells = cells;
  r.nxm = nxm;
  r.nym = nym;
  r.inv_dr = T(1) / r.cell_dr;
  r.inv_dz = T(1) / r.cell_dz;
  r.inv_dr2 = T(1) / (r.cell_dr * r.cell_dr);
  r.inv_drdz = T(1) / (r.cell_dr * r.cell_dz);
  r.inv_dz2 = T(1) / (r.cell_dz * r.cell_dz);
  r.wratio = r.omgrf_ref / r.omgrf;
}

// --- the cell table ----------------------------------------------------------

// The coefficients of one cell: psi's c[q][p] (q the power of the local Z
// coordinate, p of the local R coordinate) and R*Bphi's, alike.
template <typename T>
struct CellRow {
  T psi[16];
  T rb[16];
};

// Read cell `cell` of the table, its 2 x 16 coefficients, as 16-byte loads
// through the read-only path on the card (a row is 256 B in float64, 128 B
// in float32, and the table is 16-byte aligned: the wrapper checks).
template <typename T>
RAYS_HD void fetch_row(const T* cells, int64_t cell, CellRow<T>& row) {
  const T* c = cells + cell * 32;
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) == 8) {
    const double2* p = reinterpret_cast<const double2*>(c);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const double2 a = __ldg(p + j);
      T* to = j < 8 ? row.psi + 2 * j : row.rb + 2 * (j - 8);
      to[0] = a.x;
      to[1] = a.y;
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 a = __ldg(p + j);
      T* to = j < 4 ? row.psi + 4 * j : row.rb + 4 * (j - 4);
      to[0] = a.x;
      to[1] = a.y;
      to[2] = a.z;
      to[3] = a.w;
    }
  }
#else
  for (int j = 0; j < 16; ++j) {
    row.psi[j] = c[j];
    row.rb[j] = c[16 + j];
  }
#endif
}

// ops/splines._cell: the cell index along one axis, clamped to 0..n - 1 (n
// cells), and the local coordinate.  A NaN lands in cell 0, as the
// integer conversion and clamp give there.
template <typename T>
RAYS_HD int32_t cell_of(T x, T x0, T dx, int32_t n, T& u) {
  const T t = (x - x0) / dx;
  T fi = r_floor(t);
  if (!(fi >= T(0))) fi = T(0);
  if (fi > T(n - 1)) fi = T(n - 1);
  u = t - fi;
  return as_index(fi);
}

// psi, its first and second derivatives in (R, Z), and R*Bphi and its slope
// in R at (R, Z) from one row fetch: ops/splines.eval_cell_2d_second on the
// toroid's two channels (in Horner form in the local coordinates), of which
// models/axisym_toroid._spline_flux keeps channel 1's value and d/dR.
template <typename T>
struct Flux {
  T psi, psi_r, psi_z, psi_rr, psi_rz, psi_zz, rbphi, rbphi_r;
};

template <typename T>
RAYS_HD void spline_flux(const ToroidRun<T>& r, T rr, T zz, Flux<T>& fl) {
  T u, v;
  const int32_t i = cell_of(rr, r.cell_r0, r.cell_dr, r.nxm, u);
  const int32_t j = cell_of(zz, r.cell_z0, r.cell_dz, r.nym, v);
  CellRow<T> c;
  fetch_row(r.cells, (int64_t)i * r.nym + j, c);
  // along R first: g = f(u), gu = f'(u), guu = f''(u) for each power of v
  T g[4], gu[4], guu[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const T* a = c.psi + 4 * q;
    g[q] = a[0] + u * (a[1] + u * (a[2] + u * a[3]));
    gu[q] = a[1] + u * (T(2) * a[2] + u * (T(3) * a[3]));
    guu[q] = T(2) * a[2] + u * (T(6) * a[3]);
  }
  fl.psi = g[0] + v * (g[1] + v * (g[2] + v * g[3]));
  fl.psi_r = (gu[0] + v * (gu[1] + v * (gu[2] + v * gu[3]))) * r.inv_dr;
  fl.psi_z = (g[1] + v * (T(2) * g[2] + v * (T(3) * g[3]))) * r.inv_dz;
  fl.psi_rr = (guu[0] + v * (guu[1] + v * (guu[2] + v * guu[3]))) * r.inv_dr2;
  fl.psi_rz = (gu[1] + v * (T(2) * gu[2] + v * (T(3) * gu[3]))) * r.inv_drdz;
  fl.psi_zz = (T(2) * g[2] + v * (T(6) * g[3])) * r.inv_dz2;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const T* a = c.rb + 4 * q;
    g[q] = a[0] + u * (a[1] + u * (a[2] + u * a[3]));
    gu[q] = a[1] + u * (T(2) * a[2] + u * (T(3) * a[3]));
  }
  fl.rbphi = g[0] + v * (g[1] + v * (g[2] + v * g[3]));
  fl.rbphi_r = (gu[0] + v * (gu[1] + v * (gu[2] + v * gu[3]))) * r.inv_dr;
}

// --- the equilibrium point ---------------------------------------------------

// What deriv_cold, eqn_ray and check_save read of the equilibrium at a
// point (core/eq_point.EqPoint, float fields), and the equilibrium's stop
// code.
template <typename T, int S>
struct ToroidEq {
  T bmag, bunit[3];
  T gradbmag[3];      // d|B|/dx_i
  T gradbunit[3][3];  // [i][j] = d(bunit_j)/dx_i
  T ns[S], gradns[S][3];
  T alpha[S], gamma[S];
  int32_t err;
};

// models/profiles.parabolic at psiN with its floor: (f, df/dpsiN), the
// slope only with deriv.  Returns the value before the floor, (1 -
// psiN^alpha2)^alpha1 inside and 0 outside.
template <typename T>
RAYS_HD T parabolic_fp(T rho, T f_min, T alpha1, T alpha2, T& f, T& fp, bool deriv) {
  const T tiny = T(kSafeTiny);
  const T a = r_abs(rho);
  f = T(0);
  fp = T(0);
  if (a < T(1)) {
    const T r_safe = r_clamp(a, tiny, T(1));
    const T base = r_clamp_min(T(1) - r_pow(r_safe, alpha2), tiny);
    f = r_pow(base, alpha1);
    if (deriv)
      fp = r_sign(rho) * (-alpha1 * alpha2 * r_pow(r_safe, alpha2 - T(1)) *
                          r_pow(base, alpha1 - T(1)));
  }
  const T unfloored = f;
  if (f < f_min) {
    f = f_min;
    fp = T(0);
  }
  return unfloored;
}

// One profile model at psiN (_profile_fp): (f, df/dpsiN), the slope only
// with deriv.  Returns parabolic_fp's value before the floor (else 0).
template <typename T>
RAYS_HD T profile_fp(int32_t model, T psin, T floor_, T alpha1, T alpha2, T& f, T& fp,
                     bool deriv) {
  f = T(0);
  fp = T(0);
  if (model == PROF_CONSTANT) f = T(1);
  if (model == PROF_PARABOLIC) return parabolic_fp(psin, floor_, alpha1, alpha2, f, fp, deriv);
  return T(0);
}

// models/base.equilibrium on the toroid (axisym_toroid.fields_jac_geom,
// _combine_err) and core/eq_point.derive_eq_point, at x = (x, y, z).
template <typename T, int S>
RAYS_HD void toroid_eq(const ToroidRun<T>& r, const T* x, ToroidEq<T, S>& e) {
  const T tiny = T(kSafeTiny);
  const T px = x[0], py = x[1], pz = x[2];
  const T rr0 = r_sqrt(px * px + py * py);
  const T rr = r_clamp_min(rr0, T(kAxisGuard));
  Flux<T> fl;
  spline_flux(r, rr, pz, fl);

  // _magnetics_and_jac: B = (grad psi x phihat) / R + (R Bphi) phihat / R,
  // chained through R = sqrt(x^2 + y^2); the divisions by R are one
  // reciprocal
  const T ir = T(1) / rr, ir2 = ir * ir;
  const T cx = px * ir, cy = py * ir;
  const T br = fl.psi_z * ir, bz = -fl.psi_r * ir, bphi = fl.rbphi * ir;
  const T dbr_dr = fl.psi_rz * ir - fl.psi_z * ir2;
  const T dbr_dz = fl.psi_zz * ir;
  const T dbz_dr = -fl.psi_rr * ir + fl.psi_r * ir2;
  const T dbz_dz = -fl.psi_rz * ir;
  const T dbphi_dr = fl.rbphi_r * ir - fl.rbphi * ir2;
  const T drv[3] = {cx, cy, T(0)};
  const T dcx[3] = {(T(1) - cx * cx) * ir, -cx * cy * ir, T(0)};
  const T dcy[3] = {-cx * cy * ir, (T(1) - cy * cy) * ir, T(0)};
  const T bvec[3] = {br * cx - bphi * cy, br * cy + bphi * cx, bz};
  T jb[3][3];  // [j][i] = dB_j/dx_i
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T dbr = dbr_dr * drv[i] + (i == 2 ? dbr_dz : T(0));
    const T dbz = dbz_dr * drv[i] + (i == 2 ? dbz_dz : T(0));
    const T dbphi = dbphi_dr * drv[i];
    jb[0][i] = br * dcx[i] + cx * dbr - bphi * dcy[i] - cy * dbphi;
    jb[1][i] = br * dcy[i] + cy * dbr + bphi * dcx[i] + cx * dbphi;
    jb[2][i] = dbz;
  }
  const T psin = fl.psi / r.psib;
  T dpsin[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) dpsin[i] = (fl.psi_r * drv[i] + (i == 2 ? fl.psi_z : T(0))) / r.psib;

  // _profiles_and_jac: the density's value and gradient, each temperature's
  // value (its sign is all the cold step reads of it)
  T fn, fnp;
  const T fn_in = profile_fp(r.dens_model, psin, r.d_scrape_off, r.alphan1, r.alphan2, fn, fnp,
                             true);
  bool neg_dens = false, neg_temp = false;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    e.ns[s] = r.n0s[s] * fn;
#pragma unroll
    for (int i = 0; i < 3; ++i) e.gradns[s][i] = r.n0s[s] * (fnp * dpsin[i]);
    neg_dens |= e.ns[s] < T(0);
    T ft, unused;
    if (r.t_model[s] == PROF_PARABOLIC && r.dens_model == PROF_PARABOLIC &&
        r.alphat1[s] == r.alphan1 && r.alphat2[s] == r.alphan2) {
      // the density's powers: the same inputs give the same value, and
      // only the floor differs
      ft = fn_in < r.t_scrape_off ? r.t_scrape_off : fn_in;
    } else {
      profile_fp(r.t_model[s], psin, r.t_scrape_off, r.alphat1[s], r.alphat2[s], ft, unused,
                 false);
    }
    neg_temp |= r.t0s[s] * ft < T(0);
  }

  // _geom_code under _combine_err: R box, then Z box, then the plasma
  // boundary; then negative density, then negative temperature
  int32_t err = ST_OK;
  if (neg_temp) err = ST_NEGATIVE_TEMP;
  if (neg_dens) err = ST_NEGATIVE_DENS;
  int32_t geom = ST_OK;
  if (psin > r.plasma_psi_limit) geom = ST_OUT_OF_PLASMA;
  if (pz < r.box_zmin || pz > r.box_zmax) geom = ST_Z_OUT_OF_BOX;
  if (rr0 < r.box_rmin || rr0 > r.box_rmax) geom = ST_R_OUT_OF_BOX;
  e.err = geom != ST_OK ? geom : err;

  // derive_eq_point
  const T bmag = r_sqrt(bvec[0] * bvec[0] + bvec[1] * bvec[1] + bvec[2] * bvec[2]);
  const T bsafe = r_clamp_min(bmag, tiny);
  const T ib = T(1) / bsafe;
  e.bmag = bmag;
#pragma unroll
  for (int j = 0; j < 3; ++j) e.bunit[j] = bvec[j] * ib;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    e.gradbmag[i] = jb[0][i] * e.bunit[0] + jb[1][i] * e.bunit[1] + jb[2][i] * e.bunit[2];
#pragma unroll
    for (int j = 0; j < 3; ++j) e.gradbunit[i][j] = (jb[j][i] - e.gradbmag[i] * e.bunit[j]) * ib;
  }
  const T w2 = r.wratio * r.wratio;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    e.alpha[s] = r.alpha_coef[s] * e.ns[s] * w2;
    e.gamma[s] = r.gamma_coef[s] * bmag * r.wratio;
  }
}

// --- the ray equations -------------------------------------------------------

// One equilibrium evaluation at v, then deriv_cold and eqn_ray
// (tracing/rhs.py) into f (all seven slots) and, with CHECK, check_save from
// the same evaluation (rhs.eqn_ray_and_check).  deriv_cold's divisions by
// k0 and omgrf are multiplications by their reciprocals, and eqn_ray's by
// |dD/dk| or dD/domega one reciprocal.
template <typename T, int S, bool CHECK>
RAYS_HD void toroid_point(const ToroidRun<T>& r, const T* v, T* f, int32_t& rhs_status,
                          T& resid, int32_t& check_status) {
  const T tiny = T(kSafeTiny);
  ToroidEq<T, S> e;
  toroid_eq<T, S>(r, v, e);
  const T inv_k0 = T(1) / r.k0, inv_w = T(1) / r.omgrf;

  // deriv_cold (wave/deriv_cold.py)
  const T nvec[3] = {v[3] * inv_k0, v[4] * inv_k0, v[5] * inv_k0};
  const T n3 = nvec[0] * e.bunit[0] + nvec[1] * e.bunit[1] + nvec[2] * e.bunit[2];
  T nperp[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) nperp[i] = nvec[i] - n3 * e.bunit[i];
  const T n1sq = nperp[0] * nperp[0] + nperp[1] * nperp[1] + nperp[2] * nperp[2];
  T ddda[S], dddg[S], dddn3, dddn12, p;
  cold_dgrad<T, S>(e.alpha, e.gamma, n3, n1sq, ddda, dddg, dddn3, dddn12, p);
  const T inv_b = T(1) / r_clamp_min(e.bmag, tiny);
  T dddk[3], dddx[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T dn3dx = e.gradbunit[i][0] * nvec[0] + e.gradbunit[i][1] * nvec[1] +
                    e.gradbunit[i][2] * nvec[2];
    const T dn12dx = T(-2) * n3 * dn3dx;
    const T dgdx = e.gradbmag[i] * inv_b;  // times gamma_s
    T sa = T(0), sg = T(0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sa += ddda[s] * (e.alpha[s] * e.gradns[s][i] / r_clamp_min(e.ns[s], tiny));
      sg += dddg[s] * (e.gamma[s] * dgdx);
    }
    dddx[i] = sa + sg + dddn3 * dn3dx + dddn12 * dn12dx;
    dddk[i] = dddn3 * (e.bunit[i] * inv_k0) + dddn12 * (T(2) * nperp[i] * inv_k0);
  }
  T dddw = T(0);
#pragma unroll
  for (int s = 0; s < S; ++s)
    dddw += ddda[s] * (T(-2) * e.alpha[s] * inv_w) + dddg[s] * (-e.gamma[s] * inv_w);
  dddw = dddw + dddn3 * (-n3 * inv_w) + dddn12 * (T(-2) * n1sq * inv_w);

  // eqn_ray: the group velocity and the ray equations
  int32_t st = ST_OK;
  if (r.time_param) {
    const T inv = T(1) / (dddw == T(0) ? T(1) : dddw);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      f[i] = -dddk[i] * inv;
      f[3 + i] = dddx[i] * inv;
    }
    f[6] = r_sqrt(f[0] * f[0] + f[1] * f[1] + f[2] * f[2]);  // |vg|
  } else {
    const T dk_mag = r_sqrt(dddk[0] * dddk[0] + dddk[1] * dddk[1] + dddk[2] * dddk[2]);
    const T sgn = dddw >= T(0) ? T(1) : T(-1);  // Fortran sign(1., dddw)
    const T inv = T(1) / r_clamp_min(dk_mag, tiny);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      f[i] = -sgn * dddk[i] * inv;
      f[3 + i] = sgn * dddx[i] * inv;
    }
    f[6] = T(1);
    if (dk_mag == T(0)) st = ST_RAY_STALLED;
  }
  if (dddw == T(0)) st = ST_INFINITE_VG;
  if (e.err != ST_OK) st = e.err;
  rhs_status = st;

  if (CHECK) {
    // check_save (tracing/rhs._check_from_point, wave/dispersion.residual)
    const T k3 = v[3] * e.bunit[0] + v[4] * e.bunit[1] + v[5] * e.bunit[2];
    T k1sq = T(0);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T d = v[3 + i] - k3 * e.bunit[i];
      k1sq += d * d;
    }
    const T n1 = r_sqrt(k1sq) / r.k0, n3c = k3 / r.k0;
    T ra = T(0), la = T(0), pa = T(0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      ra += e.alpha[s] / (T(1) + e.gamma[s]);
      la += e.alpha[s] / (T(1) - e.gamma[s]);
      pa += e.alpha[s];
    }
    const T R = T(1) - ra, L = T(1) - la, P = T(1) - pa;
    const T Sst = (R + L) / T(2), Dst = (R - L) / T(2);
    const T nsq = n1 * n1 + n3c * n3c;
    const T m11 = Sst + n1 * n1 - nsq;
    const T m22 = Sst - nsq;
    const T m33 = P + n3c * n3c - nsq;
    const T m13 = n1 * n3c;
    const T det = m33 * (m11 * m22 - Dst * Dst) - m13 * m13 * m22;
    const T en11 = r_abs(Sst) + n1 * n1;
    const T en22 = r_abs(Sst);
    const T en33 = r_abs(P) + n3c * n3c;
    const T en12 = r_abs(Dst);
    const T en13 = r_abs(m13);
    const T denom = en33 * (en11 * en22) + en33 * (en12 * en12) + en13 * (en22 * en13);
    resid = r_abs(det) / denom;
    int32_t cst = ST_OK;
    if (resid > r.dispersion_resid_limit) cst = ST_DISPERSION_RESIDUAL;
    if (e.err != ST_OK) cst = e.err;
    check_status = cst;
  }
}

// RK4 stages 2-4 of one outer step from the state v and the carried first
// stage f1 (tracing/rk4.rk4_step_carried_delta): the stage points v + ds f /
// 2 and v + ds f3, the weighted sum ((f1 + 2 f2) + 2 f3) + f4 gathered as
// the stages end, and the state after, vn = v + ds sum / 6.  Returns the
// first nonzero status of the three evaluations.  The forward step below
// and a VJP's recompute of the step are this one function.
template <typename T, int S>
RAYS_HD int32_t toroid_rk4_stages(const ToroidRun<T>& r, const T* v, const T* f1, T* vn) {
  constexpr int NV = 7;
  T vt[NV], f[NV], sum[NV];
  int32_t st2, st3, st4, unused_st;
  T unused_res;
  const T ds = r.ds;
#pragma unroll
  for (int j = 0; j < NV; ++j) vt[j] = v[j] + ds * f1[j] / T(2);
  toroid_point<T, S, false>(r, vt, f, st2, unused_res, unused_st);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    sum[j] = f1[j] + T(2) * f[j];
    vt[j] = v[j] + ds * f[j] / T(2);
  }
  toroid_point<T, S, false>(r, vt, f, st3, unused_res, unused_st);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    sum[j] += T(2) * f[j];
    vt[j] = v[j] + ds * f[j];
  }
  toroid_point<T, S, false>(r, vt, f, st4, unused_res, unused_st);
#pragma unroll
  for (int j = 0; j < NV; ++j) vn[j] = v[j] + ds * (sum[j] + f[j]) / T(6);
  return st2 != 0 ? st2 : (st3 != 0 ? st3 : st4);
}

// --- the adjoint graph's step -------------------------------------------------

// What one launch reads and writes; the wrapper fills it once per loop
// (the buffers are static) and passes it by pointer, the launcher to the
// kernel by value.  The carry's buffers are (B, ...), the stacks
// (nstep_max, B, ...); traj (B, nstep_max + 1, 7) and resid (B, nstep_max +
// 1), or null without trajectories; params: the packed run constants;
// cells: the cell table, (nxm, nym, 2, 4, 4).
template <typename T>
struct EqdskStepArgs {
  const T* params;
  const T* k;
  const T* cells;
  T* v;
  T* f1;
  int32_t* st1;
  T* hstate;
  int32_t* status;
  int32_t* nstep;
  T* end_res;
  T* max_res;
  T* stack_v;
  T* stack_f1;
  int32_t* stack_st1;
  T* stack_hstate;
  int32_t* stack_status;
  int32_t* stack_nstep;
  T* stack_end;
  T* stack_max;
  T* traj;
  T* resid;
  int64_t B;
  int32_t nstep_max;
  int32_t nxm;
  int32_t nym;
  int32_t codes[N_TOROID_CODES];
};

// Outer step k (read from a.k at every launch) for ray i: its carry (v,
// f1, st1, hstate, status, nstep, end_res, max_res) into the stack at row
// k, in the stack's layout (what the adjoint graph's VJP reads back: the
// index_copy_ of the generic piece, no arithmetic); then trace.step:
// step_start's s_max stop, RK4 stages 2-4, the endpoint evaluation with
// check_save (the next step's first stage) and step_end's acceptance.  The
// carry after the step is written in place; with trajectories, row k + 1
// of the trajectory and of the residual too (zero where the ray did not
// step).  A stopped ray does no arithmetic: its carry is copied to the
// stack and written back unchanged.
template <typename T, int S>
RAYS_HD void toroid_step_fwd(const EqdskStepArgs<T>& a, int64_t i) {
  constexpr int NV = 7;
  const int k = as_step(a.k[0]);
  const int64_t at = (int64_t)k * a.B + i;

  T v[NV], f1[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    v[j] = a.v[i * NV + j];
    f1[j] = a.f1[i * NV + j];
  }
  int32_t st1 = a.st1[i], status = a.status[i], nstep = a.nstep[i];
  T end_res = a.end_res[i], max_res = a.max_res[i];

  // the carry before the step into the stack
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    a.stack_v[at * NV + j] = v[j];
    a.stack_f1[at * NV + j] = f1[j];
  }
  a.stack_st1[at] = st1;
  a.stack_hstate[at] = a.hstate[i];
  a.stack_status[at] = status;
  a.stack_nstep[at] = nstep;
  a.stack_end[at] = end_res;
  a.stack_max[at] = max_res;

  bool ok = false;
  T resid = T(0);
  if (status == ST_OK) {
    ToroidRun<T> r;
    load_toroid<T, S>(a.params, a.codes, a.cells, a.nxm, a.nym, r);
    // step_start: sout = (k + 1) ds past s_max stops the ray
    if (T(k + 1) * r.ds > r.s_max) {
      status = ST_SOUT_GT_SMAX;
    } else {
      T vn[NV];
      const int32_t st = toroid_rk4_stages<T, S>(r, v, f1, vn);
      const int32_t solver_st = st1 != 0 ? st1 : st;
      if (solver_st != 0) {
        status = solver_st;
      } else {
        // the endpoint: check_save, and the next step's first stage
        T fn[NV];
        int32_t st_n, chk;
        toroid_point<T, S, true>(r, vn, fn, st_n, resid, chk);
        if (chk != 0) {
          status = chk;
        } else {
          ok = true;
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            v[j] = vn[j];
            f1[j] = fn[j];
          }
          st1 = st_n;
          ++nstep;
          end_res = resid;
          // torch.maximum: a NaN residual propagates
          max_res = (resid > max_res || resid != resid) ? resid : max_res;
        }
      }
    }
  }

  // the carry after the step, in place (hstate passes through RK4)
  a.status[i] = status;
  if (ok) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      a.v[i * NV + j] = v[j];
      a.f1[i * NV + j] = f1[j];
    }
    a.st1[i] = st1;
    a.nstep[i] = nstep;
    a.end_res[i] = end_res;
    a.max_res[i] = max_res;
  }
  if (a.traj) {
    const int64_t row = i * (int64_t)(a.nstep_max + 1) + k + 1;
#pragma unroll
    for (int j = 0; j < NV; ++j) a.traj[row * NV + j] = ok ? v[j] : T(0);
    a.resid[row] = ok ? resid : T(0);
  }
}

}  // namespace rays
