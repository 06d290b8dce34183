// The vector-Jacobian product (VJP) of one outer step of the undamped slab
// RK4 trace, per ray: the reverse of tracing/trace.step on the slab kernel's
// configurations (tracing/fused_slab.supported, damping_model 'no_damp').
//
// Replaces, inside the adjoint graph's backward (tracing/graphed_adjoint.py,
// the "vjp" piece), the recompute of trace.step under autograd and its
// torch.autograd.grad: about 3,900 library kernels of a microsecond or two
// per outer step at 32,768 rays, launch-bound, where this is one launch.
// Its plain version is that generic VJP, and the tests hold this body to it
// through the host build (slab_rk4_vjp_host.cpp).
//
// For outer step k, ray i reads its carry before the step from the stack
// that the adjoint graph keeps (v, f1, nstep, max_res; the step after
// gives nstep and end_res, the final carry for the last step), recomputes
// the step's four evaluations in registers with the slab kernel's own
// functions (slab_rk4.cuh: slab_fields, eval_point), and runs the step
// backwards by hand: step_end's where and maximum, the RK4 sums, and each
// evaluation through eqn_ray, deriv_cold, the residual check and the slab
// fields.  The cotangents of the float carry are written back in place; the
// cotangent of each Params value that the step reads is added into a
// per-ray accumulator (P, B), leaf-major so that the rows coalesce, which
// the wrapper reduces over rays once per backward.
//
// Decisions come from the stack, not from the recompute: whether the ray
// stepped (nstep after minus nstep before) and which branch of max_res's
// torch.maximum was taken (ties split evenly, NaN to both), since the
// recompute's arithmetic is the kernel's and the forward's was trace.step's.
// A ray that did not step passes its cotangents through and computes no
// derivative.  Params come from a packed device vector at every launch (an
// inverse problem changes them at every iteration, and a captured launch
// must answer for each); the reciprocals and coefficients of derive_run are
// derived here from the raw values and differentiated through, so the
// accumulators hold cotangents of Params values.
//
// The evaluation's RHS already holds the first derivatives of the
// dispersion function D; its reverse needs D's second derivatives.  These
// come from one fact: deriv_cold's block dD/dz, with z = (alpha_s,
// gamma_s, n3, n1^2), is the gradient of one scalar, so its jacobian is the
// symmetric Hessian of D and its reverse along a cotangent equals its
// forward along the same vector.  cold_dgrad below is that block, templated
// on the scalar; one pass of it on Dual numbers (value and one tangent)
// gives the reverse.  Everything else is reverse mode written out beside
// its forward.  The derivative is exact: the same step, in the run's own
// precision.
//
// What bounds it on an H100: arithmetic and the latency of its dependent
// chain, as for the slab kernel.  A live ray step is the recompute (three
// evaluations) and four evaluation VJPs, each a primal evaluation, the dual
// block at about three times the primal block's operations and the
// hand-written reverse: about 4.4 times the forward step's operations
// (counted by running this body on a type that counts its arithmetic:
// slab_rk4_vjp_host.cpp, rays_slab_vjp_count_ops).  Of these, the primals
// of stages 2-4 inside their VJPs and the Dual pass's value half repeat
// values the step has computed (repeat_mark); the bound is priced from the
// rest, one forward step and its reverse, about 3.2 times the forward
// step's operations.  Keeping those values instead would hold four stages'
// intermediates per thread where registers already spill.  Memory is the
// stack row read (~250 bytes a ray), the cotangents read and written, and
// the accumulator rows the configuration's models read (13 at the
// benchmark's deck, 16 bytes a row and ray): a few MB a step, in L2.  So the
// design keeps everything of a step in registers, reads the stack once,
// skips rays that did not step before loading anything else, and writes
// only the accumulator rows that the profile models use.

#pragma once

#include "slab_rk4.cuh"

namespace rays {

// Marks the arithmetic that the body repeats although the step has
// computed the same values before: the primal of a stage evaluation that
// the recompute already ran, and the value half of the Dual pass below.
// On the counting type (counted.h) the operations between repeat_mark(x,
// 1) and repeat_mark(x, -1) are tallied apart, so that the kernel's bound
// is priced from what the VJP needs; on float and double it is nothing.
RAYS_HD void repeat_mark(double, int) {}
RAYS_HD void repeat_mark(float, int) {}

// A number with one tangent, for the forward pass of cold_dgrad along a
// cotangent.  The arithmetic of the tangent is the product rule; nothing
// in cold_dgrad divides.  The value half repeats cold_dgrad's primal,
// which the evaluation has already computed.
template <typename T>
struct Dual {
  T v, d;
  RAYS_HD Dual() : v(T(0)), d(T(0)) {}
  template <typename N>
  RAYS_HD explicit Dual(N a) : v(T(a)), d(T(0)) {}
  RAYS_HD Dual(T a, T b) : v(a), d(b) {}
  RAYS_HD Dual operator-() const { return Dual(-v, -d); }
  RAYS_HD Dual& operator+=(const Dual& b) {
    repeat_mark(v, 1);
    v += b.v;
    repeat_mark(v, -1);
    d += b.d;
    return *this;
  }
  RAYS_HD Dual& operator*=(const Dual& b) {
    d = d * b.v + v * b.d;
    repeat_mark(v, 1);
    v *= b.v;
    repeat_mark(v, -1);
    return *this;
  }
};
template <typename T>
RAYS_HD Dual<T> operator+(const Dual<T>& a, const Dual<T>& b) {
  repeat_mark(a.v, 1);
  const T v = a.v + b.v;
  repeat_mark(a.v, -1);
  return Dual<T>(v, a.d + b.d);
}
template <typename T>
RAYS_HD Dual<T> operator-(const Dual<T>& a, const Dual<T>& b) {
  repeat_mark(a.v, 1);
  const T v = a.v - b.v;
  repeat_mark(a.v, -1);
  return Dual<T>(v, a.d - b.d);
}
template <typename T>
RAYS_HD Dual<T> operator*(const Dual<T>& a, const Dual<T>& b) {
  repeat_mark(a.v, 1);
  const T v = a.v * b.v;
  repeat_mark(a.v, -1);
  return Dual<T>(v, a.d * b.v + a.v * b.d);
}

RAYS_HD int as_step(double k) { return (int)k; }
RAYS_HD int as_step(float k) { return (int)k; }

// Rows of the packed Params vector and of the accumulators: the Params
// values an undamped slab step reads differentiably.  The species rows
// follow: alpha_coef[s] at P_SPECIES + s, gamma_coef[s] at P_SPECIES + S +
// s, n0s[s] at P_SPECIES + 2 S + s (tracing/slab_vjp.py mirrors this).
enum : int {
  P_RMAJ = 0, P_RMIN, P_X0, P_BY0, P_BZ0, P_LBY, P_LBZ, P_DBZDX, P_LN, P_ALPHAN1,
  P_OMGRF, P_OMGRF_REF, P_K0, P_DS, P_SPECIES
};

template <int S>
RAYS_HD constexpr int vjp_rows() { return P_SPECIES + 3 * S; }

// What one launch reads and writes; the wrapper fills it once per loop
// (the buffers are static) and passes it by pointer, the launcher to the
// kernel by value.  Stacks are (nstep_max, B, ...), the carry's (B, ...);
// traj_cot (B, nstep_max + 1, 7) and resid_cot (B, nstep_max + 1), or null
// without trajectories; acc (vjp_rows, B).
template <typename T>
struct SlabVjpArgs {
  const T* params;
  const T* k;
  const T* stack_v;
  const T* stack_f1;
  const int32_t* stack_nstep;
  const T* stack_end;
  const T* stack_max;
  const int32_t* nstep_out;
  const T* end_out;
  T* cot_v;
  T* cot_f1;
  T* cot_end;
  T* cot_max;
  const T* traj_cot;
  const T* resid_cot;
  T* acc;
  int64_t B;
  int32_t nstep_max, by_model, bz_model, dens_model, time_param, pad;
};

// Cotangents of the run values one step reads, raw and derived
// (SlabRun's names); reduced to the raw rows by add_param_cots.
template <typename T, int S>
struct RunCot {
  T by0, bz0, dbzdx, x0, inv_rmaj, inv_lby, inv_lbz, inv_ln, gauss_coef, inv_k0, inv_omgrf, ds;
  T alpha_w2[S], gamma_w[S], dn_linear[S], n0s[S];
};

// The run values from the packed vector, and derive_run's derived fields
// that a step reads, by its formulas.  The fields a step does not read
// stay zero (the bounds and temperatures of point_err, whose status is
// dead code here).
template <typename T, int S>
RAYS_HD void load_run(const SlabVjpArgs<T>& a, SlabRun<T>& r) {
  const T* pv = a.params;
  r.rmaj = pv[P_RMAJ];
  r.rmin = pv[P_RMIN];
  r.x0 = pv[P_X0];
  r.by0 = pv[P_BY0];
  r.bz0 = pv[P_BZ0];
  r.lby_shear_scale = pv[P_LBY];
  r.lbz_scale = pv[P_LBZ];
  r.dbzdx = pv[P_DBZDX];
  r.ln_scale = pv[P_LN];
  r.alphan1 = pv[P_ALPHAN1];
  r.omgrf = pv[P_OMGRF];
  r.omgrf_ref = pv[P_OMGRF_REF];
  r.k0 = pv[P_K0];
  r.ds = pv[P_DS];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    r.alpha_coef[s] = pv[P_SPECIES + s];
    r.gamma_coef[s] = pv[P_SPECIES + S + s];
    r.n0s[s] = pv[P_SPECIES + 2 * S + s];
  }
  r.by_model = a.by_model;
  r.bz_model = a.bz_model;
  r.dens_model = a.dens_model;
  r.time_param = a.time_param;
  const T wratio = r.omgrf_ref / r.omgrf;
  r.inv_k0 = T(1) / r.k0;
  r.inv_omgrf = T(1) / r.omgrf;
  r.inv_rmaj = T(1) / r.rmaj;
  r.inv_rmin = T(1) / r.rmin;
  r.inv_lby = T(1) / r.lby_shear_scale;
  r.inv_lbz = T(1) / r.lbz_scale;
  r.inv_ln = T(1) / r.ln_scale;
  r.gauss_coef = T(-3) * r.alphan1 / (r.rmin * r.rmin);
  r.half_ds = r.ds / T(2);
  r.sixth_ds = r.ds / T(6);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    r.alpha_w2[s] = r.alpha_coef[s] * (wratio * wratio);
    r.gamma_w[s] = r.gamma_coef[s] * wratio;
    r.dn_linear[s] = r.n0s[s] / r.ln_scale;
  }
}

// deriv_cold's D-gradient block as eval_point computes it: the partial
// derivatives of the cold dispersion function
//   D = t p n3^4 + (-2 p u + (t p + u) n1^2) n3^2 - (q + p u) n1^2 + u n1^4 + p q
// in alpha_s, gamma_s, n3 and n1^2, and p = 1 - sum alpha.  Templated on
// the scalar so that it also runs on Dual numbers.
template <typename T, int S>
RAYS_HD void cold_dgrad(const T* alpha, const T* gamma, T n3, T n1sq, T* ddda, T* dddg,
                        T& dddn3, T& dddn12, T& p_out) {
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

#pragma unroll
  for (int s = 0; s < S; ++s) {
    const T duda = -dq1da[s] * dq2da[s];
    const T dqda = T(2) * duda + dq1da[s] * q2 + q1 * dq2da[s];
    ddda[s] = -t * n3q + (T(2) * (u - p * duda) + (-t + duda) * n1sq) * n3sq - q + p * dqda -
              (dqda - u + p * duda) * n1sq + duda * n1sq2;

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
    dddg[s] = dtdg * p * n3q + (T(-2) * p * dudg + (dtdg * p + dudg) * n1sq) * n3sq +
              p * dqdg - (dqdg + p * dudg) * n1sq + dudg * n1sq2;
  }
  dddn3 = (T(4) * t * p * n3sq + T(2) * (T(-2) * p * u + (t * p + u) * n1sq)) * n3;
  dddn12 = (t * p + u) * n3sq - (q + p * u) + T(2) * u * n1sq;
  p_out = p;
}

// The reverse of slab_fields: from the cotangents of By, dBy/dx, Bz,
// dBz/dx, n_s and dn_s/dx at x, the cotangent of x (returned) and of the
// run values (into gr).  ns: the values slab_fields gave.
template <typename T, int S>
RAYS_HD T slab_fields_vjp(const SlabRun<T>& r, T x, T by, T bz, const T* ns, T g_by, T g_dby,
                          T g_bz, T g_dbz, const T* g_ns, const T* g_dns, RunCot<T, S>& gr) {
  T g_x = T(0);
  const bool toroid = r.by_model == BY_TOROID || r.bz_model == BZ_TOROID;
  T tor = T(1), g_tor = T(0);
  if (toroid) tor = T(1) / (T(1) + x * r.inv_rmaj);
  switch (r.by_model) {
    case BY_CONSTANT: gr.by0 += g_by; break;
    case BY_TOROID: {
      // by = by0 tor, dby = -by (tor / rmaj)
      const T c = tor * r.inv_rmaj;
      const T gb = g_by - g_dby * c;
      const T gc = -g_dby * by;
      gr.by0 += gb * tor;
      g_tor += gb * r.by0 + gc * r.inv_rmaj;
      gr.inv_rmaj += gc * tor;
      break;
    }
    case BY_LINEAR_SHEAR:
      // by = by0 x / lby, dby = by0 / lby
      gr.by0 += g_by * x * r.inv_lby + g_dby * r.inv_lby;
      g_x += g_by * r.by0 * r.inv_lby;
      gr.inv_lby += g_by * r.by0 * x + g_dby * r.by0;
      break;
    default: break;
  }
  switch (r.bz_model) {
    case BZ_CONSTANT: gr.bz0 += g_bz; break;
    case BZ_TOROID: {
      const T c = tor * r.inv_rmaj;
      const T gb = g_bz - g_dbz * c;
      const T gc = -g_dbz * bz;
      gr.bz0 += gb * tor;
      g_tor += gb * r.bz0 + gc * r.inv_rmaj;
      gr.inv_rmaj += gc * tor;
      break;
    }
    case BZ_LINEAR:
      // bz = bz0 (1 + x / lbz), dbz = bz0 / lbz
      gr.bz0 += g_bz * (T(1) + x * r.inv_lbz) + g_dbz * r.inv_lbz;
      g_x += g_bz * r.bz0 * r.inv_lbz;
      gr.inv_lbz += g_bz * r.bz0 * x + g_dbz * r.bz0;
      break;
    case BZ_LINEAR_2:
      // bz = bz0 + dbzdx (x - x0), dbz = dbzdx
      gr.bz0 += g_bz;
      gr.dbzdx += g_bz * (x - r.x0) + g_dbz;
      g_x += g_bz * r.dbzdx;
      gr.x0 -= g_bz * r.dbzdx;
      break;
    default: break;
  }
  if (toroid) {
    // tor = 1 / (1 + x / rmaj)
    const T g_den = -g_tor * tor * tor;
    g_x += g_den * r.inv_rmaj;
    gr.inv_rmaj += g_den * x;
  }
  switch (r.dens_model) {
    case N_LINEAR: {
      // n = n0 (1 + x / ln), dn = n0 / ln (dn_linear)
      const T shape = T(1) + x * r.inv_ln;
      T g_shape = T(0);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        gr.n0s[s] += g_ns[s] * shape;
        g_shape += g_ns[s] * r.n0s[s];
        gr.dn_linear[s] += g_dns[s];
      }
      g_x += g_shape * r.inv_ln;
      gr.inv_ln += g_shape * x;
      break;
    }
    case N_GAUSSIAN: {
      // n = n0 exp(c x^2), dn = n (2 c x)
      const T shape = r_exp(r.gauss_coef * (x * x));
      const T slope = T(2) * r.gauss_coef * x;
      T g_shape = T(0), g_slope = T(0);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        g_slope += g_dns[s] * ns[s];
        const T gn = g_ns[s] + g_dns[s] * slope;
        gr.n0s[s] += gn * shape;
        g_shape += gn * r.n0s[s];
      }
      const T g_arg = g_shape * shape;
      gr.gauss_coef += g_arg * (x * x) + g_slope * T(2) * x;
      g_x += g_arg * r.gauss_coef * T(2) * x + g_slope * T(2) * r.gauss_coef;
      break;
    }
    default:
#pragma unroll
      for (int s = 0; s < S; ++s) gr.n0s[s] += g_ns[s];
      break;
  }
  return g_x;
}

// The VJP of eval_point<T, S, DAMP_NONE, CHECK> at the point (x, kx, ky,
// kz): gf the cotangents of f by slot (0-3 and 6 are read: slots 4 and 5
// are zero in a slab whatever the point, and the arc-length parameter's
// slot 6 is 1), gres that of the residual (with CHECK).  Writes gp = the
// cotangents of (x, kx, ky, kz) and adds those of the run values into gr.
// The primal is recomputed here in eval_point's order of arithmetic;
// again: the step's recompute has evaluated this point already, so that
// primal is repeated work (repeat_mark).
template <typename T, int S, bool CHECK>
RAYS_HD void eval_point_vjp(const SlabRun<T>& r, bool again, T x, T kx, T ky, T kz,
                            const T* gf, T gres, T* gp, RunCot<T, S>& gr) {
  const T tiny = T(1e-30);  // constants.SAFE_TINY
  const int rep = again ? 1 : 0;

  // --- forward: models/base.equilibrium, core/eq_point, deriv_cold
  repeat_mark(x, rep);
  T by, dby, bz, dbz, ns[S], dns[S];
  slab_fields<T, S>(r, x, by, dby, bz, dbz, ns, dns);
  const T bmag = r_sqrt(by * by + bz * bz);
  const T inv_b = T(1) / r_clamp_min(bmag, tiny);
  const T buy = by * inv_b, buz = bz * inv_b;
  const T gbm = dby * buy + dbz * buz;
  const T ey = dby - gbm * buy, ez = dbz - gbm * buz;
  const T gbu_y = ey * inv_b, gbu_z = ez * inv_b;
  T alpha[S], gamma[S], dadx[S], nfl[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    alpha[s] = r.alpha_w2[s] * ns[s];
    gamma[s] = r.gamma_w[s] * bmag;
    // dalpha/dx = alpha dn/dx / max(n, tiny)
    nfl[s] = ns[s] < tiny ? ns[s] * T(1e30) : T(1);
    dadx[s] = r.alpha_w2[s] * dns[s] * nfl[s];
  }
  const T nx = kx * r.inv_k0, ny = ky * r.inv_k0, nz = kz * r.inv_k0;
  const T n3 = ny * buy + nz * buz;
  const T py = ny - n3 * buy, pz = nz - n3 * buz;
  const T n1sq = nx * nx + py * py + pz * pz;
  const T dn3dx = gbu_y * ny + gbu_z * nz;
  const T dn12dx = T(-2) * n3 * dn3dx;
  T ddda[S], dddg[S], dddn3, dddn12, p;
  cold_dgrad<T, S>(alpha, gamma, n3, n1sq, ddda, dddg, dddn3, dddn12, p);
  T sum_ax = T(0), sum_a = T(0), sum_g = T(0);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    sum_ax += ddda[s] * dadx[s];
    sum_a += ddda[s] * alpha[s];
    sum_g += dddg[s] * gamma[s];
  }
  const T dddn3_k = dddn3 * r.inv_k0, dddn12_k = T(2) * dddn12 * r.inv_k0;
  const T dddk_x = dddn12_k * nx;
  const T dddk_y = dddn3_k * buy + dddn12_k * py;
  const T dddk_z = dddn3_k * buz + dddn12_k * pz;
  const T gb = gbm * inv_b;
  const T dddx_x = sum_ax + sum_g * gb + dddn3 * dn3dx + dddn12 * dn12dx;
  const T qw = T(2) * sum_a + sum_g + dddn3 * n3 + T(2) * dddn12 * n1sq;
  const T dddw = -qw * r.inv_omgrf;
  repeat_mark(x, -rep);

  // --- reverse of eqn_ray (tracing/rhs.py): cotangents of dD/dk, dD/dx, dD/dw
  T g_kx_d, g_ky_d, g_kz_d, g_xx, g_w;
  if (r.time_param) {
    // f = (-dD/dk, dD/dx) / dD/dw, f6 = |f[0..2]| (a guarded dD/dw = 0 is 1)
    repeat_mark(x, rep);
    const T inv_w = T(1) / (dddw == T(0) ? T(1) : dddw);
    const T f0 = -dddk_x * inv_w, f1 = -dddk_y * inv_w, f2 = -dddk_z * inv_w;
    const T f3 = dddx_x * inv_w;
    const T f6 = r_sqrt(f0 * f0 + f1 * f1 + f2 * f2);
    repeat_mark(x, -rep);
    const T h = gf[6] / f6;
    const T g0 = gf[0] + h * f0, g1 = gf[1] + h * f1, g2 = gf[2] + h * f2, g3 = gf[3];
    g_kx_d = -g0 * inv_w;
    g_ky_d = -g1 * inv_w;
    g_kz_d = -g2 * inv_w;
    g_xx = g3 * inv_w;
    g_w = dddw == T(0) ? T(0) : -(g0 * f0 + g1 * f1 + g2 * f2 + g3 * f3) * inv_w;
  } else {
    // f = sign(dD/dw) (-dD/dk, dD/dx) / max(|dD/dk|, tiny), f6 = 1
    repeat_mark(x, rep);
    const T dk_mag = r_sqrt(dddk_x * dddk_x + dddk_y * dddk_y + dddk_z * dddk_z);
    const T sgn = dddw >= T(0) ? T(1) : T(-1);
    const T m = r_clamp_min(dk_mag, tiny);
    const T inv_m = sgn / m;
    const T f0 = -dddk_x * inv_m, f1 = -dddk_y * inv_m, f2 = -dddk_z * inv_m;
    const T f3 = dddx_x * inv_m;
    repeat_mark(x, -rep);
    g_kx_d = -gf[0] * inv_m;
    g_ky_d = -gf[1] * inv_m;
    g_kz_d = -gf[2] * inv_m;
    g_xx = gf[3] * inv_m;
    if (dk_mag >= tiny) {
      const T h = -(gf[0] * f0 + gf[1] * f1 + gf[2] * f2 + gf[3] * f3) / m / dk_mag;
      g_kx_d += h * dddk_x;
      g_ky_d += h * dddk_y;
      g_kz_d += h * dddk_z;
    }
    g_w = T(0);
  }

  // --- reverse of the assembly of dD/dk, dD/dx, dD/dw
  const T gn3k = g_ky_d * buy + g_kz_d * buz;
  const T gn12k = g_kx_d * nx + g_ky_d * py + g_kz_d * pz;
  T g_nx = g_kx_d * dddn12_k, g_py = g_ky_d * dddn12_k, g_pz = g_kz_d * dddn12_k;
  T g_buy = g_ky_d * dddn3_k, g_buz = g_kz_d * dddn3_k;
  T g_dddn3 = gn3k * r.inv_k0, g_dddn12 = T(2) * gn12k * r.inv_k0;
  gr.inv_k0 += gn3k * dddn3 + T(2) * gn12k * dddn12;
  const T g_sum_ax = g_xx;
  T g_sum_g = g_xx * gb;
  T g_gbm = g_xx * sum_g * inv_b, g_inv_b = g_xx * sum_g * gbm;
  g_dddn3 += g_xx * dn3dx;
  T g_dn3dx = g_xx * dddn3;
  g_dddn12 += g_xx * dn12dx;
  const T g_dn12dx = g_xx * dddn12;
  const T gq = -g_w * r.inv_omgrf;
  gr.inv_omgrf -= g_w * qw;
  const T g_sum_a = T(2) * gq;
  g_sum_g += gq;
  g_dddn3 += gq * n3;
  T g_n3 = gq * dddn3;
  g_dddn12 += T(2) * gq * n1sq;
  T g_n1sq = T(2) * gq * dddn12;

  T g_alpha[S], g_gamma[S], g_ns[S], g_dns[S];
  Dual<T> za[S], zg[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const T gd = g_sum_ax * ddda[s];  // of dalpha/dx
    gr.alpha_w2[s] += gd * dns[s] * nfl[s];
    g_dns[s] = gd * r.alpha_w2[s] * nfl[s];
    g_ns[s] = ns[s] < tiny ? gd * r.alpha_w2[s] * dns[s] * T(1e30) : T(0);
    g_alpha[s] = g_sum_a * ddda[s];
    g_gamma[s] = g_sum_g * dddg[s];
    za[s] = Dual<T>(alpha[s], g_sum_ax * dadx[s] + g_sum_a * alpha[s]);
    zg[s] = Dual<T>(gamma[s], g_sum_g * gamma[s]);
  }
  // the D-gradient block: its reverse along its outputs' cotangents is
  // its forward along the same vector (the jacobian is D's Hessian)
  {
    Dual<T> tA[S], tG[S], tN3, tN12, tP;
    cold_dgrad<Dual<T>, S>(za, zg, Dual<T>(n3, g_dddn3), Dual<T>(n1sq, g_dddn12), tA, tG, tN3,
                           tN12, tP);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      g_alpha[s] += tA[s].d;
      g_gamma[s] += tG[s].d;
    }
    g_n3 += tN3.d;
    g_n1sq += tN12.d;
  }

  T g_kx = T(0), g_ky = T(0), g_kz = T(0);
  if (CHECK) {
    // --- check_save (rhs._check_from_point, dispersion.residual) and its reverse
    const T k3 = ky * buy + kz * buz;
    const T k1y = ky - k3 * buy, k1z = kz - k3 * buz;
    const T k1 = r_sqrt(kx * kx + k1y * k1y + k1z * k1z);
    const T n1 = k1 * r.inv_k0;
    const T n3c = k3 * r.inv_k0;
    T ra = T(0), la = T(0), a_over[S], inv_pm[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // alpha / (1 + gamma) and alpha / (1 - gamma) from one reciprocal
      const T gp_ = T(1) + gamma[s], gm_ = T(1) - gamma[s];
      inv_pm[s] = T(1) / (gp_ * gm_);
      a_over[s] = alpha[s] * inv_pm[s];
      ra += a_over[s] * gm_;
      la += a_over[s] * gp_;
    }
    const T R = T(1) - ra, L = T(1) - la;
    const T Sst = (R + L) * T(0.5), Dst = (R - L) * T(0.5);
    const T nsq = n1 * n1 + n3c * n3c;
    const T m11 = Sst + n1 * n1 - nsq;
    const T m22 = Sst - nsq;
    const T m33 = p + n3c * n3c - nsq;
    const T m13 = n1 * n3c;
    const T A = m11 * m22 - Dst * Dst;
    const T det = m33 * A - m13 * m13 * m22;
    const T aS = r_abs(Sst);
    const T en11 = aS + n1 * n1;
    const T en22 = aS;
    const T en33 = r_abs(p) + n3c * n3c;
    const T en12 = r_abs(Dst);
    const T en13 = r_abs(m13);
    const T denom = en33 * (en11 * en22) + en33 * (en12 * en12) + en13 * (en22 * en13);
    const T resid = r_abs(det) / denom;

    const T g_det = gres * r_sign(det) / denom;
    const T g_den = -gres * resid / denom;
    const T g_en33 = g_den * (en11 * en22 + en12 * en12);
    const T g_en11 = g_den * en33 * en22;
    const T g_en22 = g_den * (en33 * en11 + en13 * en13);
    const T g_en12 = g_den * en33 * T(2) * en12;
    const T g_en13 = g_den * T(2) * en22 * en13;
    T g_S = (g_en11 + g_en22) * r_sign(Sst);
    T g_n1 = g_en11 * T(2) * n1;
    T g_p = g_en33 * r_sign(p);
    T g_n3c = g_en33 * T(2) * n3c;
    T g_D = g_en12 * r_sign(Dst);
    T g_m13 = g_en13 * r_sign(m13);
    const T g_m33 = g_det * A, g_A = g_det * m33;
    g_m13 -= g_det * T(2) * m13 * m22;
    T g_m22 = -g_det * m13 * m13;
    const T g_m11 = g_A * m22;
    g_m22 += g_A * m11;
    g_D -= g_A * T(2) * Dst;
    g_n1 += g_m13 * n3c;
    g_n3c += g_m13 * n1;
    g_p += g_m33;
    g_n3c += g_m33 * T(2) * n3c;
    T g_nsq = -g_m33;
    g_S += g_m22;
    g_nsq -= g_m22;
    g_S += g_m11;
    g_n1 += g_m11 * T(2) * n1;
    g_nsq -= g_m11;
    g_n1 += g_nsq * T(2) * n1;
    g_n3c += g_nsq * T(2) * n3c;
    const T g_R = (g_S + g_D) * T(0.5), g_L = (g_S - g_D) * T(0.5);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // R = 1 - sum alpha / (1 + gamma), L = 1 - sum alpha / (1 - gamma),
      // P = 1 - sum alpha
      const T gp_ = T(1) + gamma[s], gm_ = T(1) - gamma[s];
      const T inv_p = gm_ * inv_pm[s], inv_m = gp_ * inv_pm[s];
      g_alpha[s] -= g_R * inv_p + g_L * inv_m + g_p;
      g_gamma[s] += g_R * (a_over[s] * gm_) * inv_p - g_L * (a_over[s] * gp_) * inv_m;
    }
    T g_k3 = g_n3c * r.inv_k0;
    gr.inv_k0 += g_n1 * k1 + g_n3c * k3;
    const T hk = g_n1 * r.inv_k0 / k1;
    g_kx += hk * kx;
    const T g_k1y = hk * k1y, g_k1z = hk * k1z;
    g_ky += g_k1y;
    g_k3 -= g_k1y * buy;
    g_buy -= g_k1y * k3;
    g_kz += g_k1z;
    g_k3 -= g_k1z * buz;
    g_buz -= g_k1z * k3;
    g_ky += g_k3 * buy;
    g_buy += g_k3 * ky;
    g_kz += g_k3 * buz;
    g_buz += g_k3 * kz;
  }

  // --- reverse of the refractive index and its x-derivatives
  g_n3 += T(-2) * g_dn12dx * dn3dx;
  g_dn3dx += T(-2) * g_dn12dx * n3;
  const T g_gbu_y = g_dn3dx * ny, g_gbu_z = g_dn3dx * nz;
  T g_ny = g_dn3dx * gbu_y, g_nz = g_dn3dx * gbu_z;
  g_nx += T(2) * g_n1sq * nx;
  g_py += T(2) * g_n1sq * py;
  g_pz += T(2) * g_n1sq * pz;
  g_ny += g_py;
  g_n3 -= g_py * buy;
  g_buy -= g_py * n3;
  g_nz += g_pz;
  g_n3 -= g_pz * buz;
  g_buz -= g_pz * n3;
  g_ny += g_n3 * buy;
  g_buy += g_n3 * ny;
  g_nz += g_n3 * buz;
  g_buz += g_n3 * nz;
  g_kx += g_nx * r.inv_k0;
  g_ky += g_ny * r.inv_k0;
  g_kz += g_nz * r.inv_k0;
  gr.inv_k0 += g_nx * kx + g_ny * ky + g_nz * kz;

  // --- reverse of alpha, gamma, the unit vector and its x-derivative
  T g_bmag = T(0);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    gr.gamma_w[s] += g_gamma[s] * bmag;
    g_bmag += g_gamma[s] * r.gamma_w[s];
    gr.alpha_w2[s] += g_alpha[s] * ns[s];
    g_ns[s] += g_alpha[s] * r.alpha_w2[s];
  }
  T g_dby = g_gbu_y * inv_b, g_dbz = g_gbu_z * inv_b;
  g_gbm -= (g_gbu_y * buy + g_gbu_z * buz) * inv_b;
  g_buy -= g_gbu_y * inv_b * gbm;
  g_buz -= g_gbu_z * inv_b * gbm;
  g_inv_b += g_gbu_y * ey + g_gbu_z * ez;
  g_dby += g_gbm * buy;
  g_buy += g_gbm * dby;
  g_dbz += g_gbm * buz;
  g_buz += g_gbm * dbz;
  T g_by = g_buy * inv_b, g_bz = g_buz * inv_b;
  g_inv_b += g_buy * by + g_buz * bz;
  if (bmag >= tiny) g_bmag -= g_inv_b * inv_b * inv_b;
  const T hb = g_bmag / bmag;
  g_by += hb * by;
  g_bz += hb * bz;

  gp[0] = slab_fields_vjp<T, S>(r, x, by, bz, ns, g_by, g_dby, g_bz, g_dbz, g_ns, g_dns, gr);
  gp[1] = g_kx;
  gp[2] = g_ky;
  gp[3] = g_kz;
}

// The accumulator rows of ray i: the run values' cotangents of one step
// through derive_run's formulas to the raw Params values, added into the
// rows that the configuration's profile models read (the others are never
// written, so they stay zero).
template <typename T, int S>
RAYS_HD void add_param_cots(const SlabRun<T>& r, const RunCot<T, S>& gr, T* acc, int64_t B,
                            int64_t i) {
  T* row = acc + i;
  const T wr = r.omgrf_ref / r.omgrf;
  T g_wr = T(0);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    row[(P_SPECIES + s) * B] += gr.alpha_w2[s] * (wr * wr);
    row[(P_SPECIES + S + s) * B] += gr.gamma_w[s] * wr;
    g_wr += gr.alpha_w2[s] * r.alpha_coef[s] * T(2) * wr + gr.gamma_w[s] * r.gamma_coef[s];
    T gn = gr.n0s[s];
    if (r.dens_model == N_LINEAR) gn += gr.dn_linear[s] * r.inv_ln;
    row[(P_SPECIES + 2 * S + s) * B] += gn;
  }
  row[P_OMGRF * B] += -gr.inv_omgrf * r.inv_omgrf * r.inv_omgrf - g_wr * wr * r.inv_omgrf;
  row[P_OMGRF_REF * B] += g_wr * r.inv_omgrf;
  row[P_K0 * B] += -gr.inv_k0 * r.inv_k0 * r.inv_k0;
  row[P_DS * B] += gr.ds;
  if (r.by_model != BY_ZERO) row[P_BY0 * B] += gr.by0;
  if (r.by_model == BY_LINEAR_SHEAR) row[P_LBY * B] += -gr.inv_lby * r.inv_lby * r.inv_lby;
  if (r.bz_model != BZ_ZERO) row[P_BZ0 * B] += gr.bz0;
  if (r.bz_model == BZ_LINEAR) row[P_LBZ * B] += -gr.inv_lbz * r.inv_lbz * r.inv_lbz;
  if (r.bz_model == BZ_LINEAR_2) {
    row[P_DBZDX * B] += gr.dbzdx;
    row[P_X0 * B] += gr.x0;
  }
  if (r.by_model == BY_TOROID || r.bz_model == BZ_TOROID)
    row[P_RMAJ * B] += -gr.inv_rmaj * r.inv_rmaj * r.inv_rmaj;
  if (r.dens_model == N_LINEAR) {
    T g_ln = -gr.inv_ln * r.inv_ln * r.inv_ln;
#pragma unroll
    for (int s = 0; s < S; ++s) g_ln -= gr.dn_linear[s] * r.dn_linear[s] * r.inv_ln;
    row[P_LN * B] += g_ln;
  }
  if (r.dens_model == N_GAUSSIAN) {
    // gauss_coef = -3 alphan1 / rmin^2
    row[P_ALPHAN1 * B] += gr.gauss_coef * T(-3) * r.inv_rmin * r.inv_rmin;
    row[P_RMIN * B] += gr.gauss_coef * T(-2) * r.gauss_coef * r.inv_rmin;
  }
}

// The VJP of outer step k (read from a.k) for ray i (module comment).
template <typename T, int S>
RAYS_HD void step_vjp(const SlabVjpArgs<T>& a, int64_t i) {
  constexpr int NV = state_width<S, DAMP_NONE>();
  const int k = as_step(a.k[0]);
  const int n = a.nstep_max;
  const int64_t B = a.B;
  const int64_t at = (int64_t)k * B + i, next = (int64_t)(k + 1) * B + i;
  const bool last = k + 1 >= n;
  const int32_t stepped = (last ? a.nstep_out[i] : a.stack_nstep[next]) - a.stack_nstep[at];
  if (stepped == 0) return;  // every cotangent passes through

  SlabRun<T> r{};
  load_run<T, S>(a, r);
  T v[NV], f1[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    v[j] = a.stack_v[at * NV + j];
    f1[j] = a.stack_f1[at * NV + j];
  }

  // --- the step again (tracing/rk4.rk4_step_carried, as trace_one does it)
  T vt[NV], f2[NV], f3[NV], f4[NV], sum[NV], vn[NV];
  int32_t st, cst;
  T res;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    f2[j] = f3[j] = f4[j] = T(0);
    vt[j] = v[j] + r.half_ds * f1[j];
  }
  eval_point<T, S, DAMP_NONE, false>(r, vt, f2, st, res, cst);
#pragma unroll
  for (int j = 0; j < NV; ++j) vt[j] = v[j] + r.half_ds * f2[j];
  eval_point<T, S, DAMP_NONE, false>(r, vt, f3, st, res, cst);
#pragma unroll
  for (int j = 0; j < NV; ++j) vt[j] = v[j] + r.ds * f3[j];
  eval_point<T, S, DAMP_NONE, false>(r, vt, f4, st, res, cst);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    sum[j] = f1[j] + T(2) * f2[j];
    sum[j] += T(2) * f3[j];
    vn[j] = v[j] + r.sixth_ds * (sum[j] + f4[j]);
    sum[j] += f4[j];
  }

  // --- the cotangents of the step's outputs (step_end): the accepted
  // state, its trajectory row, the endpoint RHS, end_res and max_res
  T gv[NV], gf[NV];
  const int64_t row = (int64_t)i * (n + 1) + k + 1;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    gv[j] = a.cot_v[i * NV + j];
    if (a.traj_cot) gv[j] += a.traj_cot[row * NV + j];
    gf[j] = a.cot_f1[i * NV + j];
  }
  T gres = a.cot_end[i];
  if (a.resid_cot) gres += a.resid_cot[row];
  // torch.maximum(max_res, resid): ties split evenly, a NaN takes both
  const T gm = a.cot_max[i];
  const T m_in = a.stack_max[at];
  const T r_fwd = last ? a.end_out[i] : a.stack_end[next];
  T g_keep;
  if (m_in == r_fwd) {
    g_keep = gm * T(0.5);
    gres += gm * T(0.5);
  } else if (m_in < r_fwd) {
    g_keep = T(0);
    gres += gm;
  } else if (m_in > r_fwd) {
    g_keep = gm;
  } else {
    g_keep = gm;
    gres += gm;
  }

  // --- backwards: the endpoint evaluation with its residual, the RK4 sum
  // v + ds (f1 + 2 f2 + 2 f3 + f4) / 6, then stages 4, 3, 2
  RunCot<T, S> gr{};
  T gp[4];
  eval_point_vjp<T, S, true>(r, false, vn[0], vn[3], vn[4], vn[5], gf, gres, gp, gr);
  gv[0] += gp[0];
  gv[3] += gp[1];
  gv[4] += gp[2];
  gv[5] += gp[3];
  T g1[NV], g2[NV], g3[NV], g4[NV], gds = T(0);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    g1[j] = r.sixth_ds * gv[j];
    g4[j] = g1[j];
    g2[j] = T(2) * g1[j];
    g3[j] = g2[j];
    gds += gv[j] * sum[j];
  }
  gr.ds += gds / T(6);

  // a stage at v + c f evaluated to f_next: slots 0, 3, 4, 5 carry its
  // point's cotangent
  constexpr int kSlots[4] = {0, 3, 4, 5};
#pragma unroll
  for (int j = 0; j < NV; ++j) vt[j] = v[j] + r.ds * f3[j];
  eval_point_vjp<T, S, false>(r, true, vt[0], vt[3], vt[4], vt[5], g4, T(0), gp, gr);
  gds = T(0);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    gv[kSlots[q]] += gp[q];
    g3[kSlots[q]] += r.ds * gp[q];
    gds += gp[q] * f3[kSlots[q]];
  }
  gr.ds += gds;

#pragma unroll
  for (int j = 0; j < NV; ++j) vt[j] = v[j] + r.half_ds * f2[j];
  eval_point_vjp<T, S, false>(r, true, vt[0], vt[3], vt[4], vt[5], g3, T(0), gp, gr);
  gds = T(0);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    gv[kSlots[q]] += gp[q];
    g2[kSlots[q]] += r.half_ds * gp[q];
    gds += gp[q] * f2[kSlots[q]];
  }
  gr.ds += gds / T(2);

#pragma unroll
  for (int j = 0; j < NV; ++j) vt[j] = v[j] + r.half_ds * f1[j];
  eval_point_vjp<T, S, false>(r, true, vt[0], vt[3], vt[4], vt[5], g2, T(0), gp, gr);
  gds = T(0);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    gv[kSlots[q]] += gp[q];
    g1[kSlots[q]] += r.half_ds * gp[q];
    gds += gp[q] * f1[kSlots[q]];
  }
  gr.ds += gds / T(2);

  // --- the carry's cotangents in place (hstate passes through RK4)
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    a.cot_v[i * NV + j] = gv[j];
    a.cot_f1[i * NV + j] = g1[j];
  }
  a.cot_end[i] = T(0);
  a.cot_max[i] = g_keep;
  add_param_cots<T, S>(r, gr, a.acc, B, i);
}

}  // namespace rays
