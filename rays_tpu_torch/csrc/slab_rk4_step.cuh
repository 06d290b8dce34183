// One outer step of the undamped slab RK4 trace, per ray, on the adjoint
// graph's static buffers: tracing/trace.step on the slab kernel's
// configurations without damping (tracing/fused_slab.supported,
// damping_model 'no_damp'), with the adjoint's stack write before it.
//
// Replaces, inside the adjoint graph's forward (tracing/graphed_adjoint.py,
// the "step" piece), the index_copy_ of the carry into the stack and the
// captured trace.step: about 1,250 library kernels of a microsecond or two
// per outer step at 32,768 rays, launch-bound, where this is one launch.
// Its plain version is that generic piece, and the tests hold this body to
// it through the host build (slab_rk4_vjp_host.cpp).
//
// For outer step k (read from device memory at every launch), ray i reads
// its carry (v, f1, st1, hstate, status, nstep, end_res, max_res), writes
// it into the stack at row k in the stack's layout (what the slab VJP,
// slab_rk4_vjp.cuh, reads back), and steps: step_start's s_max stop, RK4
// stages 2-4 by rk4_stages (the same function as the VJP's recompute, so
// forward and backward run one arithmetic, the slab kernel's), the
// endpoint evaluation with check_save (the next step's first stage), and
// step_end's acceptance.  The carry after the step is written in place;
// with trajectories, row k + 1 of the trajectory and of the residual too
// (zero where the ray did not step, as trace.step_end writes them).  A
// ray that is stopped does no arithmetic: its carry is copied to the stack
// and written back unchanged.
//
// Params come from the packed device vector that the slab VJP keeps
// (tracing/slab_vjp.py, in slab_rk4.cuh's layout), and load_run derives
// their fields here, so a captured launch answers for the Params of each
// run and nothing is read on the host.  What bounds it on an H100 is what
// bounds the slab kernel: the arithmetic of four evaluations and the
// latency of its dependent chain; the carry and the stack row are ~0.3 KB
// a ray, microseconds at the card's memory rate.

#pragma once

#include "slab_rk4_vjp.cuh"

namespace rays {

// What one launch reads and writes; the wrapper fills it once per loop
// (the buffers are static) and passes it by pointer, the launcher to the
// kernel by value.  The carry's buffers are (B, ...), the stacks (nstep_max,
// B, ...); traj (B, nstep_max + 1, 7) and resid (B, nstep_max + 1), or null
// without trajectories; params: the packed run constants (slab_rk4.cuh).
template <typename T>
struct SlabStepArgs {
  const T* params;
  const T* k;
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
  int32_t codes[N_CODES];
};

// Outer step k (read from a.k) for ray i (header comment).
template <typename T, int S>
RAYS_HD void step_fwd(const SlabStepArgs<T>& a, int64_t i) {
  constexpr int NV = state_width<S, DAMP_NONE>();
  const int k = as_step(a.k[0]);
  const int64_t B = a.B;
  const int64_t at = (int64_t)k * B + i;

  T v[NV], f1[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    v[j] = a.v[i * NV + j];
    f1[j] = a.f1[i * NV + j];
  }
  int32_t st1 = a.st1[i], status = a.status[i], nstep = a.nstep[i];
  T end_res = a.end_res[i], max_res = a.max_res[i];

  // --- the carry before the step into the stack (the adjoint's index_copy_)
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
    SlabRun<T> r{};
    load_run<T, S>(a.params, a.codes, r);
    // step_start: sout = (k + 1) ds past s_max stops the ray
    if (T(k + 1) * r.ds > r.s_max) {
      status = ST_SOUT_GT_SMAX;
    } else {
      T f2[NV], f3[NV], f4[NV], sum[NV], vn[NV];
      const int32_t st = rk4_stages<T, S>(r, v, f1, f2, f3, f4, sum, vn);
      const int32_t solver_st = st1 != 0 ? st1 : st;
      if (solver_st != 0) {
        status = solver_st;
      } else {
        // the endpoint: check_save, and the next step's first stage
        T fn[NV];
        int32_t st_n, chk;
#pragma unroll
        for (int j = 0; j < NV; ++j) fn[j] = T(0);
        eval_point<T, S, DAMP_NONE, true>(r, vn, fn, st_n, resid, chk);
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

  // --- the carry after the step, in place (hstate passes through RK4)
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
