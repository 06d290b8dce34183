// Host build of the slab RK4 kernel body (slab_rk4.cuh) for the CPU tests:
// the same per-ray function as the CUDA kernel, called in a loop over rays.
// It has the launchers' C interface (the stream argument is ignored), so the
// wrapper in tracing/fused_slab.py drives both the same way.  Like the CUDA
// library, one build holds one damping variant (RAYS_DAMPING).
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -DRAYS_DAMPING=2 host_shim.cpp
//
// Beside the launchers it exports what only a host build can show: the
// run constants as load_run fills them (the tests read every field back),
// the kernel's Dawson sum and the untruncated one it must equal, and
// rays_slab_count_ops: the same trajectories on a type that counts its
// arithmetic, from which the kernel's operation bound is taken.

#include <string.h>

#include "counted.h"

#ifndef RAYS_DAMPING
#define RAYS_DAMPING 0
#endif

namespace {

// The run constants of S species that B1's launchers pass to the kernel:
// loaded in L, then as T (the counting type loads in double, as the
// float64 kernel does).
template <typename T, int S, typename L = T>
rays::SlabRun<T> run_of(const L* packed, const int32_t* codes, int32_t nstep_max,
                        int32_t save_trajectory) {
  static_assert(sizeof(rays::SlabRun<T>) == sizeof(rays::SlabRun<L>), "one layout");
  rays::SlabRun<L> loaded{};
  rays::load_run<L, S>(packed, codes, loaded);
  loaded.nstep_max = nstep_max;
  loaded.save_trajectory = save_trajectory;
  rays::SlabRun<T> run;
  memcpy(static_cast<void*>(&run), &loaded, sizeof run);
  return run;
}

// the rays' trajectories, one after the other, on T
template <typename T, typename L = T>
int launch(const L* packed, const int32_t* codes, int nspecies, int32_t nstep_max,
           int32_t save_trajectory, const T* v0, const int32_t* status0, int64_t B, T* v_out,
           int32_t* stop_out, int32_t* npoints_out, T* end_res_out, T* max_res_out, T* traj,
           T* traj_res) {
#define RAYS_RUN(S)                                                                        \
  {                                                                                        \
    const auto run = run_of<T, S>(packed, codes, nstep_max, save_trajectory);             \
    for (int64_t i = 0; i < B; ++i)                                                        \
      rays::trace_one<T, S, RAYS_DAMPING>(run, i, B, v0, status0, v_out, stop_out,         \
                                          npoints_out, end_res_out, max_res_out, traj,     \
                                          traj_res);                                       \
    return 0;                                                                              \
  }
  switch (nspecies) {
    case 1: RAYS_RUN(1)
    case 2: RAYS_RUN(2)
    case 3: RAYS_RUN(3)
    case 4: RAYS_RUN(4)
    case 5: RAYS_RUN(5)
    case 6: RAYS_RUN(6)
    default: return 1;
  }
#undef RAYS_RUN
}

// SlabRun's fields as load_run fills them: every row's field in the
// packed vector's order, then the derived fields and the model codes
template <typename T, int S>
int read_run(const T* packed, const int32_t* codes, T* out) {
  rays::SlabRun<T> r{};
  rays::load_run<T, S>(packed, codes, r);
  int n = 0;
#define RAYS_OUT(name) out[n++] = T(r.name);
#define RAYS_OUT_S(name) \
  for (int s = 0; s < S; ++s) out[n++] = T(r.name[s]);
  RAYS_DIFF_ROWS(RAYS_OUT) RAYS_DIFF_SPECIES_ROWS(RAYS_OUT_S)
  RAYS_FWD_ROWS(RAYS_OUT) RAYS_FWD_SPECIES_ROWS(RAYS_OUT_S)
  RAYS_OUT(inv_k0) RAYS_OUT(inv_k0sq) RAYS_OUT(inv_omgrf) RAYS_OUT(inv_rmaj) RAYS_OUT(inv_rmin)
  RAYS_OUT(inv_lby) RAYS_OUT(inv_lbz) RAYS_OUT(inv_ln) RAYS_OUT(inv_lt) RAYS_OUT(gauss_coef)
  RAYS_OUT(half_ds) RAYS_OUT(sixth_ds) RAYS_OUT(omgc_coef) RAYS_OUT(two_over_ms0)
  RAYS_OUT(inv_clight) RAYS_OUT_S(alpha_w2) RAYS_OUT_S(gamma_w) RAYS_OUT_S(dn_linear)
  RAYS_OUT(by_model) RAYS_OUT(bz_model) RAYS_OUT(dens_model) RAYS_OUT(time_param)
  RAYS_OUT_S(t_model)
#undef RAYS_OUT_S
#undef RAYS_OUT
  return n;
}

template <typename T>
int read_run(const T* packed, const int32_t* codes, int nspecies, T* out) {
  switch (nspecies) {
    case 1: return read_run<T, 1>(packed, codes, out);
    case 2: return read_run<T, 2>(packed, codes, out);
    case 3: return read_run<T, 3>(packed, codes, out);
    case 4: return read_run<T, 4>(packed, codes, out);
    case 5: return read_run<T, 5>(packed, codes, out);
    case 6: return read_run<T, 6>(packed, codes, out);
    default: return -1;
  }
}

}  // namespace

extern "C" {

int rays_slab_damping() { return RAYS_DAMPING; }
const char* rays_slab_row_names() { return rays::row_names(); }

int rays_slab_rk4_f64(const double* packed, const int32_t* codes, int nspecies,
                      int32_t nstep_max, int32_t save_trajectory, const double* v0,
                      const int32_t* status0, int64_t B, double* v_out, int32_t* stop_out,
                      int32_t* npoints_out, double* end_res_out, double* max_res_out,
                      double* traj, double* traj_res, void* /*stream*/) {
  return launch<double>(packed, codes, nspecies, nstep_max, save_trajectory, v0, status0, B,
                        v_out, stop_out, npoints_out, end_res_out, max_res_out, traj, traj_res);
}

int rays_slab_rk4_f32(const float* packed, const int32_t* codes, int nspecies,
                      int32_t nstep_max, int32_t save_trajectory, const float* v0,
                      const int32_t* status0, int64_t B, float* v_out, int32_t* stop_out,
                      int32_t* npoints_out, float* end_res_out, float* max_res_out,
                      float* traj, float* traj_res, void* /*stream*/) {
  return launch<float>(packed, codes, nspecies, nstep_max, save_trajectory, v0, status0, B,
                       v_out, stop_out, npoints_out, end_res_out, max_res_out, traj, traj_res);
}

// the run's fields (read_run) into out; returns how many, or -1
int rays_slab_read_run_f64(const double* packed, const int32_t* codes, int nspecies,
                           double* out) {
  return read_run<double>(packed, codes, nspecies, out);
}
int rays_slab_read_run_f32(const float* packed, const int32_t* codes, int nspecies,
                           float* out) {
  return read_run<float>(packed, codes, nspecies, out);
}

// the kernel's Dawson sum (full = 0) or all its terms (full = 1), n values
void rays_dawsn_f64(const double* x, double* out, int64_t n, int full) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = full ? rays::dawsn_full<double>(x[i]) : rays::dawsn<double>(x[i]);
}
void rays_dawsn_f32(const float* x, float* out, int64_t n, int full) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = full ? rays::dawsn_full<float>(x[i]) : rays::dawsn<float>(x[i]);
}

// The float64 trajectories on the counting type: the same outputs, and in
// ops[0..5] the additions, multiplications, divisions, square roots,
// exponentials and powers that these rays needed.
int rays_slab_count_ops(const double* packed, const int32_t* codes, int nspecies,
                        int32_t nstep_max, const double* v0, const int32_t* status0, int64_t B,
                        double* v_out, int32_t* stop_out, int32_t* npoints_out,
                        double* end_res_out, double* max_res_out, int64_t* ops) {
  using rays::Counted;
  rays::reset_ops();
  const int rc = launch<Counted, double>(
      packed, codes, nspecies, nstep_max, 0, reinterpret_cast<const Counted*>(v0), status0, B,
      reinterpret_cast<Counted*>(v_out), stop_out, npoints_out,
      reinterpret_cast<Counted*>(end_res_out), reinterpret_cast<Counted*>(max_res_out), nullptr,
      nullptr);
  rays::read_ops(ops);
  return rc;
}

}  // extern "C"
