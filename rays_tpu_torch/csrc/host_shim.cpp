// Host build of the slab RK4 kernel body (slab_rk4.cuh) for the CPU tests:
// the same per-ray function as the CUDA kernel, called in a loop over rays.
// It has the launchers' C interface (the stream argument is ignored), so the
// wrapper in tracing/fused_slab.py drives both the same way.  Like the CUDA
// library, one build holds one damping variant (RAYS_DAMPING).
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -DRAYS_DAMPING=2 host_shim.cpp
//
// Beside the launchers it exports what only a host build can show:
// derive_run on a caller's struct (the tests read every derived field
// back), the kernel's Dawson sum and the untruncated one it must equal,
// and rays_slab_count_ops: the same trajectories on a type that counts
// its arithmetic, from which the kernel's operation bound is taken.

#include <string.h>

#include "counted.h"

#ifndef RAYS_DAMPING
#define RAYS_DAMPING 0
#endif

namespace {

template <typename T, int S>
void run_all(const rays::SlabRun<T>& run, const T* v0, const int32_t* status0, int64_t B,
             T* v_out, int32_t* stop_out, int32_t* npoints_out, T* end_res_out,
             T* max_res_out, T* traj, T* traj_res) {
  for (int64_t i = 0; i < B; ++i)
    rays::trace_one<T, S, RAYS_DAMPING>(run, i, B, v0, status0, v_out, stop_out,
                                        npoints_out, end_res_out, max_res_out, traj, traj_res);
}

// run: with its derived fields filled
template <typename T>
int launch(const rays::SlabRun<T>& run, int nspecies, const T* v0, const int32_t* status0,
           int64_t B, T* v_out, int32_t* stop_out, int32_t* npoints_out, T* end_res_out,
           T* max_res_out, T* traj, T* traj_res) {
#define RAYS_RUN(S) \
  run_all<T, S>(run, v0, status0, B, v_out, stop_out, npoints_out, end_res_out, max_res_out, \
                traj, traj_res)
  switch (nspecies) {
    case 1: RAYS_RUN(1); break;
    case 2: RAYS_RUN(2); break;
    case 3: RAYS_RUN(3); break;
    case 4: RAYS_RUN(4); break;
    case 5: RAYS_RUN(5); break;
    case 6: RAYS_RUN(6); break;
    default: return 1;
  }
#undef RAYS_RUN
  return 0;
}

}  // namespace

extern "C" {

int rays_slab_damping() { return RAYS_DAMPING; }
int rays_slab_run_size_f64() { return (int)sizeof(rays::SlabRun<double>); }
int rays_slab_run_size_f32() { return (int)sizeof(rays::SlabRun<float>); }

int rays_slab_rk4_f64(const rays::SlabRun<double>* run, int nspecies, const double* v0,
                      const int32_t* status0, int64_t B, double* v_out, int32_t* stop_out,
                      int32_t* npoints_out, double* end_res_out, double* max_res_out,
                      double* traj, double* traj_res, void* /*stream*/) {
  rays::SlabRun<double> derived = *run;
  rays::derive_run(derived);
  return launch<double>(derived, nspecies, v0, status0, B, v_out, stop_out, npoints_out,
                        end_res_out, max_res_out, traj, traj_res);
}

int rays_slab_rk4_f32(const rays::SlabRun<float>* run, int nspecies, const float* v0,
                      const int32_t* status0, int64_t B, float* v_out, int32_t* stop_out,
                      int32_t* npoints_out, float* end_res_out, float* max_res_out,
                      float* traj, float* traj_res, void* /*stream*/) {
  rays::SlabRun<float> derived = *run;
  rays::derive_run(derived);
  return launch<float>(derived, nspecies, v0, status0, B, v_out, stop_out, npoints_out,
                       end_res_out, max_res_out, traj, traj_res);
}

// the derived fields of the caller's struct, as the launchers fill them
void rays_slab_derive_run_f64(rays::SlabRun<double>* run) { rays::derive_run(*run); }
void rays_slab_derive_run_f32(rays::SlabRun<float>* run) { rays::derive_run(*run); }

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
int rays_slab_count_ops(const rays::SlabRun<double>* run, int nspecies, const double* v0,
                        const int32_t* status0, int64_t B, double* v_out, int32_t* stop_out,
                        int32_t* npoints_out, double* end_res_out, double* max_res_out,
                        double* traj, double* traj_res, int64_t* ops) {
  using rays::Counted;
  rays::SlabRun<double> derived = *run;
  rays::derive_run(derived);
  rays::SlabRun<Counted> counted;
  memcpy(static_cast<void*>(&counted), &derived, sizeof counted);
  rays::reset_ops();
  const int rc = launch<Counted>(
      counted, nspecies,
      reinterpret_cast<const Counted*>(v0), status0, B, reinterpret_cast<Counted*>(v_out),
      stop_out, npoints_out, reinterpret_cast<Counted*>(end_res_out),
      reinterpret_cast<Counted*>(max_res_out), reinterpret_cast<Counted*>(traj),
      reinterpret_cast<Counted*>(traj_res));
  rays::read_ops(ops);
  return rc;
}

}  // extern "C"
