// Host build of the slab RK4 kernel body (slab_rk4.cuh) for the CPU tests:
// the same per-ray function as the CUDA kernel, called in a loop over rays.
// It has the launchers' C interface (the stream argument is ignored), so the
// wrapper in tracing/fused_slab.py drives both the same way.  Like the CUDA
// library, one build holds one damping variant (RAYS_DAMPING).
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -DRAYS_DAMPING=2 host_shim.cpp

#include "slab_rk4.cuh"

#ifndef RAYS_DAMPING
#define RAYS_DAMPING 0
#endif

namespace {

template <typename T, int S>
void run_all(const rays::SlabRun<T>* run, const T* v0, const int32_t* status0, int64_t B,
             T* v_out, int32_t* stop_out, int32_t* npoints_out, T* end_res_out,
             T* max_res_out, T* traj, T* traj_res) {
  for (int64_t i = 0; i < B; ++i)
    rays::trace_one<T, S, RAYS_DAMPING>(*run, i, B, v0, status0, v_out, stop_out,
                                        npoints_out, end_res_out, max_res_out, traj, traj_res);
}

template <typename T>
int launch(const rays::SlabRun<T>* run, int nspecies, const T* v0, const int32_t* status0,
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
  return launch<double>(run, nspecies, v0, status0, B, v_out, stop_out, npoints_out,
                        end_res_out, max_res_out, traj, traj_res);
}

int rays_slab_rk4_f32(const rays::SlabRun<float>* run, int nspecies, const float* v0,
                      const int32_t* status0, int64_t B, float* v_out, int32_t* stop_out,
                      int32_t* npoints_out, float* end_res_out, float* max_res_out,
                      float* traj, float* traj_res, void* /*stream*/) {
  return launch<float>(run, nspecies, v0, status0, B, v_out, stop_out, npoints_out,
                       end_res_out, max_res_out, traj, traj_res);
}

}  // extern "C"
