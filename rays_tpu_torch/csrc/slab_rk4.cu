// Slab ECH RK4 trajectory kernel for Hopper (sm_90a): one thread per ray,
// the whole nstep_max loop inside the thread, the state in registers.
//
// Replaces rays_tpu/tracing/fused_slab.py::trace_batch_fused.  The Pallas
// kernel walked the step axis as a sequential grid dimension over
// (8, 128)-ray tiles in VMEM; here the step axis is the in-thread loop,
// blocks of 128 threads cover the rays and the ragged edge is masked, not
// padded.  The physics and its source notes are in slab_rk4.cuh.
//
// Built by tracing/fused_slab.py with nvcc into a shared library with a
// plain C interface and called through ctypes: each launcher takes the run
// constants by pointer, passes them to the kernel by value, launches on the
// caller's stream and returns cudaGetLastError().  One library holds one
// damping variant (-DRAYS_DAMPING=0, 1 or 2, rays::DAMP_*) for S = 1..6 at
// float32 and float64; the three libraries build side by side.

#include <cuda_runtime.h>

#include "slab_rk4.cuh"

#ifndef RAYS_DAMPING
#define RAYS_DAMPING 0
#endif

namespace {

constexpr int kThreads = 128;

template <typename T, int S, int DAMP>
__global__ void __launch_bounds__(kThreads)
slab_rk4_kernel(const rays::SlabRun<T> run, int64_t B, const T* __restrict__ v0,
                const int32_t* __restrict__ status0, T* __restrict__ v_out,
                int32_t* __restrict__ stop_out, int32_t* __restrict__ npoints_out,
                T* __restrict__ end_res_out, T* __restrict__ max_res_out,
                T* __restrict__ traj, T* __restrict__ traj_res) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  rays::trace_one<T, S, DAMP>(run, i, B, v0, status0, v_out, stop_out, npoints_out,
                              end_res_out, max_res_out, traj, traj_res);
}

template <typename T>
int launch(const rays::SlabRun<T>* run, int nspecies, const T* v0, const int32_t* status0,
           int64_t B, T* v_out, int32_t* stop_out, int32_t* npoints_out, T* end_res_out,
           T* max_res_out, T* traj, T* traj_res, void* stream) {
  const dim3 grid((unsigned)((B + kThreads - 1) / kThreads));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RAYS_LAUNCH(S)                                                                  \
  slab_rk4_kernel<T, S, RAYS_DAMPING><<<grid, kThreads, 0, st>>>(                    \
      *run, B, v0, status0, v_out, stop_out, npoints_out, end_res_out, max_res_out, traj, \
      traj_res)
  switch (nspecies) {
    case 1: RAYS_LAUNCH(1); break;
    case 2: RAYS_LAUNCH(2); break;
    case 3: RAYS_LAUNCH(3); break;
    case 4: RAYS_LAUNCH(4); break;
    case 5: RAYS_LAUNCH(5); break;
    case 6: RAYS_LAUNCH(6); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RAYS_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rays_slab_damping() { return RAYS_DAMPING; }
int rays_slab_run_size_f64() { return (int)sizeof(rays::SlabRun<double>); }
int rays_slab_run_size_f32() { return (int)sizeof(rays::SlabRun<float>); }

int rays_slab_rk4_f64(const rays::SlabRun<double>* run, int nspecies, const double* v0,
                      const int32_t* status0, int64_t B, double* v_out, int32_t* stop_out,
                      int32_t* npoints_out, double* end_res_out, double* max_res_out,
                      double* traj, double* traj_res, void* stream) {
  return launch<double>(run, nspecies, v0, status0, B, v_out, stop_out, npoints_out,
                        end_res_out, max_res_out, traj, traj_res, stream);
}

int rays_slab_rk4_f32(const rays::SlabRun<float>* run, int nspecies, const float* v0,
                      const int32_t* status0, int64_t B, float* v_out, int32_t* stop_out,
                      int32_t* npoints_out, float* end_res_out, float* max_res_out,
                      float* traj, float* traj_res, void* stream) {
  return launch<float>(run, nspecies, v0, status0, B, v_out, stop_out, npoints_out,
                       end_res_out, max_res_out, traj, traj_res, stream);
}

}  // extern "C"
