// The VJP of one outer step of the undamped slab RK4 trace, for Hopper
// (sm_90a): one thread per ray, the whole step and its reverse in
// registers (rays::step_vjp, slab_rk4_vjp.cuh, which says what it replaces,
// what bounds it and what its design does about that).  Beside it, the
// same step forward with the adjoint's stack write (rays::step_fwd,
// slab_rk4_step.cuh), the adjoint graph's "step" piece: one library for
// both pieces of a configuration, so the forward adds no build of its own.
//
// Built by tracing/slab_vjp.py with nvcc into a shared library of its own
// (the slab kernel's library and its code are untouched) with a plain C
// interface, called through ctypes: a launcher takes the launch's
// arguments by pointer, passes them to the kernel by value, launches on the
// caller's stream and returns cudaGetLastError().  The adjoint graph
// captures the launches as its "step" and "vjp" pieces and replays each
// once per outer step; the step index and the Params values are read from
// device memory at every replay.  One library holds one instantiation, the
// species count and precision of a configuration (-DRAYS_VJP_SPECIES=1..6,
// -DRAYS_VJP_F64=0 or 1), built when a configuration first asks for it:
// the body is long, and ptxas takes minutes over all twelve.

#include <cuda_runtime.h>

#include "slab_rk4_step.cuh"

// the one instantiation of this library: species and precision
#ifndef RAYS_VJP_SPECIES
#define RAYS_VJP_SPECIES 2
#endif
#ifndef RAYS_VJP_F64
#define RAYS_VJP_F64 1
#endif

namespace {

#if RAYS_VJP_F64
using Real = double;
#else
using Real = float;
#endif

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
slab_rk4_vjp_kernel(const rays::SlabVjpArgs<Real> args) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= args.B) return;
  rays::step_vjp<Real, RAYS_VJP_SPECIES>(args, i);
}

// The forward step has no register cap (B1's is 8 blocks an SM): a step
// of 32,768 rays is 512 blocks, four or fewer an SM whatever the cap, so a
// cap would buy no warps there; uncapped it fits 230 registers without a
// spill (float64, S = 2, PERF.md).
__global__ void __launch_bounds__(kThreads)
slab_rk4_step_kernel(const rays::SlabStepArgs<Real> args) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= args.B) return;
  rays::step_fwd<Real, RAYS_VJP_SPECIES>(args, i);
}

int launch(const rays::SlabVjpArgs<Real>* args, void* stream) {
  const dim3 grid((unsigned)((args->B + kThreads - 1) / kThreads));
  slab_rk4_vjp_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}

int launch_step(const rays::SlabStepArgs<Real>* args, void* stream) {
  const dim3 grid((unsigned)((args->B + kThreads - 1) / kThreads));
  slab_rk4_step_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}

// out[0..3]: threads per block, blocks per SM the runtime grants,
// registers per thread, bytes of local memory per thread
template <typename K>
int occupancy(K kernel, int* out) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc != cudaSuccess) return (int)rc;
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  out[0] = kThreads;
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  return (int)rc;
}

}  // namespace

extern "C" {

int rays_slab_vjp_species() { return RAYS_VJP_SPECIES; }
int rays_slab_vjp_is_f64() { return RAYS_VJP_F64; }
const char* rays_slab_row_names() { return rays::row_names(); }
int rays_slab_vjp_args_size_f64() { return (int)sizeof(rays::SlabVjpArgs<double>); }
int rays_slab_vjp_args_size_f32() { return (int)sizeof(rays::SlabVjpArgs<float>); }

int rays_slab_vjp_f64(const rays::SlabVjpArgs<double>* args, int nspecies, void* stream) {
#if RAYS_VJP_F64
  if (nspecies == RAYS_VJP_SPECIES) return launch(args, stream);
#endif
  return (int)cudaErrorInvalidValue;
}

int rays_slab_vjp_f32(const rays::SlabVjpArgs<float>* args, int nspecies, void* stream) {
#if !RAYS_VJP_F64
  if (nspecies == RAYS_VJP_SPECIES) return launch(args, stream);
#endif
  return (int)cudaErrorInvalidValue;
}

int rays_slab_step_args_size_f64() { return (int)sizeof(rays::SlabStepArgs<double>); }
int rays_slab_step_args_size_f32() { return (int)sizeof(rays::SlabStepArgs<float>); }

int rays_slab_step_f64(const rays::SlabStepArgs<double>* args, int nspecies, void* stream) {
#if RAYS_VJP_F64
  if (nspecies == RAYS_VJP_SPECIES) return launch_step(args, stream);
#endif
  return (int)cudaErrorInvalidValue;
}

int rays_slab_step_f32(const rays::SlabStepArgs<float>* args, int nspecies, void* stream) {
#if !RAYS_VJP_F64
  if (nspecies == RAYS_VJP_SPECIES) return launch_step(args, stream);
#endif
  return (int)cudaErrorInvalidValue;
}

// the occupancy of this library's one instantiation of each kernel
int rays_slab_vjp_occupancy(int* out) { return occupancy(slab_rk4_vjp_kernel, out); }
int rays_slab_step_occupancy(int* out) { return occupancy(slab_rk4_step_kernel, out); }

}  // extern "C"
