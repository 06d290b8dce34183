// One outer step of the RK4 trace on the G-EQDSK spline toroid, for Hopper
// (sm_90a): one thread per ray, the adjoint graph's "step" piece
// (rays::toroid_step_fwd, eqdsk_rk4.cuh, which says what it replaces, what bounds
// it and what its design does about that).
//
// Built by tracing/eqdsk_step.py with nvcc into a shared library of its own
// with a plain C interface, called through ctypes: the launcher takes the
// launch's arguments by pointer, passes them to the kernel by value,
// launches on the caller's stream and returns cudaGetLastError().  The
// adjoint graph captures the launch as its "step" piece and replays it once
// per outer step; the step index, the Params values and the cell table are
// read from device memory at every replay.  One library holds one
// instantiation, the species count and precision of a configuration
// (-DRAYS_EQDSK_SPECIES=1..6, -DRAYS_EQDSK_F64=0 or 1), built when a
// configuration first asks for it.

#include <cuda_runtime.h>

#include "eqdsk_rk4.cuh"

// the one instantiation of this library: species and precision
#ifndef RAYS_EQDSK_SPECIES
#define RAYS_EQDSK_SPECIES 2
#endif
#ifndef RAYS_EQDSK_F64
#define RAYS_EQDSK_F64 1
#endif

namespace {

#if RAYS_EQDSK_F64
using Real = double;
#else
using Real = float;
#endif

// 32,768 rays are 512 blocks of 64, about four an SM whatever a register
// cap would allow, so the kernel takes the registers ptxas asks for.
constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
eqdsk_rk4_step_kernel(const rays::EqdskStepArgs<Real> args) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= args.B) return;
  rays::toroid_step_fwd<Real, RAYS_EQDSK_SPECIES>(args, i);
}

int launch(const rays::EqdskStepArgs<Real>* args, void* stream) {
  const dim3 grid((unsigned)((args->B + kThreads - 1) / kThreads));
  eqdsk_rk4_step_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rays_eqdsk_species() { return RAYS_EQDSK_SPECIES; }
const char* rays_eqdsk_row_names() { return rays::toroid_row_names(); }
int rays_eqdsk_step_args_size_f64() { return (int)sizeof(rays::EqdskStepArgs<double>); }
int rays_eqdsk_step_args_size_f32() { return (int)sizeof(rays::EqdskStepArgs<float>); }

int rays_eqdsk_step_f64(const rays::EqdskStepArgs<double>* args, int nspecies, void* stream) {
#if RAYS_EQDSK_F64
  if (nspecies == RAYS_EQDSK_SPECIES) return launch(args, stream);
#endif
  return (int)cudaErrorInvalidValue;
}

int rays_eqdsk_step_f32(const rays::EqdskStepArgs<float>* args, int nspecies, void* stream) {
#if !RAYS_EQDSK_F64
  if (nspecies == RAYS_EQDSK_SPECIES) return launch(args, stream);
#endif
  return (int)cudaErrorInvalidValue;
}

// out[0..3]: threads per block, blocks per SM the runtime grants, registers
// per thread, bytes of local memory per thread
int rays_eqdsk_step_occupancy(int* out) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, eqdsk_rk4_step_kernel);
  if (rc != cudaSuccess) return (int)rc;
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, eqdsk_rk4_step_kernel, kThreads, 0);
  out[0] = kThreads;
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  return (int)rc;
}

}  // extern "C"
