// Slab ECH RK4 trajectory kernel for Hopper (sm_90a): one thread per ray,
// the whole nstep_max loop inside the thread, the state in registers.
//
// Replaces rays_tpu/tracing/fused_slab.py::trace_batch_fused.  The Pallas
// kernel walked the step axis as a sequential grid dimension over
// (8, 128)-ray tiles in VMEM; here the step axis is the in-thread loop,
// small blocks cover the rays and the ragged edge is masked, not padded.
// The physics and its source notes are in slab_rk4.cuh.
//
// The kernel is scalar arithmetic on a long dependent chain, so what the
// launch decides is how many warps an SM holds to hide that chain's
// latency.  Registers are granted per warp, and whole blocks must fit: a
// block is kThreads = 64 threads (two warps), so nothing is lost to
// rounding, and __launch_bounds__ asks for a number of them per SM, which
// caps the registers per thread at 65,536 / (64 blocks).  The cap is
// chosen per precision and damping variant from timings on the card
// (RAYS_MIN_BLOCKS_* below; tools/slab_rk4_probe.py sweeps them; blocks of
// 32, 64 and 128 threads timed alike at equal registers);
// rays_slab_occupancy reports what the runtime grants.
//
// Built by tracing/fused_slab.py with nvcc into a shared library with a
// plain C interface and called through ctypes: each launcher takes the
// packed run constants and the model codes in host memory, loads them
// with their derived fields (rays::load_run), passes them to the kernel by
// value, launches on the caller's stream and returns cudaGetLastError().
// One library holds one damping variant (-DRAYS_DAMPING=0, 1 or 2,
// rays::DAMP_*) for S = 1..6 at float32 and float64; the three libraries
// build side by side.

#include <cuda_runtime.h>

#include "slab_rk4.cuh"

#ifndef RAYS_DAMPING
#define RAYS_DAMPING 0
#endif

// Launch shape: the blocks per SM that the register cap is set for, per
// precision (this library's damping variant is fixed).
// An SM grants registers to warps four at a time, so what a cap buys is 12
// warps (168 registers), 16 (128), 20 (96), 24 (80) or 32 (64).  Measured
// at S = 2 (PERF.md, Findings): the undamped float64 kernel fits 128
// registers without a spill and with the card filled is a quarter faster
// at 16 warps than at the 8 it gets uncapped; every other instantiation is
// fastest, or within the noise of it, with the registers ptxas asks for.
// The cap is set for S <= 2 only: wider instantiations would spill under
// it and have not been timed.
#ifndef RAYS_MIN_BLOCKS_F64
#if RAYS_DAMPING == 0
#define RAYS_MIN_BLOCKS_F64 8
#else
#define RAYS_MIN_BLOCKS_F64 1
#endif
#endif
#ifndef RAYS_MIN_BLOCKS_F32
#define RAYS_MIN_BLOCKS_F32 1
#endif

namespace {

constexpr int kThreads = 64;

template <typename T> constexpr int min_blocks(int S);
template <> constexpr int min_blocks<double>(int S) { return S <= 2 ? RAYS_MIN_BLOCKS_F64 : 1; }
template <> constexpr int min_blocks<float>(int S) { return S <= 2 ? RAYS_MIN_BLOCKS_F32 : 1; }

template <typename T, int S, int DAMP>
__global__ void __launch_bounds__(kThreads, min_blocks<T>(S))
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

template <typename T, int S>
int launch_s(const T* packed, const int32_t* codes, int32_t nstep_max, int32_t save_trajectory,
             const T* v0, const int32_t* status0, int64_t B, T* v_out, int32_t* stop_out,
             int32_t* npoints_out, T* end_res_out, T* max_res_out, T* traj, T* traj_res,
             cudaStream_t stream) {
  rays::SlabRun<T> run{};
  rays::load_run<T, S>(packed, codes, run);
  run.nstep_max = nstep_max;
  run.save_trajectory = save_trajectory;
  const dim3 grid((unsigned)((B + kThreads - 1) / kThreads));
  slab_rk4_kernel<T, S, RAYS_DAMPING><<<grid, kThreads, 0, stream>>>(
      run, B, v0, status0, v_out, stop_out, npoints_out, end_res_out, max_res_out, traj,
      traj_res);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* packed, const int32_t* codes, int nspecies, int32_t nstep_max,
           int32_t save_trajectory, const T* v0, const int32_t* status0, int64_t B, T* v_out,
           int32_t* stop_out, int32_t* npoints_out, T* end_res_out, T* max_res_out, T* traj,
           T* traj_res, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RAYS_LAUNCH(S)                                                                      \
  launch_s<T, S>(packed, codes, nstep_max, save_trajectory, v0, status0, B, v_out, stop_out, \
                 npoints_out, end_res_out, max_res_out, traj, traj_res, st)
  switch (nspecies) {
    case 1: return RAYS_LAUNCH(1);
    case 2: return RAYS_LAUNCH(2);
    case 3: return RAYS_LAUNCH(3);
    case 4: return RAYS_LAUNCH(4);
    case 5: return RAYS_LAUNCH(5);
    case 6: return RAYS_LAUNCH(6);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RAYS_LAUNCH
}

// out[0..3]: threads per block, the blocks of them that the runtime lets
// one SM hold, registers per thread, bytes of local memory per thread
template <typename T, int S>
int occupancy_of(int* out) {
  const auto kernel = slab_rk4_kernel<T, S, RAYS_DAMPING>;
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

template <typename T>
int occupancy(int nspecies, int* out) {
  switch (nspecies) {
    case 1: return occupancy_of<T, 1>(out);
    case 2: return occupancy_of<T, 2>(out);
    case 3: return occupancy_of<T, 3>(out);
    case 4: return occupancy_of<T, 4>(out);
    case 5: return occupancy_of<T, 5>(out);
    case 6: return occupancy_of<T, 6>(out);
    default: return (int)cudaErrorInvalidValue;
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
                      double* traj, double* traj_res, void* stream) {
  return launch<double>(packed, codes, nspecies, nstep_max, save_trajectory, v0, status0, B,
                        v_out, stop_out, npoints_out, end_res_out, max_res_out, traj, traj_res,
                        stream);
}

int rays_slab_rk4_f32(const float* packed, const int32_t* codes, int nspecies,
                      int32_t nstep_max, int32_t save_trajectory, const float* v0,
                      const int32_t* status0, int64_t B, float* v_out, int32_t* stop_out,
                      int32_t* npoints_out, float* end_res_out, float* max_res_out,
                      float* traj, float* traj_res, void* stream) {
  return launch<float>(packed, codes, nspecies, nstep_max, save_trajectory, v0, status0, B,
                       v_out, stop_out, npoints_out, end_res_out, max_res_out, traj, traj_res,
                       stream);
}

// occupancy of the instantiation that a launch at this precision and
// species count runs; returns a CUDA error code
int rays_slab_occupancy(int is_f64, int nspecies, int* out) {
  return is_f64 ? occupancy<double>(nspecies, out) : occupancy<float>(nspecies, out);
}

}  // extern "C"
