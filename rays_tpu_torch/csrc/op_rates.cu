// Op-class throughput microbenchmarks for the H100 (sm_90a): the CUDA
// counterpart of the lax.scan chains of scripts/vpu_roofline.py, which
// measured the TPU's vector unit.  They replace no TPU kernel; they give
// the rates at which tools/op_roofline.py prices the slab RK4 kernel's
// body (fused_slab.count_ops) and the plain path's aten census.
//
// Each thread carries W independent chains (W-way instruction-level
// parallelism) through `iters` iterations of K dependent applications of
// one operation class, in float or double:
//   fma   y = fma(y, 1.0000001, 1e-9)        mul   y = y * 1.0000001
//   add   y = y + 1e-3                        div   y = y + 0.6 / y
//   sqrt  y = y + sqrt(y)                     rsqrt y = y + rsqrt(y)
//   exp   y = y + exp(-y)                     log   y = y + log(y)
//   cube  y = y - y * y * y * 1e-4
// and the matvec kernel applies a per-thread 3x3 matrix: v = 0.25 M v + 0.1.
// No chain has a fixed point that it reaches: the fma and mul chains are
// those of scripts/vpu_roofline.py, and the others add each result to the
// running value (or take it away), so that the output depends on the
// start value of every chain and on every iteration, and a kernel that
// skipped an iteration or a chain would differ from the plain chain (the
// check of utils/op_rates.py and tools/op_roofline.py).  The matvec's M is
// four times a rotation (utils/op_rates.matvec_inputs), for the same reason.
// Element j of thread t lives at [j * n + t] (neighbouring threads on
// neighbouring addresses); each input is read once and each output written
// once, so the bytes never bind: operations do, which is what is measured.
//
// Build with -fmad=false (utils/op_rates.py): only the fma chain fuses, by
// its explicit fma(), so every other chain rounds as the plain PyTorch
// chain of utils/op_rates.py does, operation by operation; the plain fma
// chain rounds once, as the fused one does.  Each launcher
// returns cudaGetLastError() (0 when the launch was accepted), or -1 for a
// combination of class, W and K that is not instantiated.

#include <cuda_runtime.h>

namespace {

enum Op { FMA = 0, MUL, ADD, DIV, SQRT, RSQRT, EXP, LOG, CUBE };

// the float forms by name, so that no float chain is promoted to double
__device__ __forceinline__ float m_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double m_fma(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float m_sqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double m_sqrt(double a) { return sqrt(a); }
__device__ __forceinline__ float m_rsqrt(float a) { return rsqrtf(a); }
__device__ __forceinline__ double m_rsqrt(double a) { return rsqrt(a); }
__device__ __forceinline__ float m_exp(float a) { return expf(a); }
__device__ __forceinline__ double m_exp(double a) { return exp(a); }
__device__ __forceinline__ float m_log(float a) { return logf(a); }
__device__ __forceinline__ double m_log(double a) { return log(a); }

template <typename T, int OP>
__device__ __forceinline__ T apply(T y) {
  if constexpr (OP == FMA) {
    return m_fma(y, T(1.0000001), T(1e-9));
  } else if constexpr (OP == MUL) {
    return y * T(1.0000001);
  } else if constexpr (OP == ADD) {
    return y + T(1e-3);
  } else if constexpr (OP == DIV) {
    return y + T(0.6) / y;
  } else if constexpr (OP == SQRT) {
    return y + m_sqrt(y);
  } else if constexpr (OP == RSQRT) {
    return y + m_rsqrt(y);
  } else if constexpr (OP == EXP) {
    return y + m_exp(-y);
  } else if constexpr (OP == LOG) {
    return y + m_log(y);
  } else {
    return y - y * y * y * T(1e-4);
  }
}

template <typename T, int OP, int W, int K>
__global__ void chain_kernel(const T* __restrict__ x, T* __restrict__ y, int n, int iters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  T v[W];
#pragma unroll
  for (int j = 0; j < W; ++j) v[j] = x[j * n + t];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < W; ++j) v[j] = apply<T, OP>(v[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < W; ++j) y[j * n + t] = v[j];
}

template <typename T>
__global__ void matvec_kernel(const T* __restrict__ m, const T* __restrict__ x,
                              T* __restrict__ y, int n, int iters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  T a[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) a[i] = m[i * n + t];
  T v0 = x[t], v1 = x[n + t], v2 = x[2 * n + t];
  for (int it = 0; it < iters; ++it) {
    const T y0 = a[0] * v0 + a[1] * v1 + a[2] * v2;
    const T y1 = a[3] * v0 + a[4] * v1 + a[5] * v2;
    const T y2 = a[6] * v0 + a[7] * v1 + a[8] * v2;
    v0 = y0 * T(0.25) + T(0.1);
    v1 = y1 * T(0.25) + T(0.1);
    v2 = y2 * T(0.25) + T(0.1);
  }
  y[t] = v0;
  y[n + t] = v1;
  y[2 * n + t] = v2;
}

constexpr int kThreads = 128;

template <typename T, int OP, int W, int K>
int launch(const T* x, T* y, int n, int iters, cudaStream_t stream) {
  chain_kernel<T, OP, W, K><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      x, y, n, iters);
  return static_cast<int>(cudaGetLastError());
}

// every class at W = 8, K = 8 (the class rates); the fma chain also at
// W = 1 and K = 64 (the ILP sweep)
template <typename T>
int launch_chain(int op, int w, int k, const T* x, T* y, int n, int iters,
                 cudaStream_t stream) {
  if (w == 8 && k == 8) {
    switch (op) {
      case FMA: return launch<T, FMA, 8, 8>(x, y, n, iters, stream);
      case MUL: return launch<T, MUL, 8, 8>(x, y, n, iters, stream);
      case ADD: return launch<T, ADD, 8, 8>(x, y, n, iters, stream);
      case DIV: return launch<T, DIV, 8, 8>(x, y, n, iters, stream);
      case SQRT: return launch<T, SQRT, 8, 8>(x, y, n, iters, stream);
      case RSQRT: return launch<T, RSQRT, 8, 8>(x, y, n, iters, stream);
      case EXP: return launch<T, EXP, 8, 8>(x, y, n, iters, stream);
      case LOG: return launch<T, LOG, 8, 8>(x, y, n, iters, stream);
      case CUBE: return launch<T, CUBE, 8, 8>(x, y, n, iters, stream);
      default: return -1;
    }
  }
  if (op != FMA) return -1;
  if (w == 1 && k == 8) return launch<T, FMA, 1, 8>(x, y, n, iters, stream);
  if (w == 1 && k == 64) return launch<T, FMA, 1, 64>(x, y, n, iters, stream);
  if (w == 8 && k == 64) return launch<T, FMA, 8, 64>(x, y, n, iters, stream);
  return -1;
}

template <typename T>
int launch_matvec(const T* m, const T* x, T* y, int n, int iters, cudaStream_t stream) {
  matvec_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(m, x, y, n, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rays_op_chain_f32(int op, int w, int k, const float* x, float* y, int n, int iters,
                      void* stream) {
  return launch_chain<float>(op, w, k, x, y, n, iters, static_cast<cudaStream_t>(stream));
}

int rays_op_chain_f64(int op, int w, int k, const double* x, double* y, int n, int iters,
                      void* stream) {
  return launch_chain<double>(op, w, k, x, y, n, iters, static_cast<cudaStream_t>(stream));
}

int rays_op_matvec_f32(const float* m, const float* x, float* y, int n, int iters,
                       void* stream) {
  return launch_matvec<float>(m, x, y, n, iters, static_cast<cudaStream_t>(stream));
}

int rays_op_matvec_f64(const double* m, const double* x, double* y, int n, int iters,
                       void* stream) {
  return launch_matvec<double>(m, x, y, n, iters, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
