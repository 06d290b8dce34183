// A double that counts the floating-point operations done on it, for the
// host builds of the kernel bodies (host_shim.cpp, slab_rk4_vjp_host.cpp):
// running a kernel's per-ray function on this type gives the operations
// that its bound is taken from.  Host only; one counter per library.

#pragma once

#include <math.h>
#include <stdint.h>

#include "slab_rk4.cuh"

namespace rays {

// [0] additions and subtractions, [1] multiplications, [2] divisions,
// [3] square roots, [4] exponentials, [5] powers.  Negation, abs,
// comparisons and selects are not counted.  g_again tallies, apart and
// also in g_ops, the operations done between repeat_mark(x, 1) and
// repeat_mark(x, -1): arithmetic a body repeats although the same values
// were computed before (slab_rk4_vjp.cuh), which its bound leaves out.
constexpr int N_OP_KINDS = 6;
static int64_t g_ops[N_OP_KINDS];
static int64_t g_again[N_OP_KINDS];
static int g_again_depth;

inline void tally(int kind) {
  ++g_ops[kind];
  if (g_again_depth > 0) ++g_again[kind];
}

struct Counted {
  double v;
  Counted() : v(0) {}
  explicit Counted(double a) : v(a) {}
  Counted operator-() const { return Counted(-v); }
  Counted& operator+=(Counted b) { tally(0); v += b.v; return *this; }
  Counted& operator-=(Counted b) { tally(0); v -= b.v; return *this; }
  Counted& operator*=(Counted b) { tally(1); v *= b.v; return *this; }
};
inline Counted operator+(Counted a, Counted b) { tally(0); return Counted(a.v + b.v); }
inline Counted operator-(Counted a, Counted b) { tally(0); return Counted(a.v - b.v); }
inline Counted operator*(Counted a, Counted b) { tally(1); return Counted(a.v * b.v); }
inline Counted operator/(Counted a, Counted b) { tally(2); return Counted(a.v / b.v); }
inline bool operator<(Counted a, Counted b) { return a.v < b.v; }
inline bool operator>(Counted a, Counted b) { return a.v > b.v; }
inline bool operator<=(Counted a, Counted b) { return a.v <= b.v; }
inline bool operator>=(Counted a, Counted b) { return a.v >= b.v; }
inline bool operator==(Counted a, Counted b) { return a.v == b.v; }
inline bool operator!=(Counted a, Counted b) { return a.v != b.v; }
inline Counted r_sqrt(Counted a) { tally(3); return Counted(sqrt(a.v)); }
inline Counted r_exp(Counted a) { tally(4); return Counted(exp(a.v)); }
inline Counted r_pow(Counted a, Counted b) { tally(5); return Counted(pow(a.v, b.v)); }
inline Counted r_abs(Counted a) { return Counted(fabs(a.v)); }
template <> inline Counted inv_odd<Counted>(int j) { return Counted(kInvOddHost64[j]); }
inline void repeat_mark(Counted, int d) { g_again_depth += d; }
static_assert(sizeof(SlabRun<Counted>) == sizeof(SlabRun<double>), "Counted is one double");

inline void reset_ops() {
  for (int k = 0; k < N_OP_KINDS; ++k) g_ops[k] = g_again[k] = 0;
  g_again_depth = 0;
}
inline void read_ops(int64_t* ops) {
  for (int k = 0; k < N_OP_KINDS; ++k) ops[k] = g_ops[k];
}
inline void read_again(int64_t* again) {
  for (int k = 0; k < N_OP_KINDS; ++k) again[k] = g_again[k];
}

}  // namespace rays
