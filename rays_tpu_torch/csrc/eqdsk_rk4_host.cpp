// Host build of the EQDSK toroid's step (eqdsk_rk4.cuh) for the CPU tests:
// the same per-ray function as the CUDA kernel, called in a loop over rays,
// behind the launcher's C interface (the stream argument is ignored), so
// tracing/eqdsk_step.py drives both builds the same way.
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC eqdsk_rk4_host.cpp
//
// Beside the launchers it exports rays_eqdsk_step_count_ops: the same step
// on a type that counts its arithmetic (counted.h), which the kernel's
// operation bound is taken from.

#include <string.h>

#include "counted.h"
#include "eqdsk_rk4.cuh"

namespace rays {
inline int as_step(Counted k) { return (int)k.v; }
inline int32_t as_index(Counted a) { return (int32_t)a.v; }
inline Counted r_floor(Counted a) { return Counted(floor(a.v)); }
}  // namespace rays

namespace {

template <typename T>
int run_all(const rays::EqdskStepArgs<T>& args, int nspecies) {
#define RAYS_RUN(S) \
  for (int64_t i = 0; i < args.B; ++i) rays::toroid_step_fwd<T, S>(args, i)
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

const char* rays_eqdsk_row_names() { return rays::toroid_row_names(); }
int rays_eqdsk_step_args_size_f64() { return (int)sizeof(rays::EqdskStepArgs<double>); }
int rays_eqdsk_step_args_size_f32() { return (int)sizeof(rays::EqdskStepArgs<float>); }

int rays_eqdsk_step_f64(const rays::EqdskStepArgs<double>* args, int nspecies, void* /*stream*/) {
  return run_all<double>(*args, nspecies);
}

int rays_eqdsk_step_f32(const rays::EqdskStepArgs<float>* args, int nspecies, void* /*stream*/) {
  return run_all<float>(*args, nspecies);
}

// The float64 step on the counting type: the same writes, and in ops[0..5]
// the additions, multiplications, divisions, square roots, exponentials and
// powers that these rays did (a floor, like a comparison, is not counted).
int rays_eqdsk_step_count_ops(const rays::EqdskStepArgs<double>* args, int nspecies,
                              int64_t* ops) {
  static_assert(sizeof(rays::EqdskStepArgs<rays::Counted>) == sizeof(rays::EqdskStepArgs<double>),
                "Counted is one double");
  rays::EqdskStepArgs<rays::Counted> counted;
  memcpy(static_cast<void*>(&counted), args, sizeof counted);
  rays::reset_ops();
  const int rc = run_all<rays::Counted>(counted, nspecies);
  rays::read_ops(ops);
  return rc;
}

}  // extern "C"
