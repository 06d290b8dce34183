// Host build of the slab step's VJP (slab_rk4_vjp.cuh) for the CPU tests:
// the same per-ray function as the CUDA kernel, called in a loop over rays,
// behind the launchers' C interface (the stream argument is ignored), so
// tracing/slab_vjp.py drives both the same way.
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC slab_rk4_vjp_host.cpp
//
// Beside the launchers it exports rays_slab_vjp_count_ops: the same step
// on a type that counts its arithmetic (counted.h), all of it and the part
// that repeats values computed before; the kernel's operation bound is
// taken from the rest.

#include <string.h>

#include "counted.h"
#include "slab_rk4_vjp.cuh"

namespace rays {
inline int as_step(Counted k) { return (int)k.v; }
}  // namespace rays

namespace {

template <typename T>
int run_all(const rays::SlabVjpArgs<T>& args, int nspecies) {
#define RAYS_RUN(S) \
  for (int64_t i = 0; i < args.B; ++i) rays::step_vjp<T, S>(args, i)
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

int rays_slab_vjp_args_size_f64() { return (int)sizeof(rays::SlabVjpArgs<double>); }
int rays_slab_vjp_args_size_f32() { return (int)sizeof(rays::SlabVjpArgs<float>); }

int rays_slab_vjp_f64(const rays::SlabVjpArgs<double>* args, int nspecies, void* /*stream*/) {
  return run_all<double>(*args, nspecies);
}

int rays_slab_vjp_f32(const rays::SlabVjpArgs<float>* args, int nspecies, void* /*stream*/) {
  return run_all<float>(*args, nspecies);
}

// The float64 step on the counting type: the same writes, and in
// ops[0..5] the additions, multiplications, divisions, square roots,
// exponentials and powers that these rays did; in ops[6..11] those of
// them that repeated values the step had computed before (repeat_mark).
int rays_slab_vjp_count_ops(const rays::SlabVjpArgs<double>* args, int nspecies, int64_t* ops) {
  static_assert(sizeof(rays::SlabVjpArgs<rays::Counted>) == sizeof(rays::SlabVjpArgs<double>),
                "Counted is one double");
  rays::SlabVjpArgs<rays::Counted> counted;
  memcpy(static_cast<void*>(&counted), args, sizeof counted);
  rays::reset_ops();
  const int rc = run_all<rays::Counted>(counted, nspecies);
  rays::read_ops(ops);
  rays::read_again(ops + rays::N_OP_KINDS);
  return rc;
}

}  // extern "C"
