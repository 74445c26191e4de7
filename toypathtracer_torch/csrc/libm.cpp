// Elementwise float32 sinf and cosf of the C library, for the parity route
// of ops/tracecore.py (ops/libm.py builds this with g++ and binds it with
// ctypes).  The reference's scalar C++ calls these functions in its Lambert
// sampler and its light-cone samples (Maths.cpp:39-47, Test.cpp:94-121),
// and its goldens (tests/golden) follow their last bits.  -fno-builtin keeps
// the compiler from folding or merging the calls: each value is the
// library's own.
#include <math.h>
#include <stdint.h>

extern "C" {

void tpt_sinf(const float* x, float* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = sinf(x[i]);
}

void tpt_cosf(const float* x, float* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = cosf(x[i]);
}

}  // extern "C"
