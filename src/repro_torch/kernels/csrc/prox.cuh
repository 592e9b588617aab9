// Shared prox body of K1 (prox.cu) and K3 (admm_iter.cu).
//
// Replaces repro/kernels/prox/prox.py::_prox_body (the Pallas kernels K1
// and K3 inline the same Python function). One header keeps the two CUDA
// kernels from drifting apart: both instantiate prox_body<KIND>.
//
// Arithmetic follows the reference step for step, in float32:
//   logistic       40 bisection steps on the monotone phi'(y) over
//                  [z - delta, z + delta], then `newton_iters` Newton steps
//                  clamped to [-delta, delta];
//   hinge          z + l * max(min(1 - l z, delta), 0);
//   l1             sign(z) * max(|z| - delta, 0);
//   least_squares  (z + delta b) / (1 + delta);
//   quantile       asymmetric soft-threshold of z - b at level q = param.
// expf and IEEE division are used on purpose (the build passes no
// --use_fast_math): the bisection compares the sign of phi' near its root.
#pragma once

#include <cuda_runtime.h>

namespace repro {

enum ProxKind : int {
  kLogistic = 0,
  kHinge = 1,
  kL1 = 2,
  kLeastSquares = 3,
  kQuantile = 4,
};

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.f / (1.f + expf(-x));
}

template <int KIND>
__device__ __forceinline__ float prox_body(float z, float delta, float aux,
                                           int newton_iters, float param) {
  if (KIND == kLogistic) {
    float lo = z - delta;
    float hi = z + delta;
    for (int i = 0; i < 40; ++i) {
      const float mid = 0.5f * (lo + hi);
      const bool pos =
          (-aux * sigmoid_f32(-aux * mid) + (mid - z) / delta) > 0.f;
      lo = pos ? lo : mid;
      hi = pos ? mid : hi;
    }
    float y = 0.5f * (lo + hi);
    for (int i = 0; i < newton_iters; ++i) {
      const float s = sigmoid_f32(-aux * y);
      const float g = -aux * s + (y - z) / delta;
      const float h = s * (1.f - s) + 1.f / delta;
      y = y - fminf(fmaxf(g / h, -delta), delta);
    }
    return y;
  } else if (KIND == kHinge) {
    return z + aux * fmaxf(fminf(1.f - aux * z, delta), 0.f);
  } else if (KIND == kL1) {
    const float a = fmaxf(fabsf(z) - delta, 0.f);
    return z > 0.f ? a : (z < 0.f ? -a : 0.f);
  } else if (KIND == kLeastSquares) {
    return (z + delta * aux) / (1.f + delta);
  } else {  // kQuantile
    const float q = param;
    const float r0 = z - aux;
    const float r = r0 > delta * q
                        ? r0 - delta * q
                        : (r0 < -delta * (1.f - q) ? r0 + delta * (1.f - q)
                                                   : 0.f);
    return aux + r;
  }
}

}  // namespace repro

// Runs the statement in the variadic arguments with the compile-time
// constant KIND bound to the runtime `kind`; an unknown kind returns
// cudaErrorInvalidValue from the enclosing function.
#define REPRO_DISPATCH_KIND(kind, ...)                                   \
  switch (kind) {                                                        \
    case repro::kLogistic: { constexpr int KIND = 0; __VA_ARGS__; break; }     \
    case repro::kHinge: { constexpr int KIND = 1; __VA_ARGS__; break; }        \
    case repro::kL1: { constexpr int KIND = 2; __VA_ARGS__; break; }           \
    case repro::kLeastSquares: { constexpr int KIND = 3; __VA_ARGS__; break; } \
    case repro::kQuantile: { constexpr int KIND = 4; __VA_ARGS__; break; }     \
    default: return cudaErrorInvalidValue;                               \
  }
