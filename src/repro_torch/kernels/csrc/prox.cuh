// Shared prox body of K1 (prox.cu) and K3 (admm_iter.cu), and the per-row
// loss value K3 sums for the stopping rule (value_body).
//
// Replaces repro/kernels/prox/prox.py::_prox_body (the Pallas kernels K1
// and K3 inline the same Python function). One header keeps the two CUDA
// kernels from drifting apart: both instantiate prox_body<KIND>.
//
// The closed forms follow the reference step for step, in float32:
//   hinge          z + l * max(min(1 - l z, delta), 0);
//   l1             sign(z) * max(|z| - delta, 0);
//   least_squares  (z + delta b) / (1 + delta);
//   quantile       asymmetric soft-threshold of z - b at level q = param.
// The logistic prox computes the reference's function, the root of the
// strictly increasing phi'(y) = -a sigmoid(-a y) + (y - z) / delta
// followed by `newton_iters` Newton steps clamped to [-delta, delta], by a
// shorter chain than the reference's 40 bisection steps (logistic_root).
// The clamped steps are the reference's own, with IEEE expf and division
// (the build passes no --use_fast_math), so the root is settled by the
// same arithmetic as the reference's last steps.
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

// Newton steps in all, before the clamped ones and with them: from a start
// within 1 of the root, four steps reach the float32 rounding band of the
// root (tests/test_torch_prox.py holds this at newton_iters = 0); five
// leave a margin.
constexpr int kLogisticNewtonSteps = 5;

// The root of phi'(y) = -a sigmoid(-a y) + (y - z) / delta, in four steps:
//   1. a bracket from one expf: with y1 = z + delta a sigmoid(-a z), phi'(z)
//      has the sign of -a and phi'(y1) the other sign or 0, so the root
//      lies between z and y1 (y = z for a = 0); intersected with the
//      reference's [z - delta, z + delta]. Its width is at most
//      delta sigmoid(-a z), small on rows the model already classifies;
//   2. bisection until the width is at most 1: as many steps as halvings
//      take delta to 1 (4 at delta = 10), the same count for every row of a
//      launch, so no warp diverges. The sign test has no division:
//      sign phi'(y) = sign((y - z)(1 + e^{a y}) - delta a) for delta > 0;
//   3. the start: phi' is convex for y < 0 and concave for y > 0 (any
//      a != 0), and phi'(0) < 0 exactly when z > -delta a / 2, i.e. the
//      root is positive. Newton converges monotonically from the left of a
//      root in the concave part and from the right of one in the convex
//      part, never leaving the bracket: start at max(lo, 0) or min(hi, 0);
//   4. Newton steps from there; the count makes kLogisticNewtonSteps with
//      the clamped steps that follow, and at least 2. Fast reciprocal and
//      division: a step's rounding moves where the next step starts, not
//      where the steps settle.
__device__ __forceinline__ float logistic_root(float z, float delta, float a,
                                               int newton_iters) {
  const float da = delta * a;
  const float y1 = z + da * __fdividef(1.f, 1.f + expf(a * z));
  float lo = fmaxf(fminf(z, y1), z - delta);
  float hi = fminf(fmaxf(z, y1), z + delta);
  int nb = 0;
  for (float w = delta; w > 1.f && nb < 128; w *= 0.5f) ++nb;
  for (int i = 0; i < nb; ++i) {
    const float mid = 0.5f * (lo + hi);
    const bool pos = (mid - z) * (1.f + expf(a * mid)) > da;
    lo = pos ? lo : mid;
    hi = pos ? mid : hi;
  }
  float y = z > -0.5f * da ? fmaxf(lo, 0.f) : fminf(hi, 0.f);
  const float inv = 1.f / delta;
  const float a2 = a * a;
  const int steps = max(2, kLogisticNewtonSteps - newton_iters);
  for (int i = 0; i < steps; ++i) {
    const float s = __fdividef(1.f, 1.f + expf(a * y));
    const float g = fmaf(-a, s, (y - z) * inv);
    const float h = fmaf(a2 * s, 1.f - s, inv);
    y -= __fdividef(g, h);
  }
  return y;
}

template <int KIND>
__device__ __forceinline__ float prox_body(float z, float delta, float aux,
                                           int newton_iters, float param) {
  if (KIND == kLogistic) {
    float y = logistic_root(z, delta, aux, newton_iters);
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

// One row's loss value f(z), as core/prox.py's `value` computes it, before
// the outer scale that hinge (C) and l1 (mu) put on their sums: the caller
// multiplies the summed value by it once.
//   logistic       softplus(-a z), the input itself above 20 (torch's
//                  threshold: log1p(e^t) - t < 2.1e-9 there);
//   hinge          max(0, 1 - a z);
//   l1             |z|;
//   least_squares  0.5 (z - a)^2;
//   quantile       q r if r >= 0 else (q - 1) r, r = z - a.
template <int KIND>
__device__ __forceinline__ float value_body(float z, float aux, float param) {
  if (KIND == kLogistic) {
    const float t = -aux * z;
    return t > 20.f ? t : log1pf(expf(t));
  } else if (KIND == kHinge) {
    return fmaxf(1.f - aux * z, 0.f);
  } else if (KIND == kL1) {
    return fabsf(z);
  } else if (KIND == kLeastSquares) {
    const float r = z - aux;
    return 0.5f * (r * r);
  } else {  // kQuantile
    const float r = z - aux;
    return r >= 0.f ? param * r : (param - 1.f) * r;
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
