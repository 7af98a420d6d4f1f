// encodermap_tpu_torch/csrc/common.cuh
//
// Shared device code of the port's kernels: the sketch-map sigmoid, its
// derivative over r, and the guarded square root. The same formulas as
// encodermap_tpu_torch/ops/distances.py (sig_value, dsig_over_r,
// sqrt_guard), which the kernels' plain versions use.
#pragma once

#include <cmath>
#include <cuda_runtime.h>

// One sketch-map sigmoid s(r) = 1 - (1 + c (r/sig)^a)^(-b/a), its constants
// computed once on the host in double precision.
struct Sig {
  float sig;       // sigma
  float a;         // exponent a
  int ia;          // a when it is an integer in [1, 32] (powered by products)
  int a_is_2;      // the smooth a == 2 form of s'(r)/r
  float c;         // 2^(a/b) - 1
  float e;         // -b/a
  float e1;        // -b/a - 1
  float bc;        // b * c
  float inv_sig2;  // 1 / sig^2
};

inline Sig make_sig(double sig, double a, double b) {
  Sig s;
  const double c = std::pow(2.0, a / b) - 1.0;
  s.sig = static_cast<float>(sig);
  s.a = static_cast<float>(a);
  s.ia = (a == std::floor(a) && a >= 1.0 && a <= 32.0) ? static_cast<int>(a) : 0;
  s.a_is_2 = a == 2.0;
  s.c = static_cast<float>(c);
  s.e = static_cast<float>(-b / a);
  s.e1 = static_cast<float>(-b / a - 1.0);
  s.bc = static_cast<float>(b * c);
  s.inv_sig2 = static_cast<float>(1.0 / (sig * sig));
  return s;
}

// x^a: integer exponents by repeated squaring (as jax.lax.integer_pow
// computes the JAX package's `x ** 12`), others by powf.
__device__ __forceinline__ float pow_a(float x, const Sig& s) {
  if (s.ia) {
    float r = 1.f, base = x;
    for (int n = s.ia; n; n >>= 1) {
      if (n & 1) r *= base;
      base *= base;
    }
    return r;
  }
  return powf(x, s.a);
}

__device__ __forceinline__ float sig_value(float r, const Sig& s) {
  return 1.f - powf(1.f + s.c * pow_a(r / s.sig, s), s.e);
}

// s'(r)/r; r2 is r*r, exactly zero on the diagonal.
__device__ __forceinline__ float dsig_over_r(float r2, float r, const Sig& s) {
  if (s.a_is_2) return s.bc * s.inv_sig2 * powf(1.f + s.c * r2 * s.inv_sig2, s.e1);
  if (r2 == 0.f) return 0.f;
  const float t = pow_a(r / s.sig, s);
  return s.bc * t * powf(1.f + s.c * t, s.e1) / (r * r);
}

// sqrt with an exact zero where the squared distance is zero.
__device__ __forceinline__ float sqrt_guard(float d2) {
  return d2 == 0.f ? 0.f : sqrtf(d2);
}

// Each kernel library is one translation unit that includes this header once.
extern "C" const char* em_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
