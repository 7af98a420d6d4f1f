// encodermap_tpu_torch/csrc/common.cuh
//
// What the kernel libraries of the port share besides the pair math
// (sigmoid_pairs.cuh): Adam's constants for both train kernels, and the
// error string each Python wrapper raises with.
#pragma once

#include <cmath>
#include <cuda_runtime.h>

// Adam's constants at step t (1-based): b1 = 0.9, b2 = 0.999, and 1 - b1
// and 1 - b2 rounded to float from double, as the plain version
// (ops/fused_train.py::_adam_update) and the JAX package's _adam_update
// take them (1.f - 0.999f is 1.3e-5 away from 0.001f, a one-signed error
// in every second moment); the bias corrections 1 - b^t within 2e-7 of
// the plain version's, taken in double (1.f - powf(0.999f, t) is up to
// 2e-5 off), as -expm1(t log b) with log b rounded from double (a double
// pow on the card took 4 us of a step).
struct AdamStep {
  float b1, b2, c1, c2, bc1, bc2;
};

__device__ __forceinline__ AdamStep adam_step(double t) {
  const float tf = static_cast<float>(t);
  return AdamStep{0.9f,
                  0.999f,
                  static_cast<float>(1.0 - 0.9),
                  static_cast<float>(1.0 - 0.999),
                  -expm1f(tf * -0.105360515657826281f),     // log(0.9)
                  -expm1f(tf * -0.00100050033358353350f)};  // log(0.999)
}

// Each kernel library is one translation unit that includes this header once.
extern "C" const char* em_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
