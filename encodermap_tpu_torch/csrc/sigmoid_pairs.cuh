// encodermap_tpu_torch/csrc/sigmoid_pairs.cuh
//
// The pair math of every kernel of the port: the sigmoid-loss kernels
// (sigmoid_loss.cu) and both train kernels (fused_train.cu,
// fused_train_cluster.cu), with cheap powers. One side's sketch-map sigmoid
// is
//
//   s(r) = 1 - u^e,   u = 1 + c (r/sig)^a,   e = -b/a,   c = 2^(a/b) - 1,
//
// and the latent gradient needs s'(r)/r = b c (r/sig)^a u^(e-1) / r^2, which
// for a = 2 is b c / sig^2 u^(e-1). The exponents are classified once on the
// host (make_side), so that every power below takes a branch that is the
// same for every thread, and straight-line code unrolled over a thread's
// register tile of pairs:
//
// * an even integer a: (r/sig)^a = (r^2 / sig^2)^(a/2), by squaring, with
//   no sqrt (a Euclidean r^2 = 0 still gives s = 0); any other integer a:
//   (r/sig)^a by squaring after one sqrt; other a: powf.
// * s = 1 - u^e without the cancellation of 1 - u^e where c t is small
//   (sig_s). e = -n (n = 1..16): one reciprocal and products; e = -(n +
//   1/2): one reciprocal square root, products and the reciprocal of
//   1 + u^(1/2); u^(e-1) = u^e / u from the same reciprocal. Other e:
//   1 - powf.
//
// The reciprocal, reciprocal square root and square root are the MUFU
// unit's approximations, one instruction each: rcp.approx.ftz.f32 and
// sqrt.approx.ftz.f32 (PTX ISA: about 1 ulp for the normal inputs they get
// here: u >= 1, periodic r^2 >= 1e-24; a Euclidean r^2 that is zero or
// subnormal gives r = 0) and rsqrtf (2 ulp, CUDA Programming Guide). The
// correctly rounded versions add a refinement and a branch to a slow path
// per value: with them the forward took 23 % (D=3) and 29 % (periodic D=4)
// longer at B=16384 on an H100.
//
// At the default parameters (4.5, 12, 6, 1, 2, 6) that is e = -0.5 on the
// high-D side (one rsqrtf and one reciprocal) and e = -3, e - 1 = -4 on the
// latent side (one reciprocal), where 1 - powf(u, e) takes a powf each.
#pragma once

#include <cmath>
#include <cuda_runtime.h>

enum ExpKind { kPowf = 0, kNegInt = 1, kNegHalf = 2 };

struct SideSig {
  float inv_sig;   // 1 / sig
  float inv_sig2;  // 1 / sig^2
  float a;         // a, for powf
  float c;         // 2^(a/b) - 1
  float e;         // -b/a, for powf
  float dscale;    // b c / sig^2 where a == 2, else b c
  int half_a;      // a / 2 where a is an even integer in [2, 64], else 0
  int int_a;       // a where a is an integer in [1, 64], else 0
  int e_kind;      // ExpKind of e
  int e_n;         // n of e = -n (kNegInt) or e = -(n + 1/2) (kNegHalf)
};

inline SideSig make_side(double sig, double a, double b) {
  SideSig s;
  const double c = std::pow(2.0, a / b) - 1.0, m = b / a;
  s.inv_sig = static_cast<float>(1.0 / sig);
  s.inv_sig2 = static_cast<float>(1.0 / (sig * sig));
  s.a = static_cast<float>(a);
  s.c = static_cast<float>(c);
  s.e = static_cast<float>(-m);
  s.dscale = static_cast<float>(a == 2.0 ? b * c / (sig * sig) : b * c);
  const bool integer_a = a == std::floor(a) && a >= 1.0 && a <= 64.0;
  s.int_a = integer_a ? static_cast<int>(a) : 0;
  s.half_a = integer_a && s.int_a % 2 == 0 ? s.int_a / 2 : 0;
  if (m == std::floor(m) && m >= 1.0 && m <= 16.0) {
    s.e_kind = kNegInt;
    s.e_n = static_cast<int>(m);
  } else if (m - 0.5 == std::floor(m - 0.5) && m >= 0.5 && m <= 16.5) {
    s.e_kind = kNegHalf;
    s.e_n = static_cast<int>(m - 0.5);
  } else {
    s.e_kind = kPowf;
    s.e_n = 0;
  }
  return s;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// x <- x^N for each of the NP values, by repeated squaring in the order
// jax.lax.integer_pow takes (multiply by the running power at each set bit,
// lowest bit first), unrolled at compile time.
template <int N, int NP>
__device__ __forceinline__ void pow_c(float (&x)[NP]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    float base = x[p], acc = 1.f;
    bool have = false;
#pragma unroll
    for (int m = N; m; m >>= 1) {
      if (m & 1) {
        acc = have ? acc * base : base;
        have = true;
      }
      if (m > 1) base *= base;
    }
    x[p] = acc;
  }
}

// x <- x^n (n >= 1). n is the same in every thread: the exponents of the
// usual parameters (a = 4, 6, 8, 12 and e = -2, -3, -4) take straight-line
// code (on an H100 a loop with a branch per bit made the forward 27 % slower
// at the default parameters), others a loop. Few cases keep the code small.
template <int NP>
__device__ __forceinline__ void pow_n(float (&x)[NP], int n) {
  if (n == 1) return;
  if (n == 2) return pow_c<2>(x);
  if (n == 3) return pow_c<3>(x);
  if (n == 4) return pow_c<4>(x);
  if (n == 6) return pow_c<6>(x);
  float base[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) base[p] = x[p];
  bool have = false;
  for (;;) {
    if (n & 1) {
      if (have) {
#pragma unroll
        for (int p = 0; p < NP; ++p) x[p] *= base[p];
      } else {
#pragma unroll
        for (int p = 0; p < NP; ++p) x[p] = base[p];
      }
      have = true;
    }
    n >>= 1;
    if (!n) break;
#pragma unroll
    for (int p = 0; p < NP; ++p) base[p] *= base[p];
  }
}

// t = (r/sig)^a of each pair, in place, from its squared distance. Periodic
// distances keep the reference's sqrt and its 1e-12 after the sqrt.
template <int NP, bool PERIODIC>
__device__ __forceinline__ void sig_t(const SideSig& s, float (&x)[NP]) {
  if (!PERIODIC && s.half_a) {
#pragma unroll
    for (int p = 0; p < NP; ++p) x[p] *= s.inv_sig2;
    pow_n(x, s.half_a);
    return;
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    float r = sqrt_approx(x[p]);
    if (PERIODIC) r += 1e-12f;
    x[p] = r * s.inv_sig;
  }
  if (s.half_a) {  // x^a = (x^2)^(a/2), the same products
#pragma unroll
    for (int p = 0; p < NP; ++p) x[p] *= x[p];
    pow_n(x, s.half_a);
  } else if (s.int_a) {
    pow_n(x, s.int_a);
  } else {
#pragma unroll
    for (int p = 0; p < NP; ++p) x[p] = powf(x[p], s.a);
  }
}

// t -> s = 1 - u^e in place, u = 1 + c t, without the cancellation of
// 1 - u^e where c t is small: e = -n as c t (u^-1 + ... + u^-n), and
// e = -(n + 1/2) adds u^-n (1 - u^-1/2) = u^-n c t u^-1/2 / (1 + u^1/2);
// other e as 1 - powf(u, e), the reference's form. Also y = u^e and
// iu = 1/u. Every kernel that includes this file takes this form: 1 - y
// with the cheap y = u^e, whose 2-ulp error near u = 1 (rsqrtf) has one
// sign on every pair, moved the grid train kernel's parameters 500 times
// further from a float64 run in 100 steps than the plain version's
// 1 - powf (an H100, [128,128,2], B=256, chip_smoke.py's float64 rule).
template <int NP>
__device__ __forceinline__ void sig_s(const SideSig& s, float (&x)[NP], float (&y)[NP],
                                      float (&iu)[NP]) {
  float ct[NP], sum[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) ct[p] = s.c * x[p];
  if (s.e_kind == kPowf) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      y[p] = powf(1.f + ct[p], s.e);
      iu[p] = rcp_approx(1.f + ct[p]);
      x[p] = 1.f - y[p];
    }
    return;
  }
  // x <- u^-1/2 where e = -(n + 1/2)
  if (s.e_kind == kNegHalf) {
#pragma unroll
    for (int p = 0; p < NP; ++p) x[p] = rsqrtf(1.f + ct[p]);
  }
  // iu: a reciprocal of its own where the sum below takes it (u^-1/2
  // squared would give s an error of one sign, ~1 ulp at n = 3), else
  // u^-1/2 squared
  if (s.e_kind == kNegInt || s.e_n) {
#pragma unroll
    for (int p = 0; p < NP; ++p) iu[p] = rcp_approx(1.f + ct[p]);
  } else {
#pragma unroll
    for (int p = 0; p < NP; ++p) iu[p] = x[p] * x[p];
  }
  // sum_{k=1..n} u^-k and y = u^-n
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    sum[p] = 0.f;
    y[p] = 1.f;
  }
  for (int k = 0; k < s.e_n; ++k) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      y[p] *= iu[p];
      sum[p] += y[p];
    }
  }
  if (s.e_kind == kNegHalf) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float rs = x[p];
      const float h = rs * rcp_approx(1.f + (1.f + ct[p]) * rs);  // (1 - u^-1/2) / (c t)
      x[p] = ct[p] * (sum[p] + y[p] * h);
      y[p] *= rs;
    }
  } else {
#pragma unroll
    for (int p = 0; p < NP; ++p) x[p] = ct[p] * sum[p];
  }
}
