// encodermap_tpu_torch/csrc/backmap_one_way.cu
//
// One half-chain of the backmap (ops/backmap.py::_OneWay), forward and
// backward, for Hopper (sm_90a): (B, n) dihedrals and (B, n + 3, 3) planar
// coordinates in, the curled (B, n + 3, 3) coordinates out, and the
// hand-derived adjoint of _OneWay's docstring.
//
// Replaces no TPU kernel: the JAX package's _one_way is plain jnp under a
// custom_vjp, which XLA fuses. The port's plain version (_one_way_fwd_plain,
// _one_way_bwd_plain) is about 140 small tensor operations a call, each a
// launch of a few microseconds on the card for work of a few kFLOP per
// sample; these two kernels do the same work in one launch each.
//
// What bounds them: neither bytes (a few hundred bytes a sample) nor
// operations (a few thousand a sample), but the latency of a chain: the
// cumulative quaternion product C_i = q_0 ⊗ ... ⊗ q_i and the suffix sums
// of the backward are scans along the chain, and each step of a scan waits
// for the one before it.
//
// Design: one warp per sample, and the lanes walk the chain in tiles of 32
// bonds (bond k = atom k + 2 minus atom k + 1, k = 0..n; bond n has no
// dihedral and takes the identity rotation, then C_{n-1}: the last atom
// shares the rotation of the one before it).
//
// * Forward: each lane builds its bond, axis length and q_k = (cos(d/2),
//   sin(d/2) a_k); a Hillis-Steele warp scan (__shfl_up_sync at offsets
//   1, 2, 4, 8, 16) composes C[k - off] ⊗ C[k], the earlier product on the
//   left. That is _cumulative_quats' doubling rounds, so up to 32 dihedrals
//   associate as the plain version does; a longer chain carries lane 31's
//   product into the next tile as carry ⊗ C[k]. The rotated bonds r_k and
//   their prefix sums (a second warp scan, with a carried offset) give the
//   moved atoms; atoms 0 and 1 are copied. C_0..C_{n-1} are saved for the
//   backward ((B, n, 4)); the rest it recomputes from its inputs.
// * Backward: the same layout, walking the tiles from the end, in one pass:
//   reversed warp scans (__shfl_down_sync) with a carry for the suffix sums
//   G_k = sum_{m>=k} g_{m+2}, sum r x G and sum r G^T; the bond pullback
//   b_bar = R_k^T G_k, the torsion pullback d_bar, N = R_k^T M R_{k-1},
//   a_bar and u_bar as _OneWay's docstring derives them; and the planar
//   cotangent v, each lane writing atom k + 2 from its own b_bar and u_bar
//   and those of bond k + 1, taken by shuffle or, at the tile's edge, from
//   the carry of the tile after it. No atomics: two runs give the same bits.
//
// Any B and n >= 1; float and double (every sum and product in the tensors'
// type, no fast math; float's sin and cos are rounded from double, see
// sin_cos); inputs with any strides, outputs contiguous.
#include "common.cuh"

namespace {

constexpr int kWarps = 2;  // samples (warps) per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Quat {
  T w, x, y, z;
};

template <typename T>
struct Vec {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ Vec<T> operator+(const Vec<T>& a, const Vec<T>& b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}

template <typename T>
__device__ __forceinline__ Vec<T> operator-(const Vec<T>& a, const Vec<T>& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

template <typename T>
__device__ __forceinline__ Vec<T> scale(T s, const Vec<T>& a) {
  return {s * a.x, s * a.y, s * a.z};
}

template <typename T>
__device__ __forceinline__ T dot(const Vec<T>& a, const Vec<T>& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

template <typename T>
__device__ __forceinline__ Vec<T> cross(const Vec<T>& a, const Vec<T>& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// sin and cos rounded to the type. For float they are taken in double and
// rounded once: sincosf errs by up to 2 ulp, and errors of one sign lengthen
// or shorten every q_k a little, a drift of |C_k| that the cumulative
// product carries down the chain. At 236 bonds, B=256, the kernels parted
// from the CPU's plain version by 1.25e-5 of the largest coordinate with
// sincosf and by 3.5e-6 with these (the CPU's own distance from float64 is
// 3.2e-6).
__device__ __forceinline__ void sin_cos(float x, float* s, float* c) {
  double sd, cd;
  sincos(static_cast<double>(x), &sd, &cd);
  *s = static_cast<float>(sd);
  *c = static_cast<float>(cd);
}
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

// f ⊗ g (R(f ⊗ g) = R(f) R(g)), as ops/backmap.py::_quat_compose
template <typename T>
__device__ __forceinline__ Quat<T> compose(const Quat<T>& f, const Quat<T>& g) {
  const Vec<T> fv{f.x, f.y, f.z}, gv{g.x, g.y, g.z};
  const Vec<T> v = scale(f.w, gv) + scale(g.w, fv) + cross(fv, gv);
  return {f.w * g.w - dot(fv, gv), v.x, v.y, v.z};
}

template <typename T>
__device__ __forceinline__ Quat<T> conj(const Quat<T>& q) {
  return {q.w, -q.x, -q.y, -q.z};
}

// v rotated by q = (w, r): v + w t + r x t, t = 2 r x v (_quat_rotate)
template <typename T>
__device__ __forceinline__ Vec<T> rotate(const Quat<T>& q, const Vec<T>& v) {
  const Vec<T> r{q.x, q.y, q.z};
  const Vec<T> t = scale(T(2), cross(r, v));
  return v + scale(q.w, t) + cross(r, t);
}

template <typename T>
__device__ __forceinline__ Quat<T> shfl_up(const Quat<T>& q, int d) {
  return {__shfl_up_sync(kFull, q.w, d), __shfl_up_sync(kFull, q.x, d),
          __shfl_up_sync(kFull, q.y, d), __shfl_up_sync(kFull, q.z, d)};
}

template <typename T>
__device__ __forceinline__ Quat<T> shfl(const Quat<T>& q, int lane) {
  return {__shfl_sync(kFull, q.w, lane), __shfl_sync(kFull, q.x, lane),
          __shfl_sync(kFull, q.y, lane), __shfl_sync(kFull, q.z, lane)};
}

template <typename T>
__device__ __forceinline__ Vec<T> shfl_up(const Vec<T>& v, int d) {
  return {__shfl_up_sync(kFull, v.x, d), __shfl_up_sync(kFull, v.y, d),
          __shfl_up_sync(kFull, v.z, d)};
}

template <typename T>
__device__ __forceinline__ Vec<T> shfl_down(const Vec<T>& v, int d) {
  return {__shfl_down_sync(kFull, v.x, d), __shfl_down_sync(kFull, v.y, d),
          __shfl_down_sync(kFull, v.z, d)};
}

template <typename T>
__device__ __forceinline__ Vec<T> shfl(const Vec<T>& v, int lane) {
  return {__shfl_sync(kFull, v.x, lane), __shfl_sync(kFull, v.y, lane),
          __shfl_sync(kFull, v.z, lane)};
}

// Inclusive suffix sums within the warp: lane i gets sum_{j >= i} x_j.
template <typename T>
__device__ __forceinline__ Vec<T> suffix_scan(Vec<T> x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const Vec<T> e = shfl_down(x, off);
    if (lane + off < 32) x = x + e;
  }
  return x;
}

// A row of (B, atoms, 3) with the strides of its tensor.
template <typename T>
struct Atoms {
  const T* p;
  long long sa, sx;
  __device__ __forceinline__ Vec<T> operator[](int j) const {
    const T* a = p + j * sa;
    return {a[0], a[sx], a[2 * sx]};
  }
};

template <typename T>
__device__ __forceinline__ void store(T* out, int j, const Vec<T>& v) {
  out[3 * j] = v.x;
  out[3 * j + 1] = v.y;
  out[3 * j + 2] = v.z;
}

template <typename T>
struct Args {
  const T* dih;  // (B, n), strides dsb, dsi
  long long dsb, dsi;
  const T* cart;  // (B, n + 3, 3), strides csb, csa, csx
  long long csb, csa, csx;
  const T* grad;  // backward: (B, n + 3, 3), strides gsb, gsa, gsx
  long long gsb, gsa, gsx;
  int B, n;
  T* out;    // forward: (B, n + 3, 3); backward: v, (B, n + 3, 3)
  T* cum;    // (B, n, 4): C_0..C_{n-1}, written forward, read backward
  T* d_bar;  // backward: (B, n)
};

template <typename T>
__global__ void __launch_bounds__(kThreads) one_way_fwd_kernel(Args<T> p) {
  const int lane = threadIdx.x & 31, n = p.n;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= p.B) return;  // the whole warp
  const Atoms<T> c{p.cart + b * p.csb, p.csa, p.csx};
  const T* dih = p.dih + b * p.dsb;
  T* out = p.out + b * (n + 3) * 3;
  T* cum = p.cum + b * n * 4;
  const Vec<T> c1 = c[1];
  if (lane < 2) store(out, lane, lane == 0 ? c[0] : c1);
  const Quat<T> ident{T(1), T(0), T(0), T(0)};
  Quat<T> carry = ident;      // C_{k0 - 1}
  Vec<T> offset{T(0), T(0), T(0)};  // sum of r_m, m < k0
  for (int k0 = 0; k0 <= n; k0 += 32) {
    const int k = k0 + lane;
    Quat<T> q = ident;
    Vec<T> bond{T(0), T(0), T(0)};
    if (k <= n) {
      bond = c[k + 2] - c[k + 1];
      if (k < n) {
        const T len = root(dot(bond, bond));
        T s, co;
        sin_cos(T(0.5) * dih[k * p.dsi], &s, &co);
        q = {co, s * (bond.x / len), s * (bond.y / len), s * (bond.z / len)};
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const Quat<T> e = shfl_up(q, off);
      if (lane >= off) q = compose(e, q);
    }
    if (k0 > 0) q = compose(carry, q);
    Quat<T> prev = shfl_up(q, 1);
    if (lane == 0) prev = carry;
    if (k == n) q = prev;  // the last atom shares C_{n-1}
    if (k < n) {
      T* ck = cum + 4 * k;
      ck[0] = q.w;
      ck[1] = q.x;
      ck[2] = q.y;
      ck[3] = q.z;
    }
    carry = shfl(q, 31);
    Vec<T> r = rotate(q, bond);
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const Vec<T> e = shfl_up(r, off);
      if (lane >= off) r = e + r;
    }
    if (k0 > 0) r = offset + r;
    offset = shfl(r, 31);
    if (k <= n) store(out, k + 2, c1 + r);
  }
}

template <typename T>
__device__ __forceinline__ Quat<T> load_quat(const T* cum, int k) {
  const T* ck = cum + 4 * k;
  return {ck[0], ck[1], ck[2], ck[3]};
}

template <typename T>
__global__ void __launch_bounds__(kThreads) one_way_bwd_kernel(Args<T> p) {
  const int lane = threadIdx.x & 31, n = p.n;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= p.B) return;  // the whole warp
  const Atoms<T> c{p.cart + b * p.csb, p.csa, p.csx};
  const Atoms<T> g{p.grad + b * p.gsb, p.gsa, p.gsx};
  const T* dih = p.dih + b * p.dsb;
  const T* cum = p.cum + b * n * 4;
  T* v = p.out + b * (n + 3) * 3;
  T* d_bar = p.d_bar + b * n;
  const Vec<T> zero{T(0), T(0), T(0)};
  const Quat<T> ident{T(1), T(0), T(0), T(0)};
  // carries from the tile after this one: the suffix sums at its first bond
  // (G, sum r x G, the rows of sum r G^T) and that bond's b_bar and u_bar
  Vec<T> cG = zero, cX = zero, cM0 = zero, cM1 = zero, cM2 = zero, nb = zero, nu = zero;
  for (int k0 = (n / 32) * 32; k0 >= 0; k0 -= 32) {
    const int k = k0 + lane;
    const bool on = k <= n;
    Vec<T> G = suffix_scan(on ? g[k + 2] : zero, lane) + cG;
    cG = shfl(G, 0);
    Quat<T> C = ident;
    Vec<T> bond = zero, r = zero, bb = zero;
    if (on) {
      C = load_quat(cum, k < n ? k : n - 1);
      bond = c[k + 2] - c[k + 1];
      r = rotate(C, bond);
      bb = rotate(conj(C), G);  // b_bar_k = R_k^T G_k
    }
    // suffix sums of r x G and of the rows r_a G^T of r G^T
    const Vec<T> X = suffix_scan(cross(r, G), lane) + cX;
    const Vec<T> M0 = suffix_scan(scale(r.x, G), lane) + cM0;
    const Vec<T> M1 = suffix_scan(scale(r.y, G), lane) + cM1;
    const Vec<T> M2 = suffix_scan(scale(r.z, G), lane) + cM2;
    cX = shfl(X, 0);
    cM0 = shfl(M0, 0);
    cM1 = shfl(M1, 0);
    cM2 = shfl(M2, 0);
    Vec<T> ub = zero;
    if (k < n) {
      const Quat<T> Cm = k > 0 ? load_quat(cum, k - 1) : ident;
      const T len = root(dot(bond, bond));
      const Vec<T> a{bond.x / len, bond.y / len, bond.z / len};
      d_bar[k] = dot(r, X) / len;
      // H = R_k^T M column by column, then N = H R_{k-1}: each row of H
      // rotated by R_{k-1}^T
      const Quat<T> Ct = conj(C), Cmt = conj(Cm);
      const Vec<T> h0 = rotate(Ct, Vec<T>{M0.x, M1.x, M2.x});
      const Vec<T> h1 = rotate(Ct, Vec<T>{M0.y, M1.y, M2.y});
      const Vec<T> h2 = rotate(Ct, Vec<T>{M0.z, M1.z, M2.z});
      const Vec<T> N0 = rotate(Cmt, Vec<T>{h0.x, h1.x, h2.x});
      const Vec<T> N1 = rotate(Cmt, Vec<T>{h0.y, h1.y, h2.y});
      const Vec<T> N2 = rotate(Cmt, Vec<T>{h0.z, h1.z, h2.z});
      const Vec<T> vee{N1.z - N2.y, N2.x - N0.z, N0.y - N1.x};
      const Vec<T> sym{(N0.x + N0.x) * a.x + (N0.y + N1.x) * a.y + (N0.z + N2.x) * a.z,
                       (N1.x + N0.y) * a.x + (N1.y + N1.y) * a.y + (N1.z + N2.y) * a.z,
                       (N2.x + N0.z) * a.x + (N2.y + N1.z) * a.y + (N2.z + N2.z) * a.z};
      T s, co;
      sin_cos(dih[k * p.dsi], &s, &co);
      const Vec<T> a_bar = scale(s, vee) + scale(T(1) - co, sym);
      const Vec<T> t = a_bar - scale(dot(a, a_bar), a);
      ub = {t.x / len, t.y / len, t.z / len};
    }
    // v_{k+2} = b_bar_k - b_bar_{k+1} + u_bar_k - u_bar_{k+1}
    Vec<T> nb1 = shfl_down(bb, 1), nu1 = shfl_down(ub, 1);
    if (lane == 31) {
      nb1 = nb;
      nu1 = nu;
    }
    nb = shfl(bb, 0);
    nu = shfl(ub, 0);
    if (on) store(v, k + 2, ((bb - nb1) + ub) - nu1);
    if (k == 0) {
      store(v, 0, g[0]);
      store(v, 1, ((g[1] + G) - bb) - ub);
    }
  }
}

template <typename T>
int launch(bool bwd, Args<T> a, void* stream) {
  if (a.B == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((a.B + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bwd)
    one_way_bwd_kernel<T><<<blocks, kThreads, 0, st>>>(a);
  else
    one_way_fwd_kernel<T><<<blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
int dispatch(bool bwd, const void* dih, long long dsb, long long dsi, const void* cart,
             long long csb, long long csa, long long csx, const void* grad, long long gsb,
             long long gsa, long long gsx, int B, int n, void* out, void* cum, void* d_bar,
             void* stream) {
  Args<T> a{static_cast<const T*>(dih), dsb, dsi, static_cast<const T*>(cart), csb, csa,
            csx, static_cast<const T*>(grad), gsb, gsa, gsx, B, n, static_cast<T*>(out),
            static_cast<T*>(cum), static_cast<T*>(d_bar)};
  return launch<T>(bwd, a, stream);
}

}  // namespace

extern "C" {

// out (B, n + 3, 3) and cum (B, n, 4), contiguous, of the half-chain with
// dihedrals dih (B, n) and planar coordinates cart (B, n + 3, 3), given
// with their strides in elements; double (1) or float (0).
int em_one_way_fwd(int is_double, const void* dih, long long dsb, long long dsi,
                   const void* cart, long long csb, long long csa, long long csx, int B, int n,
                   void* out, void* cum, void* stream) {
  return is_double ? dispatch<double>(false, dih, dsb, dsi, cart, csb, csa, csx, nullptr, 0,
                                      0, 0, B, n, out, cum, nullptr, stream)
                   : dispatch<float>(false, dih, dsb, dsi, cart, csb, csa, csx, nullptr, 0,
                                     0, 0, B, n, out, cum, nullptr, stream);
}

// d_bar (B, n) and v (B, n + 3, 3), contiguous: the pullback of the output
// cotangent grad (B, n + 3, 3, with its strides) through em_one_way_fwd,
// from its inputs and its cum.
int em_one_way_bwd(int is_double, const void* dih, long long dsb, long long dsi,
                   const void* cart, long long csb, long long csa, long long csx,
                   const void* cum, const void* grad, long long gsb, long long gsa,
                   long long gsx, int B, int n, void* d_bar, void* v, void* stream) {
  void* c = const_cast<void*>(cum);
  return is_double ? dispatch<double>(true, dih, dsb, dsi, cart, csb, csa, csx, grad, gsb,
                                      gsa, gsx, B, n, v, c, d_bar, stream)
                   : dispatch<float>(true, dih, dsb, dsi, cart, csb, csa, csx, grad, gsb,
                                     gsa, gsx, B, n, v, c, d_bar, stream);
}

}  // extern "C"
