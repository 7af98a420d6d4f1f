// encodermap_tpu_torch/csrc/backmap_sidechains.cu
//
// The sidechain backmap's fast form (ops/backmap_sidechains.py::
// _backmap_sidechains_fast_plain), forward and its hand-derived adjoint, for
// Hopper (sm_90a): a frame's six internal-coordinate rows in, all its atoms
// (B, n_atoms, 3) out in the reference's order (backbone, then each branch).
//
// Replaces no TPU kernel: the JAX package's fast form is plain jnp that XLA
// fuses and differentiates. The port's plain version is cumsums, two
// doubling scans of quaternion products, gathers and autograd through all
// of them: about 1,300 small launches a training step for a few kFLOP and a
// few kB a frame. These two kernels do the same work in one launch each.
//
// What bounds them: neither bytes (2.6 kB a frame forward, 3.5 kB backward
// in float32 on trp-cage) nor operations, but the latency of three chains:
// the heading cumsum and the cumulative quaternion product along the
// backbone, and the serial walk along each branch.
//
// Notation (as the plain version): backbone bond i (atom i -> i + 1, i = 0
// .. nb - 2) has heading h_i = sum_{j<i} (pi - central_angle_j), planar
// vector p_i = d_i (cos h_i, sin h_i, 0) and rotation R_i: identity for
// i = 0, C_{min(i-1, n_cdi-1)} after, C_m = q_0 ⊗ ... ⊗ q_m, q_m the
// rotation by central_dihedral_m - pi trans_m about the in-plane axis of
// heading h_{m+1}; atom i + 1 sits at sum_{k<=i} R_k p_k. Branch b rides on
// T_b = R_{thr_b + 1} (the identity where it has no threshold) from its CA:
// bond j has heading phi_j (phi_0 = h_{ca-1} + pi/2 - |sa_0 - pi/2|,
// phi_j = phi_{j-1} - (pi - sa_j)), planar vector s_j, rotation Q_j =
// T_b ⊗ P_j with P_j = q'_0 ⊗ ... ⊗ q'_{j-1} of its dihedral steps.
//
// * Forward: one warp a frame. The lanes walk the backbone in tiles of 32
//   bonds: a warp scan of the headings, the quaternion q_{i-1} at bond i (the
//   identity at bond 0 and past the last dihedral), a Hillis-Steele scan
//   composing the earlier product on the left (as _cumulative_quats does),
//   the rotated bonds and their prefix sums, each with a carry into the next
//   tile. Every bond's R_i and h_i go to a scratch row (the backward reads
//   them, and the branches read T_b and h_{ca-1} from it after a
//   __syncwarp, as they read their CA from the output: no size limit). Then
//   each lane walks one branch (branches strided over the lanes) serially.
//   Each branch bond's Q_j and phi_j go to the same scratch rows.
// * Backward: the same layout, branches first, then the backbone. With
//   G the suffix sums of the position cotangents and X = sum w x G the
//   torque of the rotated bonds w after a rotation, a rotation by angle t
//   about the axis R u (in its final frame) takes t_bar = R u . X; a change
//   of its axis heading moves the rotation by (R_before e_z - R_after e_z)
//   per radian, and takes that dotted with X. A branch walks from its last
//   bond and leaves three things for the backbone: its cotangent sum G_0
//   (on its CA), its torque X_0 (on T_b = R_{thr+1}) and its heading
//   cotangent sum (on h_{ca-1}). The backbone lanes gather those through
//   two small CSR tables (bond -> branches), so no atomics: two runs give
//   the same bits. The backbone then walks its tiles from the end with
//   reversed warp scans and carries: the positions' suffix sums, the
//   torques' suffix sums over every bond a dihedral moves, and the heading
//   cotangents' suffix sums, which give the central angles' gradients.
//
// Any B, any number of residues and branches; float and double (every sum
// and product in the tensors' type, no fast math; float's sin and cos are
// taken in double and rounded once: headings reach about 70 rad); inputs
// with any strides, outputs contiguous.
#include "common.cuh"

namespace {

constexpr int kWarps = 2;  // frames (warps) per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr double kPi = 3.14159265358979323846;
// int columns of a branch's row in the table
constexpr int kCa = 0, kThr = 1, kLen = 2, kAtom = 3, kDih = 4, kBranchCols = 5;
// a branch's results for the backbone: G_0 (3), X_0 (3), heading cotangent
constexpr int kPart = 7;

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

// sin and cos rounded to the type; for float taken in double and rounded
// once (csrc/backmap_one_way.cu's sin_cos: sincosf's errors of one sign
// drift the cumulative products)
__device__ __forceinline__ void sin_cos(float x, float* s, float* c) {
  double sd, cd;
  sincos(static_cast<double>(x), &sd, &cd);
  *s = static_cast<float>(sd);
  *c = static_cast<float>(cd);
}
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ float sine(float x) {
  return static_cast<float>(sin(static_cast<double>(x)));
}
__device__ __forceinline__ double sine(double x) { return sin(x); }
__device__ __forceinline__ float magnitude(float x) { return fabsf(x); }
__device__ __forceinline__ double magnitude(double x) { return fabs(x); }

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

// Inclusive prefix sums within the warp: lane i gets sum_{j <= i} x_j.
template <typename T>
__device__ __forceinline__ T prefix_scan(T x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const T e = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x = e + x;
  }
  return x;
}

template <typename T>
__device__ __forceinline__ Vec<T> prefix_scan(Vec<T> x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const Vec<T> e = shfl_up(x, off);
    if (lane >= off) x = e + x;
  }
  return x;
}

// Inclusive suffix sums within the warp: lane i gets sum_{j >= i} x_j.
template <typename T>
__device__ __forceinline__ T suffix_scan(T x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const T e = __shfl_down_sync(kFull, x, off);
    if (lane + off < 32) x = x + e;
  }
  return x;
}

template <typename T>
__device__ __forceinline__ Vec<T> suffix_scan(Vec<T> x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const Vec<T> e = shfl_down(x, off);
    if (lane + off < 32) x = x + e;
  }
  return x;
}

// One frame's row of a (B, n) input, with its tensor's column stride.
template <typename T>
struct Row {
  const T* p;
  long long s;
  __device__ __forceinline__ T operator[](int i) const { return p[i * s]; }
};

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
__device__ __forceinline__ Vec<T> load(const T* p, int j) {
  return {p[3 * j], p[3 * j + 1], p[3 * j + 2]};
}

template <typename T>
__device__ __forceinline__ void store_quat(T* p, int k, const Quat<T>& q) {
  T* a = p + 4 * k;
  a[0] = q.w;
  a[1] = q.x;
  a[2] = q.y;
  a[3] = q.z;
}

template <typename T>
__device__ __forceinline__ Quat<T> load_quat(const T* p, int k) {
  const T* a = p + 4 * k;
  return {a[0], a[1], a[2], a[3]};
}

// inputs, in the order of backmap_sidechains_fast's arguments
enum { kCd, kCa_, kCdi, kSd, kSa, kSdi, kInputs };

template <typename T>
struct Args {
  const T* in[kInputs];  // (B, n) each, strides sb[k] (row) and si[k] (column)
  long long sb[kInputs], si[kInputs];
  const T* grad;  // backward: (B, n_atoms, 3), strides gsb, gsa, gsx
  long long gsb, gsa, gsx;
  // (n_br, 5) branch rows (CA atom, threshold index or -1, length, first side
  // atom, first side dihedral), then two CSR tables over the backbone bonds:
  // bond -> branches whose CA is atom bond + 1, bond -> branches riding on
  // R_bond (threshold index + 1); offsets nb entries, indices after them
  const int* tab;
  int B, nb, n_br, n_side;
  T* out;   // forward: (B, n_atoms, 3)
  T* quat;  // (B, nb - 1 + n_side, 4): R_i of the backbone bonds, Q_j of the branch bonds
  T* head;  // (B, nb - 1 + n_side): h_i, phi_j
  T* part;  // backward: (B, n_br, 7)
  T* d[kInputs];  // backward: the inputs' gradients, (B, n) contiguous
};

template <typename T>
__device__ __forceinline__ Row<T> row(const Args<T>& p, int k, long long b) {
  return {p.in[k] + b * p.sb[k], p.si[k]};
}

template <typename T>
__global__ void __launch_bounds__(kThreads) sidechain_fwd_kernel(Args<T> p) {
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= p.B) return;  // the whole warp
  const int nb = p.nb, nbond = nb - 1, n_cdi = nb - 3, n_rows = nbond + p.n_side;
  const Row<T> cd = row(p, kCd, b), ca = row(p, kCa_, b), cdi = row(p, kCdi, b);
  const Row<T> sd = row(p, kSd, b), sa = row(p, kSa, b), sdi = row(p, kSdi, b);
  T* out = p.out + b * (nb + p.n_side) * 3;
  T* quat = p.quat + b * n_rows * 4;
  T* head = p.head + b * n_rows;
  const Quat<T> ident{T(1), T(0), T(0), T(0)};
  const Vec<T> zero{T(0), T(0), T(0)};
  if (lane == 0) store(out, 0, zero);

  // the backbone, in tiles of 32 bonds
  Quat<T> carry = ident;  // R of the tile's last bond
  Vec<T> offset = zero;   // the position of its last atom
  T hcarry = T(0);        // its heading
  for (int i0 = 0; i0 < nbond; i0 += 32) {
    const int i = i0 + lane;
    const bool on = i < nbond;
    T h = (on && i >= 1) ? T(kPi) - ca[i - 1] : T(0);
    h = prefix_scan(h, lane);
    if (i0 > 0) h = hcarry + h;
    hcarry = __shfl_sync(kFull, h, 31);
    T s = T(0), c = T(1), len = T(0);
    if (on) {
      sin_cos(h, &s, &c);
      len = cd[i];
    }
    const Vec<T> pl{len * c, len * s, T(0)};
    Quat<T> q = ident;
    if (on && i >= 1 && i <= n_cdi) {
      // the sweep's current dihedral: pi where the plane chain turns
      // different ways at the bond's two ends
      const bool trans = sine(ca[i - 1]) * sine(ca[i]) < T(0);
      const T ang = trans ? cdi[i - 1] - T(kPi) : cdi[i - 1];
      T hs, hc;
      sin_cos(T(0.5) * ang, &hs, &hc);
      q = {hc, hs * c, hs * s, T(0)};
    }
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const Quat<T> e = shfl_up(q, off);
      if (lane >= off) q = compose(e, q);
    }
    if (i0 > 0) q = compose(carry, q);
    carry = shfl(q, 31);
    Vec<T> r = rotate(q, pl);
    r = prefix_scan(r, lane);
    if (i0 > 0) r = offset + r;
    offset = shfl(r, 31);
    if (on) {
      store_quat(quat, i, q);
      head[i] = h;
      store(out, i + 1, r);
    }
  }
  __syncwarp();

  // the branches, one a lane
  for (int bi = lane; bi < p.n_br; bi += 32) {
    const int* t = p.tab + kBranchCols * bi;
    const int at = t[kCa], thr = t[kThr], L = t[kLen], a0 = t[kAtom], d0 = t[kDih];
    const Quat<T> T0 = thr >= 0 ? load_quat(quat, thr + 1) : ident;
    const Vec<T> origin = load(out, at);
    const T h_ca = head[at - 1];
    Quat<T> P = ident;
    Vec<T> acc = zero;
    T phi0 = T(0), S = T(0);
    T sa_j = sa[a0], sd_j = sd[a0];
    for (int j = 0; j < L; ++j) {
      const bool step = j + 1 < L;  // bond j's dihedral step
      T sa_n = T(0), sd_n = T(0), dih = T(0);
      if (step) {
        sa_n = sa[a0 + j + 1];
        sd_n = sd[a0 + j + 1];
        dih = sdi[d0 + j];
      }
      T phi;
      if (j == 0) {
        phi0 = (h_ca + T(kPi / 2)) - magnitude(sa_j - T(kPi / 2));
        phi = phi0;
      } else {
        S = S + (-(T(kPi) - sa_j));
        phi = phi0 + S;
      }
      T s, c;
      sin_cos(phi, &s, &c);
      const Quat<T> Q = compose(T0, P);
      acc = acc + rotate(Q, Vec<T>{sd_j * c, sd_j * s, T(0)});
      store_quat(quat, nbond + a0 + j, Q);
      head[nbond + a0 + j] = phi;
      store(out, nb + a0 + j, origin + acc);
      if (step) {
        // the turns' sines are sin(sa_0) into the first bond and -sin(sa_k)
        // after, so the first step reads the product's sign the other way
        const bool trans = (sine(sa_j) * sine(sa_n) < T(0)) != (j == 0);
        const T ang = trans ? dih - T(kPi) : dih;
        T hs, hc;
        sin_cos(T(0.5) * ang, &hs, &hc);
        P = compose(P, Quat<T>{hc, hs * c, hs * s, T(0)});
      }
      sa_j = sa_n;
      sd_j = sd_n;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) sidechain_bwd_kernel(Args<T> p) {
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= p.B) return;  // the whole warp
  const int nb = p.nb, nbond = nb - 1, n_cdi = nb - 3, n_rows = nbond + p.n_side;
  const Row<T> cd = row(p, kCd, b), sd = row(p, kSd, b), sa = row(p, kSa, b);
  const Atoms<T> g{p.grad + b * p.gsb, p.gsa, p.gsx};
  const T* quat = p.quat + b * n_rows * 4;
  const T* head = p.head + b * n_rows;
  T* part = p.part + b * p.n_br * kPart;
  T* d_cd = p.d[kCd] + b * nbond;
  T* d_ca = p.d[kCa_] + b * (nb - 2);
  T* d_cdi = p.d[kCdi] + b * (nb - 3);
  T* d_sd = p.d[kSd] + b * p.n_side;
  T* d_sa = p.d[kSa] + b * p.n_side;
  const long long n_sdi = p.n_side - p.n_br;
  T* d_sdi = p.d[kSdi] + b * n_sdi;
  const Vec<T> zero{T(0), T(0), T(0)}, ez{T(0), T(0), T(1)};

  // the branches, one a lane, each from its last bond
  for (int bi = lane; bi < p.n_br; bi += 32) {
    const int* t = p.tab + kBranchCols * bi;
    const int L = t[kLen], a0 = t[kAtom], d0 = t[kDih];
    Vec<T> G = zero, X = zero, n_after = zero;
    T Phi = T(0);
    for (int j = L - 1; j >= 0; --j) {
      const int col = a0 + j;
      const Quat<T> Q = load_quat(quat, nbond + col);
      const T phi = head[nbond + col], len = sd[col];
      G = G + g[nb + col];
      T s, c;
      sin_cos(phi, &s, &c);
      const Vec<T> w = rotate(Q, Vec<T>{len * c, len * s, T(0)});
      const Vec<T> n_here = rotate(Q, ez);
      T phi_bar = T(0);
      if (j + 1 < L) {  // dihedral step j turns the bonds after it
        d_sdi[d0 + j] = dot(rotate(Q, Vec<T>{c, s, T(0)}), X);
        phi_bar = dot(n_here - n_after, X);
      }
      n_after = n_here;
      X = X + cross(w, G);
      const Vec<T> sb = rotate(conj(Q), G);
      d_sd[col] = sb.x * c + sb.y * s;
      phi_bar = phi_bar + len * (sb.y * c - sb.x * s);
      Phi = Phi + phi_bar;
      if (j > 0) {
        d_sa[col] = Phi;
      } else {
        const T x = sa[col] - T(kPi / 2);  // d|x|/dx is 0 at 0, as autograd takes it
        d_sa[col] = x > T(0) ? -Phi : (x < T(0) ? Phi : T(0));
      }
    }
    T* o = part + kPart * bi;
    o[0] = G.x;
    o[1] = G.y;
    o[2] = G.z;
    o[3] = X.x;
    o[4] = X.y;
    o[5] = X.z;
    o[6] = Phi;
  }
  __syncwarp();

  // the backbone, in tiles of 32 bonds from the end
  const int* ca_ptr = p.tab + kBranchCols * p.n_br;
  const int* ca_ids = ca_ptr + nb;
  const int* thr_ptr = ca_ids + p.n_br;
  const int* thr_ids = thr_ptr + nb;
  Vec<T> cG = zero, cX = zero;  // suffix sums at the next tile's first bond
  T cH = T(0);
  for (int i0 = ((nbond - 1) / 32) * 32; i0 >= 0; i0 -= 32) {
    const int i = i0 + lane;
    const bool on = i < nbond;
    Vec<T> gx = zero, tq = zero;
    T h_bar = T(0);
    Quat<T> R{T(1), T(0), T(0), T(0)}, Rm = R;
    T h = T(0), len = T(0);
    if (on) {
      gx = g[i + 1];
      for (int k = ca_ptr[i]; k < ca_ptr[i + 1]; ++k) {
        const T* o = part + kPart * ca_ids[k];
        gx = gx + Vec<T>{o[0], o[1], o[2]};
        h_bar = h_bar + o[6];
      }
      for (int k = thr_ptr[i]; k < thr_ptr[i + 1]; ++k) {
        const T* o = part + kPart * thr_ids[k];
        tq = tq + Vec<T>{o[3], o[4], o[5]};
      }
      R = load_quat(quat, i);
      if (i >= 1) Rm = load_quat(quat, i - 1);
      h = head[i];
      len = cd[i];
    }
    const Vec<T> G = suffix_scan(gx, lane) + cG;
    cG = shfl(G, 0);
    T s = T(0), c = T(1);
    if (on) sin_cos(h, &s, &c);
    const Vec<T> r = rotate(R, Vec<T>{len * c, len * s, T(0)});
    const Vec<T> pb = rotate(conj(R), G);
    if (on) d_cd[i] = pb.x * c + pb.y * s;
    h_bar = h_bar + len * (pb.y * c - pb.x * s);
    if (on && i >= 1) tq = tq + cross(r, G);
    const Vec<T> X = suffix_scan(tq, lane) + cX;
    cX = shfl(X, 0);
    if (on && i >= 1 && i <= n_cdi) {  // dihedral i - 1, about bond i
      d_cdi[i - 1] = dot(rotate(R, Vec<T>{c, s, T(0)}), X);
      h_bar = h_bar + dot(rotate(Rm, ez) - rotate(R, ez), X);
    }
    const T H = suffix_scan(h_bar, lane) + cH;
    cH = __shfl_sync(kFull, H, 0);
    if (on && i >= 1) d_ca[i - 1] = -H;
  }
}

template <typename T>
int launch(bool bwd, const Args<T>& a, void* stream) {
  if (a.B == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((a.B + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bwd)
    sidechain_bwd_kernel<T><<<blocks, kThreads, 0, st>>>(a);
  else
    sidechain_fwd_kernel<T><<<blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
int dispatch(bool bwd, const void* const* in, const long long* strides, const int* tab,
             int B, int nb, int n_br, int n_side, void* out, void* quat, void* head,
             const void* grad, long long gsb, long long gsa, long long gsx, void* part,
             void* const* d, void* stream) {
  Args<T> a{};
  for (int k = 0; k < kInputs; ++k) {
    a.in[k] = static_cast<const T*>(in[k]);
    a.sb[k] = strides[2 * k];
    a.si[k] = strides[2 * k + 1];
    a.d[k] = d ? static_cast<T*>(d[k]) : nullptr;
  }
  a.grad = static_cast<const T*>(grad);
  a.gsb = gsb;
  a.gsa = gsa;
  a.gsx = gsx;
  a.tab = tab;
  a.B = B;
  a.nb = nb;
  a.n_br = n_br;
  a.n_side = n_side;
  a.out = static_cast<T*>(out);
  a.quat = static_cast<T*>(quat);
  a.head = static_cast<T*>(head);
  a.part = static_cast<T*>(part);
  return launch<T>(bwd, a, stream);
}

}  // namespace

extern "C" {

// out (B, nb + n_side, 3), quat (B, nb - 1 + n_side, 4) and head (B, nb - 1
// + n_side), contiguous, from the six inputs (in: their pointers; strides:
// each one's row and column stride in elements) and the device table tab;
// double (1) or float (0).
int em_sidechain_fwd(int is_double, const void* const* in, const long long* strides,
                     const int* tab, int B, int nb, int n_br, int n_side, void* out,
                     void* quat, void* head, void* stream) {
  return is_double ? dispatch<double>(false, in, strides, tab, B, nb, n_br, n_side, out,
                                      quat, head, nullptr, 0, 0, 0, nullptr, nullptr, stream)
                   : dispatch<float>(false, in, strides, tab, B, nb, n_br, n_side, out,
                                     quat, head, nullptr, 0, 0, 0, nullptr, nullptr, stream);
}

// d: the six inputs' gradients (pointers to contiguous (B, n) tensors), the
// pullback of the coordinates' cotangent grad ((B, nb + n_side, 3) with its
// strides) through em_sidechain_fwd, from its inputs, quat and head; part
// (B, n_br, 7) is scratch.
int em_sidechain_bwd(int is_double, const void* const* in, const long long* strides,
                     const int* tab, int B, int nb, int n_br, int n_side, const void* quat,
                     const void* head, const void* grad, long long gsb, long long gsa,
                     long long gsx, void* part, void* const* d, void* stream) {
  void* q = const_cast<void*>(quat);
  void* h = const_cast<void*>(head);
  return is_double ? dispatch<double>(true, in, strides, tab, B, nb, n_br, n_side, nullptr,
                                      q, h, grad, gsb, gsa, gsx, part, d, stream)
                   : dispatch<float>(true, in, strides, tab, B, nb, n_br, n_side, nullptr,
                                     q, h, grad, gsb, gsa, gsx, part, d, stream);
}

}  // extern "C"
