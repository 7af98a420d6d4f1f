// encodermap_tpu_torch/csrc/clip_adam.cu
//
// One step of element-wise clipping and Adam over every leaf of a parameter
// tree (ops/clip_adam.py::clip_adam, the general route's optimizer,
// train/core.py::ClipAdam), for Hopper (sm_90a): each leaf's p, m, v and
// gradient g in, new p, m and v out, in one launch for all leaves.
//
// Replaces no TPU kernel: the JAX package's optimizer is
// optax.chain(optax.clip(1), optax.adam(lr, eps=1e-7))
// (encodermap_tpu/train/core.py:62-77), which XLA fuses. The port's plain
// version (ops/fused_train.py::_adam_update) is 15 element-wise operations a
// leaf, each its own launch on the card: 180 launches a step for the
// ADC's 12 leaves, about 1.3 us each for a few hundred bytes to a few
// hundred kilobytes each.
//
// What bounds it: bytes and the launch. A step reads p, m, v and g and
// writes p, m and v: 28 bytes an element in float32, about 3.1 MB for
// ~110k parameters, 0.9 us at 3.35 TB/s. One launch covers every leaf, so
// the work pays one launch latency in place of 180.
//
// Design: the leaves ride in a table passed by value as the kernel's
// argument (__grid_constant__: no host-to-device copy): each leaf's seven
// pointers, its element count and the first of its blocks. Block b takes
// elements [c chunk, (c + 1) chunk) of the leaf whose first block is the
// last at or below b, c = b - first. Where all seven pointers of a leaf are
// 16-byte aligned, a thread moves whole 16-byte vectors and the ragged end
// of the leaf (odd widths, 2-wide biases) goes element by element; an
// unaligned leaf (a view at an odd offset) goes element by element.
//
// The arithmetic is _adam_update's on the card, operation by operation, so
// the result is the plain version's bit for bit: each Python scalar rounded
// to the tensor's type (1 - b1 and 1 - b2 taken in double first), the clamp
// passing NaN through, (1 - b2) g g as ((1 - b2) g) g, the divisions by the
// bias corrections as multiplications by their reciprocals, taken on the
// host in double and rounded to the tensor's type (PyTorch's CUDA division
// by a host scalar, as PyTorch 2.11 takes it), and each product, sum,
// quotient and square root rounded on its own (the __f*_rn / __d*_rn
// intrinsics: nvcc would contract a*b + c into an FMA, which PyTorch's
// separate kernels never do).
//
// float and double; every tensor contiguous, outputs distinct from inputs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// Leaves in one table: 48 x 72 bytes of table and the scalars stay under the
// 4 KB a kernel's arguments may take. The wrapper launches once per table.
constexpr int kMaxLeaves = 48;

template <typename T>
struct Leaf {
  const T* p;
  const T* m;
  const T* v;
  const T* g;
  T* p_out;
  T* m_out;
  T* v_out;
  long long n;
  int first_block;
  int aligned;  // all seven pointers on 16-byte boundaries
};

template <typename T>
struct Table {
  Leaf<T> leaf[kMaxLeaves];
  int n_leaves;
  int chunk;  // elements a block, a multiple of the vector width
  // lr, b1, 1 - b1, b2, 1 - b2, 1 / (1 - b1^t), 1 / (1 - b2^t), eps, clip
  T lr, b1, c1, b2, c2, inv_bc1, inv_bc2, eps, clip;
};

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float clamp(float a, float c) {
    return fminf(fmaxf(a, -c), c);
  }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double clamp(double a, double c) {
    return fmin(fmax(a, -c), c);
  }
};

// _adam_update on one element, in its order of operations.
template <typename T>
__device__ __forceinline__ void update(const Table<T>& t, T p, T m, T v, T g, T* p1, T* m1,
                                       T* v1) {
  using R = Rn<T>;
  const T gc = g != g ? g : R::clamp(g, t.clip);  // torch.clamp keeps NaN
  const T mn = R::add(R::mul(m, t.b1), R::mul(gc, t.c1));
  const T vn = R::add(R::mul(v, t.b2), R::mul(R::mul(gc, t.c2), gc));
  const T mhat = R::mul(mn, t.inv_bc1);
  const T vhat = R::mul(vn, t.inv_bc2);
  const T step = R::div(R::mul(mhat, t.lr), R::add(R::sqrt(vhat), t.eps));
  *p1 = R::sub(p, step);
  *m1 = mn;
  *v1 = vn;
}

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};

template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) clip_adam_kernel(const __grid_constant__ Table<T> t) {
  const int b = blockIdx.x;
  int l = 0;
  while (l + 1 < t.n_leaves && t.leaf[l + 1].first_block <= b) ++l;
  const Leaf<T>& f = t.leaf[l];
  const long long start = static_cast<long long>(b - f.first_block) * t.chunk;
  const long long end = f.n < start + t.chunk ? f.n : start + t.chunk;
  long long tail = start;
  if (f.aligned) {
    using V = typename Vec16<T>::type;
    constexpr int kV = Vec16<T>::n;
    const long long n_vec = (end - start) / kV;
    const long long v0 = start / kV;
    for (long long i = threadIdx.x; i < n_vec; i += kThreads) {
      const V p = reinterpret_cast<const V*>(f.p)[v0 + i];
      const V m = reinterpret_cast<const V*>(f.m)[v0 + i];
      const V v = reinterpret_cast<const V*>(f.v)[v0 + i];
      const V g = reinterpret_cast<const V*>(f.g)[v0 + i];
      const T* pp = reinterpret_cast<const T*>(&p);
      const T* mp = reinterpret_cast<const T*>(&m);
      const T* vp = reinterpret_cast<const T*>(&v);
      const T* gp = reinterpret_cast<const T*>(&g);
      V p1, m1, v1;
      T* p1p = reinterpret_cast<T*>(&p1);
      T* m1p = reinterpret_cast<T*>(&m1);
      T* v1p = reinterpret_cast<T*>(&v1);
#pragma unroll
      for (int k = 0; k < kV; ++k) update(t, pp[k], mp[k], vp[k], gp[k], p1p + k, m1p + k, v1p + k);
      reinterpret_cast<V*>(f.p_out)[v0 + i] = p1;
      reinterpret_cast<V*>(f.m_out)[v0 + i] = m1;
      reinterpret_cast<V*>(f.v_out)[v0 + i] = v1;
    }
    tail = start + n_vec * kV;
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads)
    update(t, f.p[i], f.m[i], f.v[i], f.g[i], f.p_out + i, f.m_out + i, f.v_out + i);
}

template <typename T>
int launch(int n_leaves, const long long* table, int n_blocks, int chunk, const double* s,
           void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_blocks < 1 || chunk < 1 ||
      chunk % Vec16<T>::n != 0)
    return cudaErrorInvalidValue;
  Table<T> t{};
  for (int l = 0; l < n_leaves; ++l) {
    const long long* r = table + 10 * l;
    t.leaf[l] = Leaf<T>{reinterpret_cast<const T*>(r[0]), reinterpret_cast<const T*>(r[1]),
                        reinterpret_cast<const T*>(r[2]), reinterpret_cast<const T*>(r[3]),
                        reinterpret_cast<T*>(r[4]),       reinterpret_cast<T*>(r[5]),
                        reinterpret_cast<T*>(r[6]),       r[7],
                        static_cast<int>(r[8]),           static_cast<int>(r[9])};
  }
  t.n_leaves = n_leaves;
  t.chunk = chunk;
  t.lr = static_cast<T>(s[0]);
  t.b1 = static_cast<T>(s[1]);
  t.c1 = static_cast<T>(s[2]);
  t.b2 = static_cast<T>(s[3]);
  t.c2 = static_cast<T>(s[4]);
  t.inv_bc1 = static_cast<T>(s[5]);
  t.inv_bc2 = static_cast<T>(s[6]);
  t.eps = static_cast<T>(s[7]);
  t.clip = static_cast<T>(s[8]);
  clip_adam_kernel<T><<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return cudaGetLastError();
}

static_assert(sizeof(Table<double>) <= 4096, "the table must fit a kernel's arguments");

}  // namespace

extern "C" {

// One launch over n_leaves (1..48) leaves: table holds ten int64 a leaf (the
// pointers p, m, v, g, p_out, m_out, v_out, the element count, the leaf's
// first block, 1 where all seven pointers are 16-byte aligned), n_blocks
// blocks of chunk elements, and scalars the nine values of Table (already
// rounded to the tensors' type); double (1) or float (0).
int em_clip_adam(int is_double, int n_leaves, const long long* table, int n_blocks, int chunk,
                 const double* scalars, void* stream) {
  return is_double ? launch<double>(n_leaves, table, n_blocks, chunk, scalars, stream)
                   : launch<float>(n_leaves, table, n_blocks, chunk, scalars, stream);
}

}  // extern "C"
