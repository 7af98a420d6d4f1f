// encodermap_tpu_torch/csrc/sigmoid_loss.cu
//
// The sketch-map sigmoid loss over all pairs of a batch and its latent
// gradient, for Hopper (sm_90a).
//
//   loss     = mean_{i,j} (s_h(D_h[i,j]) - s_l(D_l[i,j]))^2
//   dloss/dl = (4/B^2) sum_j (s_l - s_h)[i,j] s_l'(D_l)/D_l (l_i - l_j)
//
// Replaces the TPU kernels encodermap_tpu/ops/pallas_sigmoid.py::_fwd_kernel
// (forward) and ::_bwd_kernel (backward). The TPU walked (256, 512) tiles of
// the pair matrix in a sequential grid and carried the sum in SMEM; here the
// blocks run in parallel, so:
//
// * forward: each block owns a (32 x 256) tile of the pair matrix and writes
//   one partial sum; a second one-block pass adds the partials in a fixed
//   order (in double), so the result is deterministic. No float atomics.
// * backward: each block owns 16 rows i and loops over every j, so no sum
//   crosses blocks; the block's threads split j and reduce in a fixed order.
//
// D_h is taken by direct per-component differences, not the TPU's Gram
// identity: more exact, and right for any width D (the feature columns are
// staged through shared memory 16 at a time). Periodic distances keep the
// reference's guards: 1e-12 on each exactly-zero component and 1e-12 after
// the sqrt. The inputs are O(B D) bytes and the work O(B^2 D), so the kernels
// are bound by arithmetic (two sigmoids, i.e. four powers, per pair), not by
// memory; ragged edges (B not a multiple of a tile) are masked here.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // one pair column j per thread
constexpr int kRowsFwd = 32;   // rows i of a forward tile
constexpr int kRowsBwd = 16;   // rows i of a backward block
constexpr int kChunk = 16;     // feature columns staged per pass
constexpr int kLatGroup = 4;   // latent components accumulated per pass

// Adds to acc[r] the squared distance between row i0 + r and row j of the
// (n, w) matrix X, for r < R. Periodic: min-image components with the
// reference's 1e-12 guard on exact zeros. Every thread of the block calls it.
template <int R, bool PERIODIC>
__device__ __forceinline__ void accum_d2(const float* __restrict__ X, int n, int w,
                                         int i0, int j, float period, float (&acc)[R],
                                         float* xs) {
  const bool jvalid = j < n;
  for (int c0 = 0; c0 < w; c0 += kChunk) {
    const int kc = min(kChunk, w - c0);
    __syncthreads();
    for (int e = threadIdx.x; e < R * kChunk; e += blockDim.x) {
      const int r = e / kChunk, k = e % kChunk, i = i0 + r;
      xs[e] = (i < n && k < kc) ? X[static_cast<size_t>(i) * w + c0 + k] : 0.f;
    }
    __syncthreads();
    float xj[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      xj[k] = (jvalid && k < kc) ? X[static_cast<size_t>(j) * w + c0 + k] : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = acc[r];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k < kc) {
          float d = xs[r * kChunk + k] - xj[k];
          if (PERIODIC) {
            d = fabsf(d);
            d = fminf(d, period - d);
            if (d == 0.f) d = 1e-12f;
          }
          s += d * d;
        }
      }
      acc[r] = s;
    }
  }
}

template <bool PERIODIC>
__device__ __forceinline__ float dist_h(float d2) {
  return PERIODIC ? sqrtf(d2) + 1e-12f : sqrt_guard(d2);
}

// Sum over the block in a fixed order (tree in shared memory).
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

template <bool PERIODIC>
__global__ void __launch_bounds__(kThreads)
sigmoid_fwd_kernel(const float* __restrict__ h, const float* __restrict__ l, int n, int D,
                   int d, Sig sh, Sig sl, float period, float* __restrict__ partials) {
  __shared__ float xs[kRowsFwd * kChunk];
  __shared__ float red[kThreads];
  const int i0 = blockIdx.y * kRowsFwd;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  float dh2[kRowsFwd], dl2[kRowsFwd];
#pragma unroll
  for (int r = 0; r < kRowsFwd; ++r) dh2[r] = dl2[r] = 0.f;
  accum_d2<kRowsFwd, PERIODIC>(h, n, D, i0, j, period, dh2, xs);
  accum_d2<kRowsFwd, false>(l, n, d, i0, j, period, dl2, xs);
  float part = 0.f;
  if (j < n) {
#pragma unroll
    for (int r = 0; r < kRowsFwd; ++r) {
      if (i0 + r < n) {
        const float diff = sig_value(dist_h<PERIODIC>(dh2[r]), sh) -
                           sig_value(sqrt_guard(dl2[r]), sl);
        part += diff * diff;
      }
    }
  }
  const float total = block_sum(part, red);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
}

__global__ void __launch_bounds__(1024)
sum_partials_kernel(const float* __restrict__ partials, int m, double scale,
                    float* __restrict__ out) {
  __shared__ double red[1024];
  double s = 0.0;
  for (int i = threadIdx.x; i < m; i += blockDim.x) s += partials[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int k = blockDim.x / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) red[threadIdx.x] += red[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = static_cast<float>(red[0] * scale);
}

template <bool PERIODIC>
__global__ void __launch_bounds__(kThreads)
sigmoid_bwd_kernel(const float* __restrict__ h, const float* __restrict__ l, int n, int D,
                   int d, Sig sh, Sig sl, float period, const float* __restrict__ gout,
                   float* __restrict__ grad) {
  constexpr int R = kRowsBwd, V = kLatGroup + 1;  // per row: rowsum, then fl[k]
  __shared__ float xs[R * kChunk];
  __shared__ float red[kThreads / 32][R * V];
  const int i0 = blockIdx.x * R;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float scale = 4.f / (static_cast<float>(n) * static_cast<float>(n)) * gout[0];
  for (int k0 = 0; k0 < d; k0 += kLatGroup) {
    const int kg = min(kLatGroup, d - k0);
    float rowsum[R], fl[R][kLatGroup];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      rowsum[r] = 0.f;
#pragma unroll
      for (int k = 0; k < kLatGroup; ++k) fl[r][k] = 0.f;
    }
    for (int j0 = 0; j0 < n; j0 += kThreads) {
      const int j = j0 + threadIdx.x;
      float dh2[R], dl2[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dh2[r] = dl2[r] = 0.f;
      accum_d2<R, PERIODIC>(h, n, D, i0, j, period, dh2, xs);
      accum_d2<R, false>(l, n, d, i0, j, period, dl2, xs);
      if (j < n) {
        float lj[kLatGroup];
#pragma unroll
        for (int k = 0; k < kLatGroup; ++k)
          lj[k] = k < kg ? l[static_cast<size_t>(j) * d + k0 + k] : 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          // pairs at zero latent distance contribute nothing (the TPU
          // kernel's zero mask): their (l_i - l_j) factor is zero
          if (i0 + r < n && dl2[r] != 0.f) {
            const float rl = sqrtf(dl2[r]);
            const float f = (sig_value(rl, sl) - sig_value(dist_h<PERIODIC>(dh2[r]), sh)) *
                            dsig_over_r(dl2[r], rl, sl);
            rowsum[r] += f;
#pragma unroll
            for (int k = 0; k < kLatGroup; ++k) fl[r][k] += f * lj[k];
          }
        }
      }
    }
    // reduce over the block: warp shuffles, then the warps in order
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float x = v == 0 ? rowsum[r] : fl[r][v - 1];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
        if (lane == 0) red[warp][r * V + v] = x;
      }
    }
    __syncthreads();
    if (threadIdx.x < R * kg) {
      const int r = threadIdx.x / kg, k = threadIdx.x % kg, i = i0 + r;
      if (i < n) {
        float rs = 0.f, fs = 0.f;
        for (int w = 0; w < kThreads / 32; ++w) {
          rs += red[w][r * V];
          fs += red[w][r * V + 1 + k];
        }
        const size_t at = static_cast<size_t>(i) * d + k0 + k;
        grad[at] = scale * (rs * l[at] - fs);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Floats of scratch the forward pass needs for its per-tile partial sums.
int em_sigmoid_fwd_workspace(int n) {
  return ((n + kThreads - 1) / kThreads) * ((n + kRowsFwd - 1) / kRowsFwd);
}

// out[0] = the loss of h (n, D) and l (n, d), both float32 row-major.
int em_sigmoid_fwd(const float* h, const float* l, int n, int D, int d, double sig_h,
                   double a_h, double b_h, double sig_l, double a_l, double b_l,
                   double period, int periodic, float* partials, float* out,
                   void* stream) {
  const Sig sh = make_sig(sig_h, a_h, b_h), sl = make_sig(sig_l, a_l, b_l);
  const dim3 grid((n + kThreads - 1) / kThreads, (n + kRowsFwd - 1) / kRowsFwd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float p = static_cast<float>(period);
  if (periodic)
    sigmoid_fwd_kernel<true><<<grid, kThreads, 0, st>>>(h, l, n, D, d, sh, sl, p, partials);
  else
    sigmoid_fwd_kernel<false><<<grid, kThreads, 0, st>>>(h, l, n, D, d, sh, sl, p, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<1, 1024, 0, st>>>(partials, static_cast<int>(grid.x * grid.y),
                                          1.0 / (static_cast<double>(n) * n), out);
  return cudaGetLastError();
}

// grad (n, d) = gout[0] * d loss / d l; the loss has no gradient in h.
int em_sigmoid_bwd(const float* h, const float* l, int n, int D, int d, double sig_h,
                   double a_h, double b_h, double sig_l, double a_l, double b_l,
                   double period, int periodic, const float* gout, float* grad,
                   void* stream) {
  const Sig sh = make_sig(sig_h, a_h, b_h), sl = make_sig(sig_l, a_l, b_l);
  const dim3 grid((n + kRowsBwd - 1) / kRowsBwd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float p = static_cast<float>(period);
  if (periodic)
    sigmoid_bwd_kernel<true><<<grid, kThreads, 0, st>>>(h, l, n, D, d, sh, sl, p, gout, grad);
  else
    sigmoid_bwd_kernel<false><<<grid, kThreads, 0, st>>>(h, l, n, D, d, sh, sl, p, gout, grad);
  return cudaGetLastError();
}

}  // extern "C"
