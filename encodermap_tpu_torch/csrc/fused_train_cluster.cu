// encodermap_tpu_torch/csrc/fused_train_cluster.cu
//
// A chunk of EncoderMap optimizer steps in one launch of one thread-block
// cluster, for Hopper (sm_90a).
//
// Replaces the TPU kernel encodermap_tpu/ops/pallas_train.py::_fused_kernel,
// and computes what fused_train.cu computes (fused_chunk_plain of
// ops/fused_train.py): each step gathers the batch rows given by the
// (steps, B) index array from the device-resident dataset (sin/cos fold-in
// for periodic data), runs the tanh MLP forward, the auto (mean_abs,
// min-image if periodic), center, L2 and sketch-map losses over all B x B
// pairs, the hand-derived backward pass, the clip to +-1 and Adam with bias
// correction, and writes one metrics row.
//
// What bounds it: at the main path's size ([128,128,2], B=256) a step is
// ~56 MFLOP of f32 multiply-adds on a state of ~415 KB (parameters and both
// Adam moments) and ~530 activations per batch row. fused_train.cu spreads
// each phase over the whole card and pays 14 grid-wide software barriers a
// step, with every operand loaded from L2 by a serial per-element loop.
//
// Design: one cluster of C = kCluster = 16 CTAs (a non-portable size the
// H100 allows; it ran faster than the portable 8, PERF.md) on neighbouring
// SMs, which read each other's shared memory. The batch rows are split
// across the CTAs, R = ceil(B / C) each (the last CTA masked). Each CTA
// gathers its rows, runs their forward pass and keeps every layer's
// activations of its rows in shared memory, so the forward pass needs no
// barrier between CTAs. A layer's weights are staged whole into one of two
// shared-memory buffers with L1-bypassing asynchronous copies (cp.async.cg:
// another CTA updated them in the previous step) while the layer before it
// computes from the other, and each thread computes a 4 x 4 register
// tile of outputs (the depth split over up to 32 lanes where a layer is
// narrow). After one cluster barrier every CTA copies all rows' raw inputs
// and latents from its peers (distributed shared memory) and evaluates the
// sketch-map terms of its own rows against half of all rows, so that each
// unordered pair is evaluated once in the cluster; the latent gradient of
// its rows reads the other half from the CTAs that own them, after a later
// barrier. A pair's sketch-map sigmoids are sigmoid_pairs.cuh's (sig_t,
// sig_s), the one pair function of all four kernels of the port: the grid
// train kernel and the two sigmoid-loss kernels take it too, so the
// function a user trains on does not change with the route. Backward, per
// layer: each CTA computes its rows' delta of the previous layer from the
// layer's old weights (staged while the layer after it was reduced), then
// its partial weight and bias gradients over its rows into the same
// buffer; after a cluster barrier the owner of each 1/C slice of the layer
// adds the C partials in a fixed order, adds the L2 term, clips, and
// updates Adam's moments and the parameters in place in global memory; a
// second barrier frees the buffer.
// Barriers: 1 + 2 per layer per step, all hardware cluster barriers (about
// 1,000 cycles each on the H100). Sums are taken in a fixed order (metric
// partials per CTA, added by rank 0 in rank order; no float atomics), so a
// chunk is bit-reproducible.
//
// The code that runs in a step is kept under the SM's instruction cache
// (about 128 KB; straight-line code past it runs at a third of the speed):
// the products and the staging are functions that are not inlined, one
// copy each, and take shared-memory offsets rather than pointers.
//
// Shapes whose per-CTA footprint (layout() below; the same formula as
// ops/fused_train.py::cluster_footprint) exceeds 227 KB run fused_train.cu.
#include <cooperative_groups.h>

#include "common.cuh"
#include "sigmoid_pairs.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kCluster = 16;    // CTAs per cluster, ops/fused_train.py::CLUSTER
constexpr int kMaxLayers = 16;  // encoder + decoder layers
constexpr int kLatGroup = 8;    // latent components accumulated per pass
constexpr int kMetrics = 4;     // per-CTA partial sums: auto, center, reg, dist
constexpr int kStageBatch = 4;  // weight loads per thread in flight while staging
constexpr int kPhases = 11;     // cycle counters of the optional trace, see Phase
constexpr float kTwoPi = 6.28318530717958647692f;

// The kernel's dynamic shared memory. The functions that are not inlined
// take offsets into it, not pointers, so that their loads and stores stay
// shared-memory instructions.
extern __shared__ __align__(16) float smem[];

struct Args {
  // flat parameters, Adam moments: [W_0 .. W_{L-1}, b_0 .. b_{L-1}], W (din, dout)
  float* params;
  float* mu;
  float* nu;
  const float* data;     // (n_data, d0)
  const long long* idx;  // (steps, B)
  float* metrics;        // (steps, 5)
  long long* clocks;     // (kCluster, kPhases) cycles per phase summed over steps, or null
  int steps, B, d0, n_enc, n_layers, R;
  int din[kMaxLayers], dout[kMaxLayers];
  long long w_off[kMaxLayers], b_off[kMaxLayers];
  int w_vec[kMaxLayers];  // layer l's rows are whole float4s in global memory
  // shared-memory offsets in floats; act l: input of layer l, act L: output
  long long act_off[kMaxLayers + 1];
  // wp_off: the two weight buffers, each first a layer's staged weights,
  // then its partial gradients; layer l uses buffer l & 1
  long long wp_off[2], xown_off, dbuf_off[2], gpair_off, pair_off, xall_off, lall_off, bias_off,
      red_off, part_off;
  int periodic;
  float period;
  float auto_scale, center_scale, l2, dist_scale, lr;
  double step0;
  SideSig sh, sl;
};

__device__ __forceinline__ bool is_tanh(const Args& a, int l) {
  return l != a.n_enc - 1 && l != a.n_layers - 1;
}

// Row stride of a layer's staged weights: dout + 4 where its rows are whole
// float4s (16-byte loads and stores), else dout + 1.
__host__ __device__ __forceinline__ int w_ld(int vec, int dout) {
  return vec ? dout + 4 : dout + 1;
}

// What a product does with each of its sums v at (m, n): store it at
// out[m * ldo + n], after multiplying it by tanh' of x there (kTanhGrad), or
// after adding the center and sigmoid-loss gradients at the latent
// (kLatentGrad).
enum EpiMode { kStore, kTanhGrad, kLatentGrad };
struct Epi {  // offsets into smem
  int mode;
  int out;
  int ldo;
  int x;
  int gpair;
  float cscale;
};

// epi at (m, n) of sum_k A(m, k) B(k, n) for m < M, n < N, with the operands
// in shared memory (offsets a_off, b_off) at strides A(m, k) = A[m * am + k *
// ak], B(k, n) = B[k * bk + n * bn]: one stride of each is 1 (am if kAmUnit,
// else ak; bk if kBkUnit, else bn) and the other is as or bs. Each thread
// holds a 4 x 4 tile (rows 4h..4h+3, columns g, g+NG, g+2NG, g+3NG, so that
// neighbouring lanes read neighbouring columns) and loads four depth steps
// before it multiplies them; where there are fewer tiles than threads, S
// lanes split the depth and add their sums by shuffles. A warp runs its
// 32 / S tiles together (lanes past the last tile compute clamped rows and
// write nothing), so every shuffle has the whole warp. The order of every
// sum is fixed. Not inlined: one copy per stride pattern serves every layer
// (see the note on the instruction cache above).
template <bool kAmUnit, bool kBkUnit>
__device__ __noinline__ void gemm(int M, int N, int K, int a_off, int as, int b_off, int bs,
                                  Epi epi) {
  const int am = kAmUnit ? 1 : as, ak = kAmUnit ? as : 1;
  const int bk = kBkUnit ? 1 : bs, bn = kBkUnit ? bs : 1;
  const float* A = smem + a_off;
  const float* Bm = smem + b_off;
  float* out = smem + epi.out;
  const float* x = smem + epi.x;
  const float* gpair = smem + epi.gpair;
  const int NG = (N + 3) / 4, tiles = ((M + 3) / 4) * NG;
  int S = 1;
  while (S < 32 && tiles * S * 2 <= kThreads) S *= 2;
  const int s = threadIdx.x % S;
  const int sa = S * ak, sb = S * bk;
  for (int t0 = threadIdx.x / 32 * (32 / S); t0 < tiles; t0 += kThreads / S) {
    const int t = min(t0 + static_cast<int>(threadIdx.x % 32) / S, tiles - 1);
    const bool mine = t0 + static_cast<int>(threadIdx.x % 32) / S < tiles;
    const int h = t / NG, g = t - h * NG;
    const float* pa[4];
    const float* pb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pa[i] = A + min(4 * h + i, M - 1) * am + s * ak;
      pb[i] = Bm + min(g + i * NG, N - 1) * bn + s * bk;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    int k = s;
    for (; k + 3 * S < K; k += 4 * S) {
      float av[4][4], bv[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[u][i] = pa[i][u * sa];
          bv[u][i] = pb[i][u * sb];
        }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[u][i], bv[u][j], acc[i][j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] += 4 * sa;
        pb[i] += 4 * sb;
      }
    }
#pragma unroll 1
    for (; k < K; k += S) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(*pa[i], *pb[j], acc[i][j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] += sa;
        pb[i] += sb;
      }
    }
#pragma unroll 1
    for (int off = S / 2; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
    if (s == 0 && mine) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = 4 * h + i, n = g + j * NG;
          if (m < M && n < N) {
            const int e = m * epi.ldo + n;
            float v = acc[i][j];
            if (epi.mode == kTanhGrad) {
              v *= 1.f - x[e] * x[e];
            } else if (epi.mode == kLatentGrad) {
              v += epi.cscale * x[e] + gpair[e];
            }
            out[e] = v;
          }
        }
    }
  }
}

// Sum over the block in a fixed order; every thread gets the total.
__device__ float block_sum(float v, float* red) {
  __syncthreads();
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

// This CTA's rows of step s: raw rows to xown (nr, d0), the encoder input
// (sin/cos folded if periodic) to act 0.
__device__ void gather(const Args& a, float* sm, int s, int r0, int nr) {
  float* xown = sm + a.xown_off;
  float* x0 = sm + a.act_off[0];
  const long long* ix = a.idx + static_cast<size_t>(s) * a.B + r0;
  for (int e = threadIdx.x; e < nr * a.d0; e += kThreads) {
    const int b = e / a.d0, k = e - b * a.d0;
    const float x = a.data[static_cast<size_t>(ix[b]) * a.d0 + k];
    xown[e] = x;
    if (a.periodic) {
      const float xs = a.period == kTwoPi ? x : x / a.period * kTwoPi;
      x0[b * 2 * a.d0 + k] = sinf(xs);
      x0[b * 2 * a.d0 + a.d0 + k] = cosf(xs);
    } else {
      x0[e] = x;
    }
  }
  __syncthreads();
}

// 16 bytes from global to shared memory, asynchronously and past L1.
__device__ __forceinline__ void cp_async_cg16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// A layer's din x dout weights W into the shared-memory buffer at wp_off, at
// row stride w_ld(vec, dout), from L2 (a peer updated them in the previous
// step, so no load goes through L1). Where the rows are whole float4s, as
// asynchronous 16-byte copies (cp.async.cg) that stage_wait completes, so
// that they overlap the work issued between the two; else with __ldcg
// loads, kStageBatch in flight per thread. Each thread walks (row, column)
// pairs kThreads loads apart, without a division per element. Not inlined
// (see the note on the instruction cache above); it takes no Args, which
// would then be copied to local memory.
__device__ __noinline__ void stage_weights(const float* W, int din, int dout, int vec,
                                           int wp_off) {
  float* wp = smem + wp_off;
  const int ld = w_ld(vec, dout);
  const int q = vec ? dout / 4 : dout;  // loads per row
  const int n = din * q;                // loads in all
  const int dk = kThreads / q, dc = kThreads % q;
  int k = threadIdx.x / q, c = threadIdx.x % q;
  if (vec) {
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += kThreads) {
      cp_async_cg16(wp + k * ld + 4 * c, W + 4 * i);
      k += dk;
      c += dc;
      if (c >= q) {
        c -= q;
        ++k;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    return;
  }
  for (int i = threadIdx.x; i < n; i += kStageBatch * kThreads) {
    float v[kStageBatch];
    int kk[kStageBatch], cc[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      kk[u] = k;
      cc[u] = c;
      if (i + u * kThreads < n) v[u] = __ldcg(W + i + u * kThreads);
      k += dk;
      c += dc;
      if (c >= q) {
        c -= q;
        ++k;
      }
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u)
      if (i + u * kThreads < n) wp[kk[u] * ld + cc[u]] = v[u];
  }
}

// Layer l's weights into weight buffer l & 1; stage_wait completes them.
__device__ __forceinline__ void stage_layer(const Args& a, int l) {
  stage_weights(a.params + a.w_off[l], a.din[l], a.dout[l], a.w_vec[l],
                static_cast<int>(a.wp_off[l & 1]));
}

// This thread's asynchronous copies are in; then the block's.
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Layer l's outputs of this CTA's rows, from its staged weights; the bias
// (from L2 while the product runs) and tanh in a second pass, so that the
// product's epilogue stays small.
__device__ void forward_layer(const Args& a, float* sm, int l, int nr) {
  const int din = a.din[l], dout = a.dout[l];
  float* bias = sm + a.bias_off;
  float* out = sm + a.act_off[l + 1];
  const float* b = a.params + a.b_off[l];
  const float b0 = threadIdx.x < dout ? __ldcg(b + threadIdx.x) : 0.f;
  gemm<false, false>(nr, dout, din, static_cast<int>(a.act_off[l]), din,
                     static_cast<int>(a.wp_off[l & 1]), w_ld(a.w_vec[l], dout),
                     Epi{kStore, static_cast<int>(a.act_off[l + 1]), dout, 0, 0, 0.f});
  if (threadIdx.x < dout) bias[threadIdx.x] = b0;
  for (int o = threadIdx.x + kThreads; o < dout; o += kThreads) bias[o] = __ldcg(b + o);
  __syncthreads();
  const bool act = is_tanh(a, l);
#pragma unroll 1
  for (int e = threadIdx.x; e < nr * dout; e += kThreads) {
    const float v = out[e] + bias[e % dout];
    out[e] = act ? tanhf(v) : v;
  }
  __syncthreads();
}

// After the cluster barrier: every row's raw input and latent from its
// owner, the sketch-map terms of this CTA's rows against all rows (their
// latent gradient to gpair), the auto loss's gradient of its rows (to the
// delta buffer of the last layer), and the CTA's partial metric sums.
__device__ void loss_phase(const Args& a, float* sm, cg::cluster_group& cluster, int s,
                           int r0, int nr) {
  const int B = a.B, d0 = a.d0, L = a.n_layers, R = a.R;
  const int dl = a.dout[a.n_enc - 1];
  float* xall = sm + a.xall_off;
  float* lall = sm + a.lall_off;
#pragma unroll 1
  for (int b = threadIdx.x; b < B; b += kThreads) {
    const int q = b / R, r = b - q * R;
    const float* px = cluster.map_shared_rank(sm + a.xown_off, q) + r * d0;
    const float* pl = cluster.map_shared_rank(sm + a.act_off[a.n_enc], q) + r * dl;
#pragma unroll 1
    for (int k = 0; k < d0; ++k) xall[b * d0 + k] = px[k];
#pragma unroll 1
    for (int k = 0; k < dl; ++k) lall[b * dl + k] = pl[k];
  }
  __syncthreads();

  const float* xown = sm + a.xown_off;
  const float* lat = sm + a.act_off[a.n_enc];
  const float* dec = sm + a.act_off[L];
  float* gout = sm + a.dbuf_off[(L - 1) & 1];
  float p_auto = 0.f, p_center = 0.f, p_dist = 0.f;

  // sketch-map sigmoid, half the pairs: row i takes j = (i + t) mod B for
  // t = 1 .. B/2 (t = B/2, for even B, only where i < B/2), so each
  // unordered pair is evaluated once in the cluster. Each side's s as every
  // kernel of the port takes it (sigmoid_pairs.cuh: sig_t, then sig_s,
  // without the cancellation of 1 - u^e near u = 1), one pair a lane at a
  // time: a tile of 2 or 4 pairs a lane cut this phase by 1.2 and 2.4 us at
  // B=256 on an H100 but grew the kernel's code by 10 and 21 % and its
  // other phases by as much, and the step was no faster (PERF.md). The
  // pair's s'(r)/r-weighted difference m = (s_l - s_h) dscale u^(e-1)
  // [t / r^2 unless a == 2], 0 where the latent distance is 0, goes to
  // pairs[r][t - 1]; pair_gradients reads the other half from the CTAs
  // that own those rows. One warp per own row.
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int hw = B / 2;
  float* pairs = sm + a.pair_off;
#pragma unroll 1
  for (int r = warp; r < nr; r += kThreads / 32) {
    const int i = r0 + r;
    const int h = (B % 2 == 0 && i >= hw) ? hw - 1 : hw;
    float sq = 0.f;
#pragma unroll 1
    for (int t = 1 + lane; t <= h; t += 32) {
      const int j = i + t < B ? i + t : i + t - B;
      float dh2 = 0.f;
#pragma unroll 1
      for (int k = 0; k < d0; ++k) {
        float d = xall[i * d0 + k] - xall[j * d0 + k];
        if (a.periodic) {
          d = fabsf(d);
          d = fminf(d, a.period - d);
        }
        dh2 += d * d;
      }
      float dl2 = 0.f;
#pragma unroll 1
      for (int k = 0; k < dl; ++k) {
        const float d = lall[i * dl + k] - lall[j * dl + k];
        dl2 += d * d;
      }
      float sh[1] = {dh2}, sl[1] = {dl2}, y[1], iu[1], g = 0.f;
      sig_t<1, false>(a.sh, sh);
      sig_s<1>(a.sh, sh, y, iu);
      sig_t<1, false>(a.sl, sl);
      if (a.sl.half_a != 1) g = sl[0] / dl2;  // t / r^2, 0 where t underflows
      sig_s<1>(a.sl, sl, y, iu);
      const float sdiff = sl[0] - sh[0];
      sq += sdiff * sdiff;
      float gq = a.sl.dscale * y[0] * iu[0];
      if (a.sl.half_a != 1) gq *= g;
      pairs[r * hw + t - 1] = dl2 != 0.f ? sdiff * gq : 0.f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_down_sync(0xffffffffu, sq, off);
    if (lane == 0) p_dist += 2.f * sq;  // both orders of each pair
  }

  // auto loss and its gradient into the decoder output
  const float gscale = a.auto_scale / (static_cast<float>(B) * d0);
  for (int e = threadIdx.x; e < nr * d0; e += kThreads) {
    const int b = e / d0, k = e - b * d0;
    const float x = xown[e];
    if (a.periodic) {
      const int w = 2 * d0;
      const float sn = dec[b * w + k], cs = dec[b * w + d0 + k];
      const float norm2 = sn * sn + cs * cs;
      float out = atan2f(sn, cs);
      if (a.period != kTwoPi) out = out / kTwoPi * a.period;
      const float ad = fabsf(x - out);
      const float flip = ad <= a.period - ad ? 1.f : -1.f;
      p_auto += fminf(ad, a.period - ad);
      const float diff = out - x;
      float g = gscale * flip * (diff > 0.f ? 1.f : (diff < 0.f ? -1.f : 0.f));
      if (a.period != kTwoPi) g = g / kTwoPi * a.period;
      gout[b * w + k] = g * cs / norm2;
      gout[b * w + d0 + k] = -g * sn / norm2;
    } else {
      const float diff = x - dec[e];
      p_auto += fabsf(diff);
      gout[e] = -gscale * (diff > 0.f ? 1.f : (diff < 0.f ? -1.f : 0.f));
    }
  }
  for (int e = threadIdx.x; e < nr * dl; e += kThreads) p_center += lat[e] * lat[e];

  float* red = sm + a.red_off;
  float* part = sm + a.part_off + (s & 1) * kMetrics;
  const float s0 = block_sum(p_auto, red);
  const float s1 = block_sum(p_center, red);
  const float s3 = block_sum(p_dist, red);
  if (threadIdx.x == 0) {
    part[0] = s0;
    part[1] = s1;
    part[3] = s3;
  }
  __syncthreads();
}

// The sigmoid loss's latent gradient of this CTA's rows, to gpair, once every
// CTA's half of the pairs is written (after a cluster barrier):
// (4 scale / B^2) sum_j m_ij (l_i - l_j), with m_ij from this CTA's pairs or,
// for the other half, from the CTA that owns row j: those are first copied
// into pairs_in, four loads in flight per thread. Then one warp per own row,
// lanes over j, the latent in groups of kLatGroup.
__device__ void pair_gradients(const Args& a, float* sm, cg::cluster_group& cluster, int r0,
                               int nr) {
  const int B = a.B, R = a.R, hw = B / 2;
  const int dl = a.dout[a.n_enc - 1];
  const float* lall = sm + a.lall_off;
  const float* pairs = sm + a.pair_off;
  float* pairs_in = sm + a.pair_off + static_cast<long long>(R) * hw;
  float* gpair = sm + a.gpair_off;
  // pairs_in[r][t - 1]: the pair of row i = r0 + r with j = (i - t) mod B,
  // where it is in row j's half
#pragma unroll 1
  for (int e0 = threadIdx.x; e0 < nr * hw; e0 += 4 * kThreads) {
    float v[4];
    bool valid[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * kThreads;
      const int r = e / hw, t = e - r * hw + 1;
      const int j = r0 + r - t >= 0 ? r0 + r - t : r0 + r - t + B;
      valid[u] = e < nr * hw && t <= ((B % 2 == 0 && j >= hw) ? hw - 1 : hw);
      if (valid[u]) {
        const int q = j / R;
        v[u] = cluster.map_shared_rank(sm + a.pair_off, q)[(j - q * R) * hw + t - 1];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (valid[u]) pairs_in[e0 + u * kThreads] = v[u];
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float mscale = 4.f * a.dist_scale / (static_cast<float>(B) * B);
#pragma unroll 1
  for (int r = warp; r < nr; r += kThreads / 32) {
    const int i = r0 + r;
    const int h = (B % 2 == 0 && i >= hw) ? hw - 1 : hw;
#pragma unroll 1
    for (int k0 = 0; k0 < dl; k0 += kLatGroup) {
      const int kg = min(kLatGroup, dl - k0);
      float rowsum = 0.f, ml[kLatGroup];
#pragma unroll
      for (int k = 0; k < kLatGroup; ++k) ml[k] = 0.f;
#pragma unroll 1
      for (int j = lane; j < B; j += 32) {
        if (j == i) continue;
        const int t = j > i ? j - i : j - i + B;  // j = (i + t) mod B
        // i = (j + (B - t)) mod B: otherwise the pair is in row j's half
        const float m = t <= h ? pairs[r * hw + t - 1] : pairs_in[r * hw + B - t - 1];
        rowsum += m;
#pragma unroll
        for (int k = 0; k < kLatGroup; ++k)
          if (k < kg) ml[k] += m * lall[j * dl + k0 + k];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        rowsum += __shfl_down_sync(0xffffffffu, rowsum, off);
#pragma unroll
        for (int k = 0; k < kLatGroup; ++k) ml[k] += __shfl_down_sync(0xffffffffu, ml[k], off);
      }
      if (lane == 0)
        for (int k = 0; k < kg; ++k)
          gpair[r * dl + k0 + k] = mscale * (rowsum * lall[i * dl + k0 + k] - ml[k]);
    }
  }
  __syncthreads();
}

// This CTA's share of the backward pass through layer l > 0: the delta of
// layer l - 1 of its rows, from the layer's old weights (staged), through
// tanh' or, at the latent, plus the center and sigmoid-loss gradients.
__device__ void backward_delta(const Args& a, float* sm, int l, int nr) {
  const int din = a.din[l], dout = a.dout[l];
  const bool at_latent = l - 1 == a.n_enc - 1;
  const float cscale = 2.f * a.center_scale / (static_cast<float>(a.B) * din);
  gemm<false, true>(nr, din, dout, static_cast<int>(a.dbuf_off[l & 1]), dout,
                    static_cast<int>(a.wp_off[l & 1]), w_ld(a.w_vec[l], dout),
                    Epi{at_latent ? kLatentGrad : kTanhGrad,
                        static_cast<int>(a.dbuf_off[(l + 1) & 1]), din,
                        static_cast<int>(a.act_off[l]), static_cast<int>(a.gpair_off), cscale});
  __syncthreads();
}

// This CTA's partial weight (rows 0..din-1) and bias (row din) gradients of
// layer l over its rows, into its weight buffer.
__device__ void backward_partial(const Args& a, float* sm, int l, int nr) {
  const int din = a.din[l], dout = a.dout[l];
  float* wp = sm + a.wp_off[l & 1];
  const float* delta = sm + a.dbuf_off[l & 1];
  for (int n = threadIdx.x; n < dout; n += kThreads) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    int r = 0;
#pragma unroll 1
    for (; r + 3 < nr; r += 4) {
      s0 += delta[r * dout + n];
      s1 += delta[(r + 1) * dout + n];
      s2 += delta[(r + 2) * dout + n];
      s3 += delta[(r + 3) * dout + n];
    }
#pragma unroll 1
    for (; r < nr; ++r) s0 += delta[r * dout + n];
    wp[din * dout + n] = (s0 + s1) + (s2 + s3);
  }
  gemm<true, false>(din, dout, nr, static_cast<int>(a.act_off[l]), din,
                    static_cast<int>(a.dbuf_off[l & 1]), dout,
                    Epi{kStore, static_cast<int>(a.wp_off[l & 1]), dout, 0, 0, 0.f});
}

// After the cluster barrier: this CTA owns elements [lo, hi) of layer l's
// (din + 1) x dout gradient. It adds the C partials from its peers' weight
// buffers l & 1, starting at its own rank (a fixed order for each element; the
// CTAs do not all read one peer at once), adds the L2 gradient to the
// kernel, clips to +-1 and applies Adam in place. Returns the thread's share
// of sum(W^2) over the old weights it owns.
__device__ float owner_adam(const Args& a, float* sm, cg::cluster_group& cluster, int rank,
                            int l, int s) {
  const int n_w = a.din[l] * a.dout[l], n = n_w + a.dout[l];
  const int lo = n * rank / kCluster, hi = n * (rank + 1) / kCluster;
  const AdamStep ad = adam_step(a.step0 + s + 1);
  const float eps = 1e-7f;
  const float* peers[kCluster];
#pragma unroll
  for (int c = 0; c < kCluster; ++c)
    peers[c] = cluster.map_shared_rank(sm + a.wp_off[l & 1], (rank + c) % kCluster);
  float reg = 0.f;
#pragma unroll 1
  for (int e = lo + threadIdx.x; e < hi; e += kThreads) {
    const int i = static_cast<int>(e < n_w ? a.w_off[l] + e : a.b_off[l] + (e - n_w));
    const float p = __ldcg(a.params + i), m = __ldcg(a.mu + i), v = __ldcg(a.nu + i);
    float g = 0.f;
#pragma unroll
    for (int c = 0; c < kCluster; ++c) g += peers[c][e];
    if (e < n_w) {
      g += 2.f * a.l2 * p;
      reg += p * p;
    }
    g = fminf(fmaxf(g, -1.f), 1.f);
    const float mu = ad.b1 * m + ad.c1 * g;
    const float nu = ad.b2 * v + ad.c2 * g * g;
    __stcg(a.mu + i, mu);
    __stcg(a.nu + i, nu);
    __stcg(a.params + i, p - a.lr * (mu / ad.bc1) / (sqrtf(nu / ad.bc2) + eps));
  }
  return reg;
}

// Phases of the optional cycle trace (Args::clocks), as thread 0 of each
// CTA sees them; a barrier's wait is the time its CTA idles there.
enum Phase {
  kGather, kStage, kForward, kWaitLoss, kLoss, kPairGrad, kDelta, kPartial, kWaitReduce, kAdam,
  kWaitUpdate
};

struct Trace {
  long long acc[kPhases];
  long long t;
  bool on;
  __device__ explicit Trace(bool enabled) : t(0), on(enabled && threadIdx.x == 0) {
    for (int i = 0; i < kPhases; ++i) acc[i] = 0;
    if (on) t = clock64();
  }
  __device__ void lap(int phase) {
    if (!on) return;
    const long long now = clock64();
    acc[phase] += now - t;
    t = now;
  }
};

__global__ void __launch_bounds__(kThreads, 1) fused_train_cluster_kernel(Args a) {
  float* sm = smem;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int r0 = rank * a.R;
  const int nr = max(0, min(a.R, a.B - r0));
  Trace tr(a.clocks != nullptr);
  for (int s = 0; s < a.steps; ++s) {
    // layer l + 1's weights are copied in while layer l computes
    stage_layer(a, 0);
    tr.lap(kStage);
    gather(a, sm, s, r0, nr);
    tr.lap(kGather);
    stage_wait();
    tr.lap(kStage);
    for (int l = 0; l < a.n_layers; ++l) {
      const bool next = l + 1 < a.n_layers;
      if (next) stage_layer(a, l + 1);
      tr.lap(kStage);
      forward_layer(a, sm, l, nr);
      tr.lap(kForward);
      if (next) stage_wait();
      tr.lap(kStage);
    }
    cluster.sync();  // every CTA's inputs and latents are in place
    tr.lap(kWaitLoss);
    loss_phase(a, sm, cluster, s, r0, nr);
    tr.lap(kLoss);
    // buffer (L - 1) & 1 still holds the last layer's weights. Layer l - 1's
    // old weights are copied in while layer l is reduced: its owners update
    // them only after the barrier that follows its partials, and the copy
    // goes to the buffer whose partials every peer has read
    float reg = 0.f;
    for (int l = a.n_layers - 1; l >= 0; --l) {
      if (l > 1) stage_layer(a, l - 1);
      tr.lap(kStage);
      if (l == a.n_enc) {
        // the latent's delta needs every CTA's pairs: a barrier has passed
        // since the losses unless the decoder is one layer
        if (l == a.n_layers - 1) cluster.sync();
        tr.lap(kWaitReduce);
        pair_gradients(a, sm, cluster, r0, nr);
        tr.lap(kPairGrad);
      }
      if (l > 0) {
        backward_delta(a, sm, l, nr);
        tr.lap(kDelta);
      }
      backward_partial(a, sm, l, nr);
      tr.lap(kPartial);
      cluster.sync();  // every partial is written; the old weights are read
      tr.lap(kWaitReduce);
      reg += owner_adam(a, sm, cluster, rank, l, s);
      if (l == 0) {
        const float total = block_sum(reg, sm + a.red_off);
        if (threadIdx.x == 0) sm[a.part_off + (s & 1) * kMetrics + 2] = total;
      }
      tr.lap(kAdam);
      cluster.sync();  // the partials are read; the update is visible
      tr.lap(kWaitUpdate);
      if (l > 1) stage_wait();
      tr.lap(kStage);
    }
    if (rank == 0 && threadIdx.x == 0) {
      // a peer's slot s & 1 is next written in step s + 2, after a barrier
      // that this thread reaches only once it is done here
      float sum[kMetrics] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < kCluster; ++c) {
        const float* part = cluster.map_shared_rank(sm + a.part_off, c) + (s & 1) * kMetrics;
        for (int m = 0; m < kMetrics; ++m) sum[m] += part[m];
      }
      const int dl = a.dout[a.n_enc - 1];
      const float B = static_cast<float>(a.B);
      const float auto_loss = a.auto_scale * (sum[0] / (B * a.d0));
      const float center = a.center_scale * (sum[1] / (B * dl));
      const float reg_loss = a.l2 * sum[2];
      const float dist = a.dist_scale * (sum[3] / (B * B));
      float* row = a.metrics + static_cast<size_t>(s) * 5;
      row[0] = auto_loss;
      row[1] = center;
      row[2] = reg_loss;
      row[3] = dist;
      row[4] = auto_loss + center + reg_loss + dist;
    }
    tr.lap(kAdam);
  }
  if (tr.on)
    for (int i = 0; i < kPhases; ++i) a.clocks[rank * kPhases + i] = tr.acc[i];
  cluster.sync();  // no CTA leaves while rank 0 still reads its shared memory
}

// Fill the layer table and the shared-memory layout; returns the floats of
// shared memory one CTA needs. ops/fused_train.py::cluster_footprint holds
// the same formula.
long long layout(Args& a, int n_enc, int n_dec, const int* dims, int B, int d0) {
  const int L = n_enc + n_dec;
  a.n_enc = n_enc;
  a.n_layers = L;
  a.B = B;
  a.d0 = d0;
  a.R = (B + kCluster - 1) / kCluster;
  long long off = 0, wp = 0;
  for (int l = 0; l < L; ++l) {
    const int din = dims[l], dout = dims[l + 1];
    a.din[l] = din;
    a.dout[l] = dout;
    a.w_off[l] = off;
    a.w_vec[l] = off % 4 == 0 && dout % 4 == 0;
    off += static_cast<long long>(din) * dout;
    const long long staged = static_cast<long long>(din) * w_ld(a.w_vec[l], dout);
    const long long partial = static_cast<long long>(din + 1) * dout;
    wp = staged > wp ? staged : wp;
    wp = partial > wp ? partial : wp;
  }
  for (int l = 0; l < L; ++l) {
    a.b_off[l] = off;
    off += dims[l + 1];
  }
  wp = (wp + 3) / 4 * 4;  // whole float4s, so that both buffers are aligned
  const long long R = a.R;
  long long s = 0;
  a.wp_off[0] = s;  // first, so that it is 16-byte aligned
  s += wp;
  a.wp_off[1] = s;
  s += wp;
  int maxw = 0;
  for (int l = 0; l <= L; ++l) {
    a.act_off[l] = s;
    s += R * dims[l];
    maxw = dims[l] > maxw ? dims[l] : maxw;
  }
  const int dl = dims[n_enc];
  a.xown_off = s;
  s += R * d0;
  a.dbuf_off[0] = s;
  s += R * maxw;
  a.dbuf_off[1] = s;
  s += R * maxw;
  a.gpair_off = s;
  s += R * dl;
  a.pair_off = s;  // this CTA's half of its rows' pairs, then the other half
  s += 2 * R * (B / 2);
  a.xall_off = s;
  s += static_cast<long long>(B) * d0;
  a.lall_off = s;
  s += static_cast<long long>(B) * dl;
  a.bias_off = s;
  s += maxw;
  a.red_off = s;
  s += kThreads;
  a.part_off = s;
  s += 2 * kMetrics;
  return s;
}

int launch(const Args& a, long long bytes, cudaStream_t stream) {
  void (*kernel)(Args) = fused_train_cluster_kernel;
  // fails where one block may not have this much shared memory
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;  // no SM group can hold the cluster
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Run `steps` optimizer steps on one cluster of kCluster CTAs; params, mu
// and nu are updated in place. hyper = [auto, center, l2, dist scales,
// sig_h, a_h, b_h, sig_l, a_l, b_l, periodicity (inf: none), learning rate].
// clocks, if not null, receives (kCluster, 11) int64 cycle counts per phase
// (Phase above), summed over the steps.
int em_fused_train_cluster(float* params, float* mu, float* nu, const float* data,
                           const long long* idx, int steps, int B, int d0, int n_enc, int n_dec,
                           const int* dims, double step0, const double* hyper, float* metrics,
                           long long* clocks, void* stream) {
  if (n_enc + n_dec > kMaxLayers) return cudaErrorInvalidValue;
  Args a;
  const long long bytes = 4 * layout(a, n_enc, n_dec, dims, B, d0);
  a.params = params;
  a.mu = mu;
  a.nu = nu;
  a.data = data;
  a.idx = idx;
  a.metrics = metrics;
  a.clocks = clocks;
  a.steps = steps;
  a.step0 = step0;
  a.auto_scale = static_cast<float>(hyper[0]);
  a.center_scale = static_cast<float>(hyper[1]);
  a.l2 = static_cast<float>(hyper[2]);
  a.dist_scale = static_cast<float>(hyper[3]);
  a.sh = make_side(hyper[4], hyper[5], hyper[6]);
  a.sl = make_side(hyper[7], hyper[8], hyper[9]);
  a.periodic = std::isfinite(hyper[10]) ? 1 : 0;
  a.period = static_cast<float>(a.periodic ? hyper[10] : 0.0);
  a.lr = static_cast<float>(hyper[11]);
  return launch(a, bytes, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
