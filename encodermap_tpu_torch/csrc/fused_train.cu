// encodermap_tpu_torch/csrc/fused_train.cu
//
// A chunk of EncoderMap optimizer steps in one launch over the whole card,
// for Hopper (sm_90a): the grid form, for the shapes whose rows outgrow one
// thread-block cluster's shared memory (fused_train_cluster.cu takes the
// others; ops/fused_train.py::fused_route picks).
//
// Replaces the TPU kernel encodermap_tpu/ops/pallas_train.py::_fused_kernel.
// Each step: gather the batch rows given by the (steps, B) index array from
// the device-resident dataset (sin/cos fold-in for periodic data), run the
// tanh MLP encoder to a linear latent and the tanh MLP decoder to a linear
// output (atan2 fold-out), compute the auto (mean_abs, min-image if
// periodic), center, L2 and sketch-map sigmoid losses over all B x B pairs,
// run the hand-derived backward pass (hand_step of ops/fused_train.py),
// clip every gradient element to +-1, apply Adam with bias correction, and
// write one metrics row (auto, center, reg, dist, total).
//
// What bounds it: at [128,128,2], B=1024 a step is ~0.27 GFLOP, 4 us of the
// card's f32 rate; at B=16384 the B^2 / 2 sketch-map pairs are 81 % of the
// operations. No shape is near its operation count: the step is set by
// latency and synchronisation (L2 round trips, barriers), so the design
// cuts barriers and round trips:
//
// * Row groups on thread-block clusters. The batch is split into G row
//   groups of R rows (a multiple of the product tile), one cluster of
//   kCluster CTAs each. Gather, the forward pass, the losses of a row and
//   the backward delta chain need only the group's rows, so each layer
//   ends with a hardware cluster barrier, not a grid-wide one. Activations
//   and deltas live in global scratch (L2) and cross CTAs there: every load
//   of data another CTA wrote in this launch bypasses L1 (ld.global.cg).
// * Four grid-wide barriers a step, where rows meet: the latents (before the
//   pair phase), the pair slots (before the latent gradient), the partial
//   weight gradients (before the reduction and Adam) and the end of Adam
//   (before the next gather). The launch is cooperative with a cluster
//   dimension, so all CTAs are co-resident and cg::this_grid().sync()
//   works; one cluster more than the card holds is refused at launch.
// * Tiled products. Every product (forward X W, the delta Delta W^T times
//   tanh', the weight gradient X^T Delta per row group) is cut into 32 x 32
//   or 64 x 64 output tiles shared out over the cluster's CTAs; a tile
//   stages chunks of both operands into shared memory (the next chunk in
//   registers while the current one is multiplied), and each thread sums a
//   2 x 2 or 4 x 4 register tile over the whole depth in order, FFMA only,
//   as a plain product does (splitting the depth four ways ran faster at
//   small batches but strayed further from the plain version over a few
//   periodic steps). A layer's weights are streamed, so any
//   width works. The weight gradient of a row group goes to its own slot
//   (bias as a row of ones); Adam adds the G slots in group order.
// * The sketch-map pairs, each unordered pair once: 64 x 64 tiles of the
//   upper triangle spread over all CTAs, 16 x 16 threads of 4 x 4 pairs,
//   the cheap powers of sigmoid_pairs.cuh, with s = 1 - u^e taken without
//   cancellation (sig_s: at the default parameters one rsqrtf and two
//   reciprocals a pair, no powf). One pass gives the loss partial and the
//   latent gradient's sums sum_j f_ij (l_i - l_j) into per-tile slots; each
//   row group adds its rows' slots in tile order.
//
// Every sum is taken in a fixed order, with no float atomics, so a chunk
// gives the same bits twice. f32 throughout.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "sigmoid_pairs.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kCluster = 8;      // CTAs per row group, ops/fused_train.py::GRID_CLUSTER
constexpr int kMaxLayers = 16;   // encoder + decoder layers
constexpr int kMaxInput = 32;    // raw input columns (the gate's widest)
constexpr int kMetrics = 4;      // per-CTA partial sums: auto, center, reg, dist
constexpr int kTile = 32;        // row tile of a group, ops/fused_train.py::GRID_TILE
constexpr int kWide = 64;        // the wide product tile's edge
constexpr int kDepthSmall = 16;  // depth of a staged chunk of a 32-edge tile
constexpr int kDepthWide = 32;   // of a 64-edge tile
constexpr int kPair = 64;        // rows (and columns) of pairs in one pass
constexpr int kLdP = kPair + 4;  // row stride of a staged pair tile
constexpr int kNP = 16;          // pairs per thread (4 x 4)
constexpr int kChunk = 32;       // latent columns staged at once
constexpr int kVGroup = 4;       // latent sums reduced at once
constexpr int kWarps = kThreads / 32;
constexpr int kPhases = 11;      // cycle counters of the optional trace, see Phase
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTwoPi = 6.28318530717958647692f;

// dynamic shared memory, floats: a product tile's two staged chunks, or a
// pair tile's staged rows and its row and column sums; then the block
// sum's buffer
constexpr int kGemmSmall = 2 * kDepthSmall * (kTile + 4);
constexpr int kGemmWide = 2 * kDepthWide * (kWide + 4);
constexpr int kGemmFloats = kGemmSmall > kGemmWide ? kGemmSmall : kGemmWide;
constexpr int kPairFloats = 4 * kChunk * kLdP + kVGroup * kPair + kVGroup * kWarps * kPair;
constexpr int kRedOff = kGemmFloats > kPairFloats ? kGemmFloats : kPairFloats;
constexpr int kSmemFloats = kRedOff + kThreads;

extern __shared__ __align__(16) float smem[];

struct Args {
  // flat parameters, Adam moments: [W_0 .. W_{L-1}, b_0 .. b_{L-1}], W (din, dout)
  float* params;
  float* mu;
  float* nu;
  const float* data;      // (n_data, d0)
  const long long* idx;   // (steps, B)
  float* metrics;         // (steps, 5)
  float* scratch;
  long long* clocks;      // (CTAs, kPhases) cycles per phase summed over steps, or null
  int steps, B, d0, n_enc, n_layers;
  int groups, rows, nt;   // row groups, rows per group, pair tiles per edge
  int maxw;               // widest layer: a row group's delta rows lie in rows x maxw
  int din[kMaxLayers], dout[kMaxLayers];
  long long w_off[kMaxLayers], b_off[kMaxLayers];
  long long act_off[kMaxLayers + 1];  // act 0: encoder input, act l+1: output of layer l
  long long n_weights, n_params;
  int dl;                 // latent width
  // scratch offsets (lat_off, dec_off: the latent's and the output's activations)
  long long lat_off, dec_off;
  long long xb_off, dbuf_off[2], gpair_off, slot_off, part_off, wslot_off;
  int periodic;
  float period;
  float auto_scale, center_scale, l2, dist_scale, lr;
  double step0;
  SideSig sh, sl;
};

__device__ __forceinline__ bool is_tanh(const Args& a, int l) {
  return l != a.n_enc - 1 && l != a.n_layers - 1;
}

// One layer's entry of the table, which the kernel copies to shared memory
// at its start for the layer loops.
struct Layer {
  int din, dout;
  long long w_off, b_off, in_off, out_off;  // in_off, out_off: act l, act l + 1
};

// The cluster's barrier. Its arrive has release and its wait acquire
// semantics at cluster scope, which order this CTA's global writes before
// the peers' loads after it (those go to L2, past L1).
__device__ __forceinline__ void cluster_sync(cg::cluster_group& cluster) { cluster.sync(); }

// Sum over the block in a fixed order; every thread gets the total.
__device__ float block_sum(float v) {
  float* red = smem + kRedOff;
  __syncthreads();
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

// Step s's rows of this row group (its CTAs share them out): raw rows to xb
// (B, d0), the encoder input (sin/cos folded if periodic) to act 0.
// (The phases that are not inlined copy the arguments they use to locals
// first: read through a reference, each field would be loaded again after
// every store, which might alias it.)
__device__ __noinline__ void gather(const Args& a, int s, int r0, int nr, int rank) {
  float* xb = a.scratch + a.xb_off;
  float* x0 = a.scratch + a.act_off[0];
  const float* data = a.data;
  const long long* ix = a.idx + static_cast<size_t>(s) * a.B;
  const int d0 = a.d0, periodic = a.periodic;
  const float period = a.period;
  for (int e = rank * kThreads + threadIdx.x; e < nr * d0; e += kCluster * kThreads) {
    const int b = r0 + e / d0, k = e % d0;
    const float x = __ldg(data + static_cast<size_t>(__ldg(ix + b)) * d0 + k);
    xb[b * d0 + k] = x;
    if (periodic) {
      const float xs = period == kTwoPi ? x : x / period * kTwoPi;
      x0[b * 2 * d0 + k] = sinf(xs);
      x0[b * 2 * d0 + d0 + k] = cosf(xs);
    } else {
      x0[b * d0 + k] = x;
    }
  }
}

// What a product does with each of its sums v at (m, n).
enum EpiMode { kForward, kTanhGrad, kLatentGrad, kWeightGrad };
struct Epi {
  int mode;
  float* out;            // out[m * ldo + n]
  int ldo;
  const float* bias;     // kForward: bias[n] added
  int tanh;              // kForward: tanh after the bias
  const float* x;        // kTanhGrad: times 1 - x^2; kLatentGrad: + cscale x + gpair
  const float* gpair;
  float cscale;
  float* bout;           // kWeightGrad: row m == ones_row to bout[n]
  int ones_row;
};

// What a product does with its sum v at (m, n), given the bias (kForward)
// or x and the pair gradient there.
__device__ __forceinline__ void epilogue(const Epi& epi, int m, int n, float v, float x, float g) {
  if (epi.mode == kForward) {
    v += x;
    if (epi.tanh) v = tanhf(v);
  } else if (epi.mode == kTanhGrad) {
    v *= 1.f - x * x;
  } else if (epi.mode == kLatentGrad) {
    v += epi.cscale * x + g;
  } else if (m == epi.ones_row) {
    epi.bout[n] = v;
    return;
  }
  epi.out[static_cast<size_t>(m) * epi.ldo + n] = v;
}

// The T x T tile at (m0, n0) of the M x N product sum_k A(m, k) B(k, n),
// A(m, k) = A[m am + k ak] (A(ones_row, k) = 1 where ones_row >= 0),
// B(k, n) = B[k bk + n bn], both in global memory written in this launch
// (read past L1), then the epilogue. kDepth-deep chunks of both are staged
// in shared memory, the next chunk's loads in flight while the current one
// is multiplied. The 256 threads are 16 x 16, each with an RT x RT register
// tile (RT = T / 16: rows RT ty.., columns RT tx..) summed over the whole
// depth in order, as a plain product would, and read from shared memory
// RT values at a time. Not inlined: one copy of each T serves every
// product.
template <int T, int kDepth>
__device__ __noinline__ void gemm_tile(int M, int N, int K, const float* A, int am, int ak,
                                       const float* Bm, int bk, int bn, int m0, int n0,
                                       Epi epi) {
  constexpr int RT = T / 16, kLd = T + 4, kLoads = T * kDepth / kThreads;
  using Vec = typename std::conditional<RT == 4, float4, float2>::type;
  float* As = smem;                     // [k][m]
  float* Bs = smem + kDepth * kLd;      // [k][n]
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  // the operand's unit stride runs along the lanes
  const bool a_k_unit = ak == 1, b_n_unit = bn == 1;
  float ra[kLoads], rb[kLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = tid + u * kThreads;
      const int m = m0 + (a_k_unit ? e / kDepth : e % T);
      const int k = k0 + (a_k_unit ? e % kDepth : e / T);
      ra[u] = (m < M && k < K)
                  ? (m == epi.ones_row ? 1.f
                                       : __ldcg(A + static_cast<size_t>(m) * am +
                                                static_cast<size_t>(k) * ak))
                  : 0.f;
      const int n = n0 + (b_n_unit ? e % T : e / kDepth);
      const int kb = k0 + (b_n_unit ? e / T : e % kDepth);
      rb[u] = (n < N && kb < K)
                  ? __ldcg(Bm + static_cast<size_t>(kb) * bk + static_cast<size_t>(n) * bn)
                  : 0.f;
    }
  };
  float acc[RT][RT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[i][j] = 0.f;
  if (K > 0) load(0);
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    __syncthreads();  // the previous chunk is read
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = tid + u * kThreads;
      As[(a_k_unit ? e % kDepth : e / T) * kLd + (a_k_unit ? e / kDepth : e % T)] = ra[u];
      Bs[(b_n_unit ? e / T : e % kDepth) * kLd + (b_n_unit ? e % T : e / kDepth)] = rb[u];
    }
    __syncthreads();
    if (k0 + kDepth < K) load(k0 + kDepth);
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const Vec a4 = *reinterpret_cast<const Vec*>(As + kk * kLd + RT * ty);
      const Vec b4 = *reinterpret_cast<const Vec*>(Bs + kk * kLd + RT * tx);
      const float* av = reinterpret_cast<const float*>(&a4);
      const float* bv = reinterpret_cast<const float*>(&b4);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  // the epilogue's operands (bias, or x and the pair gradient), loaded
  // together so that their L2 round trips overlap
  float e1[RT][RT], e2[RT][RT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const int m = m0 + RT * ty + i, n = n0 + RT * tx + j;
      const size_t e = static_cast<size_t>(m) * epi.ldo + n;
      e1[i][j] = e2[i][j] = 0.f;
      if (m < M && n < N) {
        if (epi.mode == kForward) {
          e1[i][j] = __ldcg(epi.bias + n);
        } else if (epi.mode != kWeightGrad) {
          e1[i][j] = __ldcg(epi.x + e);
          if (epi.mode == kLatentGrad) e2[i][j] = __ldcg(epi.gpair + e);
        }
      }
    }
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const int m = m0 + RT * ty + i, n = n0 + RT * tx + j;
      if (m < M && n < N) epilogue(epi, m, n, acc[i][j], e1[i][j], e2[i][j]);
    }
  __syncthreads();  // As and Bs are free for the next tile
}

__device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// How an M x N product is cut for the cluster's CTAs: 64-edge tiles (each
// thread 4 x 4 outputs) or 32-edge ones (2 x 2). A 64-edge tile takes about
// kWideCost 32-edge tiles' time on the card (four times the multiply-adds a
// thread, the L2 round trips the same), so it is taken where it leaves the
// CTAs fewer tiles in a row by that measure.
constexpr int kWideCostNum = 7, kWideCostDen = 4;  // kWideCost = 7 / 4
struct Cut {
  int edge, tn, tiles;
  __device__ Cut(int M, int N) {
    const int t64 = ceil_div(M, kWide) * ceil_div(N, kWide);
    const int t32 = ceil_div(M, kTile) * ceil_div(N, kTile);
    const bool wide = kWideCostNum * ceil_div(t64, kCluster) <
                      kWideCostDen * ceil_div(t32, kCluster);
    edge = wide ? kWide : kTile;
    tn = ceil_div(N, edge);
    tiles = wide ? t64 : t32;
  }
};

// Tile t of product c.
__device__ __forceinline__ void gemm(const Cut& c, int t, int M, int N, int K, const float* A,
                                     int am, int ak, const float* Bm, int bk, int bn,
                                     const Epi& epi) {
  const int m0 = (t / c.tn) * c.edge, n0 = (t % c.tn) * c.edge;
  if (c.edge == kWide)
    gemm_tile<kWide, kDepthWide>(M, N, K, A, am, ak, Bm, bk, bn, m0, n0, epi);
  else
    gemm_tile<kTile, kDepthSmall>(M, N, K, A, am, ak, Bm, bk, bn, m0, n0, epi);
}

// Layer l's outputs of the row group's rows, its tiles shared out over the
// cluster.
__device__ void forward_layer(const Args& a, const Layer& ly, bool tanh, int r0, int nr,
                              int rank) {
  const int din = ly.din, dout = ly.dout;
  const Cut c(nr, dout);
  Epi epi{};
  epi.mode = kForward;
  epi.out = a.scratch + ly.out_off + static_cast<size_t>(r0) * dout;
  epi.ldo = dout;
  epi.bias = a.params + ly.b_off;
  epi.tanh = tanh;
  epi.ones_row = -1;
  const float* X = a.scratch + ly.in_off + static_cast<size_t>(r0) * din;
  for (int t = rank; t < c.tiles; t += kCluster)
    gemm(c, t, nr, dout, din, X, din, 1, a.params + ly.w_off, dout, 1, epi);
}

// Backward through layer l for the row group: the delta of layer l - 1
// (l > 0) from the layer's weights of this step, through tanh' or, at the
// latent, plus the center and sigmoid-loss gradients; and the group's
// partial weight and bias gradients into its slot. Both read this layer's
// delta only, so their tiles are shared out over the cluster together. A
// group's deltas lie in its own rows x maxw region of each delta buffer, at
// the layer's row stride: the groups are not in step with each other.
__device__ void backward_layer(const Args& a, const Layer& ly, int l, int grp, int r0, int nr,
                               int rank) {
  const int din = ly.din, dout = ly.dout;
  const float* delta = a.scratch + a.dbuf_off[l & 1] + static_cast<size_t>(r0) * a.maxw;
  const float* X = a.scratch + ly.in_off + static_cast<size_t>(r0) * din;
  const Cut cd(nr, din), cw(din + 1, dout);
  const int td = l > 0 ? cd.tiles : 0;
  Epi ed{};
  const bool at_latent = l - 1 == a.n_enc - 1;
  ed.mode = at_latent ? kLatentGrad : kTanhGrad;
  ed.out = a.scratch + a.dbuf_off[(l + 1) & 1] + static_cast<size_t>(r0) * a.maxw;
  ed.ldo = din;
  ed.x = X;
  ed.gpair = a.scratch + a.gpair_off + static_cast<size_t>(r0) * din;
  ed.cscale = 2.f * a.center_scale / (static_cast<float>(a.B) * din);
  ed.ones_row = -1;
  Epi ew{};
  float* slot = a.scratch + a.wslot_off + static_cast<size_t>(grp) * a.n_params;
  ew.mode = kWeightGrad;
  ew.out = slot + ly.w_off;
  ew.ldo = dout;
  ew.bout = slot + ly.b_off;
  ew.ones_row = din;
  for (int t = rank; t < td + cw.tiles; t += kCluster) {
    if (t < td)
      gemm(cd, t, nr, din, dout, delta, dout, 1, a.params + ly.w_off, 1, dout, ed);
    else
      gemm(cw, t - td, din + 1, dout, nr, X, 1, din, delta, dout, 1, ew);
  }
}

// The auto loss and its gradient into the decoder output's delta, and the
// center loss, for the row group's rows (shared out over the cluster); the
// CTA's partial sums to its metric slots.
__device__ __noinline__ void local_losses(const Args& a, float* part, int r0, int nr, int rank) {
  const int d0 = a.d0, L = a.n_layers, dl = a.dl;
  const float* xb = a.scratch + a.xb_off;
  const float* dec = a.scratch + a.dec_off;
  const float* lat = a.scratch + a.lat_off;
  float* gout = a.scratch + a.dbuf_off[(L - 1) & 1] + static_cast<size_t>(r0) * a.maxw;
  const float gscale = a.auto_scale / (static_cast<float>(a.B) * d0);
  const int periodic = a.periodic;
  const float period = a.period;
  float p_auto = 0.f, p_center = 0.f;
  for (int e = rank * kThreads + threadIdx.x; e < nr * d0; e += kCluster * kThreads) {
    const int r = e / d0, b = r0 + r, k = e % d0;
    const float x = __ldcg(xb + b * d0 + k);
    if (periodic) {
      const int w = 2 * d0;
      const float sn = __ldcg(dec + b * w + k), cs = __ldcg(dec + b * w + d0 + k);
      const float norm2 = sn * sn + cs * cs;
      float out = atan2f(sn, cs);
      if (period != kTwoPi) out = out / kTwoPi * period;
      const float ad = fabsf(x - out);
      const float flip = ad <= period - ad ? 1.f : -1.f;
      p_auto += fminf(ad, period - ad);
      const float diff = out - x;
      float g = gscale * flip * (diff > 0.f ? 1.f : (diff < 0.f ? -1.f : 0.f));
      if (period != kTwoPi) g = g / kTwoPi * period;
      gout[r * w + k] = g * cs / norm2;
      gout[r * w + d0 + k] = -g * sn / norm2;
    } else {
      const float diff = x - __ldcg(dec + b * d0 + k);
      p_auto += fabsf(diff);
      gout[r * d0 + k] = -gscale * (diff > 0.f ? 1.f : (diff < 0.f ? -1.f : 0.f));
    }
  }
  for (int e = rank * kThreads + threadIdx.x; e < nr * dl; e += kCluster * kThreads) {
    const float v = __ldcg(lat + static_cast<size_t>(r0) * dl + e);
    p_center += v * v;
  }
  const float s0 = block_sum(p_auto);
  const float s1 = block_sum(p_center);
  if (threadIdx.x == 0) {
    part[0] = s0;
    part[1] = s1;
  }
}

// (I, J) of tile t in the row-major upper triangle of nt x nt tiles.
__device__ __forceinline__ void tile_of(long long t, int nt, int& I, int& J) {
  const double b = 2.0 * nt + 1.0;
  int i = static_cast<int>((b - sqrt(b * b - 8.0 * static_cast<double>(t))) * 0.5);
  auto start = [nt](long long r) { return r * nt - r * (r - 1) / 2; };
  while (i > 0 && start(i) > t) --i;
  while (i + 1 < nt && start(i + 1) <= t) ++i;
  I = i;
  J = i + static_cast<int>(t - start(i));
}

// Rows [r0, r0 + rows) of the (n, w) matrix X, columns [c0, c0 + kc), into
// dst[k * kLdP + row]; zeros past row n.
__device__ __forceinline__ void stage_rows(const float* X, int n, int w, int r0, int rows, int c0,
                                           int kc, float* dst) {
  for (int e = threadIdx.x; e < rows * kc; e += kThreads) {
    const int row = e / kc, k = e - row * kc, i = r0 + row;
    dst[k * kLdP + row] = i < n ? __ldcg(X + static_cast<size_t>(i) * w + c0 + k) : 0.f;
  }
}

// acc[4 r + c] += squared difference of staged rows 4 ty + r and 4 tx + c
// over kc columns; min-image where PERIODIC (as hand_step: no guard, the
// Euclidean sigmoid form on the squared distance).
template <bool PERIODIC>
__device__ __forceinline__ void accum_d2(const float* xi, const float* xj, int kc, int ty, int tx,
                                         float period, float (&acc)[kNP]) {
#pragma unroll 2
  for (int k = 0; k < kc; ++k) {
    const float4 p = *reinterpret_cast<const float4*>(xi + k * kLdP + 4 * ty);
    const float4 r = *reinterpret_cast<const float4*>(xj + k * kLdP + 4 * tx);
    const float ai[4] = {p.x, p.y, p.z, p.w}, bj[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = ai[i] - bj[j];
        if (PERIODIC) {
          t = fabsf(t);
          t = fminf(t, period - t);
        }
        acc[4 * i + j] = fmaf(t, t, acc[4 * i + j]);
      }
  }
}

// What a pair tile reads: passed by value to the function, which is not
// inlined, so that it has the registers to itself.
struct Pairs {
  int B, d0, dl, nt;
  const float* xb;   // (B, d0) raw rows
  const float* lat;  // (B, dl) latents
  float* ws;         // the slots
  float period;
  SideSig sh, sl;
};

// One 64 x 64 tile (I, J), J >= I, of the sketch-map pairs: returns the
// loss of its pairs (each unordered pair twice: both orders) and writes the
// slots ws[(t * dl + k) * B + row] of the latent gradient: the sum over the
// row's partners j in tile t of f_ij (l_i[k] - l_j[k]), f_ij = (s_l - s_h)
// s_l'(r)/r. Each pair's term enters row i and, negated, row j, so the
// gradient sums to zero over the batch up to the order of the sums (the
// plain version's sum_j f_ij l_i - sum_j f_ij l_j leaves a rounding residue
// that the latent bias's gradient, a sum over rows, shows). Groups of
// kVGroup components are reduced and written in turn, so that no latent
// width is too wide. On a diagonal tile row and column sums go to one slot.
template <bool PERIODIC>
__device__ __noinline__ float pair_tile(const Pairs pa, int tile) {
  const int B = pa.B, d0 = pa.d0, dl = pa.dl;
  const float* xb = pa.xb;
  const float* lat = pa.lat;
  float* ws = pa.ws;
  float* hsI = smem;
  float* hsJ = hsI + kChunk * kLdP;
  float* lsI = hsJ + kChunk * kLdP;
  float* lsJ = lsI + kChunk * kLdP;
  float* rowacc = lsJ + kChunk * kLdP;               // [k - k0][kPair]
  float* colbuf = rowacc + kVGroup * kPair;          // [k - k0][warp][kPair]
  int I, J;
  tile_of(tile, pa.nt, I, J);
  const int i0 = I * kPair, j0 = J * kPair;
  const bool diag = I == J, masked = diag || j0 + kPair > B;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool lat_staged = dl <= kChunk;
  float loss = 0.f;
  __syncthreads();  // the previous tile's buffers are read
  stage_rows(xb, B, d0, i0, kPair, 0, d0, hsI);
  stage_rows(xb, B, d0, j0, kPair, 0, d0, hsJ);
  if (lat_staged) {
    stage_rows(lat, B, dl, i0, kPair, 0, dl, lsI);
    stage_rows(lat, B, dl, j0, kPair, 0, dl, lsJ);
  }
  __syncthreads();
  {
    {
      float yh[kNP], f[kNP];  // yh: the high side's squared distances, then s_h
      unsigned keep = 0;  // bit p: the pair is counted and its latent distance is not zero
      {
        float dlv[kNP];
#pragma unroll
        for (int p = 0; p < kNP; ++p) yh[p] = dlv[p] = 0.f;
        accum_d2<PERIODIC>(hsI, hsJ, d0, ty, tx, pa.period, yh);
        if (lat_staged) {
          accum_d2<false>(lsI, lsJ, dl, ty, tx, 0.f, dlv);
        } else {  // kChunk columns at a time
          for (int c0 = 0; c0 < dl; c0 += kChunk) {
            const int kc = min(kChunk, dl - c0);
            __syncthreads();
            stage_rows(lat, B, dl, i0, kPair, c0, kc, lsI);
            stage_rows(lat, B, dl, j0, kPair, c0, kc, lsJ);
            __syncthreads();
            accum_d2<false>(lsI, lsJ, kc, ty, tx, 0.f, dlv);
          }
        }
        unsigned counted = 0;  // bit p: the pair's loss counts, twice (both orders)
#pragma unroll
        for (int p = 0; p < kNP; ++p) {
          const int i = i0 + 4 * ty + p / 4, j = j0 + 4 * tx + p % 4;
          if (!masked || (i < B && j < B && (!diag || i < j))) {
            counted |= 1u << p;
            if (dlv[p] != 0.f) keep |= 1u << p;
          }
        }
        // each side in two halves of kPart pairs, to keep registers low
        // (quarters spill less but ran 19 % slower on an H100 at B=16384):
        // s_h into yh; then f = (s_l - s_h) s_l'(r)/r, s_l'(r)/r = dscale
        // u^(e-1) [t / r^2 unless a == 2], u^(e-1) = y / u
        constexpr int kPart = kNP / 2;
#pragma unroll
        for (int q = 0; q < kNP / kPart; ++q) {
          float t[kPart], y[kPart], iu[kPart];
#pragma unroll
          for (int u = 0; u < kPart; ++u) t[u] = yh[q * kPart + u];
          sig_t<kPart, false>(pa.sh, t);
          sig_s<kPart>(pa.sh, t, y, iu);
#pragma unroll
          for (int u = 0; u < kPart; ++u) yh[q * kPart + u] = t[u];
        }
#pragma unroll
        for (int q = 0; q < kNP / kPart; ++q) {
          float t[kPart], y[kPart], iu[kPart], g[kPart];
#pragma unroll
          for (int u = 0; u < kPart; ++u) t[u] = dlv[q * kPart + u];
          sig_t<kPart, false>(pa.sl, t);
          if (pa.sl.half_a != 1) {  // t / r^2, 0 where t underflows
#pragma unroll
            for (int u = 0; u < kPart; ++u) g[u] = t[u] / dlv[q * kPart + u];
          }
          sig_s<kPart>(pa.sl, t, y, iu);
#pragma unroll
          for (int u = 0; u < kPart; ++u) {
            const int p = q * kPart + u;
            const float sdiff = t[u] - yh[p];  // s_l - s_h
            if ((counted >> p) & 1u) loss = fmaf(2.f * sdiff, sdiff, loss);
            float gq = pa.sl.dscale * y[u] * iu[u];
            if (pa.sl.half_a != 1) gq *= g[u];
            f[p] = (keep >> p) & 1u ? sdiff * gq : 0.f;
          }
        }
      }
      for (int k0 = 0; k0 < dl; k0 += kVGroup) {
        const int kn = min(kVGroup, dl - k0);
        for (int k = k0; k < k0 + kn; ++k) {
          float li[4], lj[4];
          if (lat_staged) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              li[r] = lsI[k * kLdP + 4 * ty + r];
              lj[r] = lsJ[k * kLdP + 4 * tx + r];
            }
          } else {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = i0 + 4 * ty + r, j = j0 + 4 * tx + r;
              li[r] = i < B ? __ldcg(lat + static_cast<size_t>(i) * dl + k) : 0.f;
              lj[r] = j < B ? __ldcg(lat + static_cast<size_t>(j) * dl + k) : 0.f;
            }
          }
          float pr[4] = {0.f, 0.f, 0.f, 0.f}, pc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float t = f[4 * r + c] * (li[r] - lj[c]);
              pr[r] += t;
              pc[c] -= t;
            }
          // rows: over the 16 tx lanes of the half-warp; columns: over the
          // warp's two ty, then over the warps in order below
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int off = 8; off > 0; off >>= 1) pr[r] += __shfl_xor_sync(kFull, pr[r], off);
#pragma unroll
          for (int c = 0; c < 4; ++c) pc[c] += __shfl_xor_sync(kFull, pc[c], 16);
          if (tx == 0)
#pragma unroll
            for (int r = 0; r < 4; ++r) rowacc[(k - k0) * kPair + 4 * ty + r] = pr[r];
          if (lane < 16)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              colbuf[((k - k0) * kWarps + warp) * kPair + 4 * tx + c] = pc[c];
        }
        __syncthreads();
        for (int e = threadIdx.x; e < kn * kPair; e += kThreads) {
          const int g = e / kPair, x = e - g * kPair, k = k0 + g;
          float col = colbuf[g * kWarps * kPair + x];
          for (int w = 1; w < kWarps; ++w) col += colbuf[(g * kWarps + w) * kPair + x];
          const float row = rowacc[g * kPair + x];
          const int i = i0 + x, j = j0 + x;
          if (diag) {
            if (i < B) ws[(static_cast<size_t>(I) * dl + k) * B + i] = row + col;
          } else {
            ws[(static_cast<size_t>(J) * dl + k) * B + i] = row;
            if (j < B) ws[(static_cast<size_t>(I) * dl + k) * B + j] = col;
          }
        }
        __syncthreads();  // rowacc and colbuf are read before the next group
      }
    }
  }
  return loss;
}

__device__ __forceinline__ Pairs pairs(const Args& a) {
  return Pairs{a.B, a.d0, a.dl, a.nt, a.scratch + a.xb_off, a.scratch + a.lat_off,
               a.scratch + a.slot_off, a.period, a.sh, a.sl};
}

// After the pair slots are in: the sigmoid loss's latent gradient of the
// row group's rows, (4 scale / B^2) times the sum of the row's slots in
// tile order.
__device__ __noinline__ void pair_gradients(const Args& a, int r0, int nr, int rank) {
  const int B = a.B, dl = a.dl, nt = a.nt;
  const float* ws = a.scratch + a.slot_off;
  float* gpair = a.scratch + a.gpair_off;
  const float mscale = 4.f * a.dist_scale / (static_cast<float>(B) * B);
  for (int e = rank * kThreads + threadIdx.x; e < nr * dl; e += kCluster * kThreads) {
    const int i = r0 + e / dl, k = e % dl;
    float sum = 0.f;
#pragma unroll 16
    for (int t = 0; t < nt; ++t) sum += __ldcg(ws + (static_cast<size_t>(t) * dl + k) * B + i);
    gpair[static_cast<size_t>(i) * dl + k] = mscale * sum;
  }
}

// Adam on the parameters this CTA owns (L2 gradient added to the kernels,
// clip to +-1), the gradient the sum of the G row groups' slots in group
// order; returns the thread's share of sum(W^2) over the old weights.
__device__ __noinline__ float adam(const Args& a, int s, int cta, int n_ctas) {
  const AdamStep ad = adam_step(a.step0 + s + 1);
  const float eps = 1e-7f;
  const float* wslot = a.scratch + a.wslot_off;
  float* params = a.params;
  float* mu = a.mu;
  float* nu = a.nu;
  const long long n_params = a.n_params, n_weights = a.n_weights;
  const int groups = a.groups;
  const float l2 = a.l2, lr = a.lr;
  float reg = 0.f;
  for (long long e = static_cast<long long>(cta) * kThreads + threadIdx.x; e < n_params;
       e += static_cast<long long>(n_ctas) * kThreads) {
    const float p = __ldcg(params + e);
    float g = 0.f;
#pragma unroll 8
    for (int grp = 0; grp < groups; ++grp) g += __ldcg(wslot + grp * n_params + e);
    if (e < n_weights) {
      g += 2.f * l2 * p;
      reg += p * p;
    }
    g = fminf(fmaxf(g, -1.f), 1.f);
    const float m = ad.b1 * __ldcg(mu + e) + ad.c1 * g;
    const float v = ad.b2 * __ldcg(nu + e) + ad.c2 * g * g;
    mu[e] = m;
    nu[e] = v;
    params[e] = p - lr * (m / ad.bc1) / (sqrtf(v / ad.bc2) + eps);
  }
  return reg;
}

// Block 0, after the step's last barrier: the metrics row of step s from
// every CTA's partial sums, added over the CTAs in a fixed order.
__device__ __noinline__ void write_metrics(const Args& a, int s, int n_ctas) {
  const float* part = a.scratch + a.part_off + static_cast<size_t>(s & 1) * n_ctas * kMetrics;
  float sum[kMetrics];
  for (int m = 0; m < kMetrics; ++m) {
    float v = 0.f;
    for (int c = threadIdx.x; c < n_ctas; c += kThreads) v += __ldcg(part + c * kMetrics + m);
    sum[m] = block_sum(v);
  }
  if (threadIdx.x == 0) {
    const int dl = a.dl;
    const float B = static_cast<float>(a.B);
    const float auto_loss = a.auto_scale * (sum[0] / (B * a.d0));
    const float center = a.center_scale * (sum[1] / (B * dl));
    const float reg = a.l2 * sum[2];
    const float dist = a.dist_scale * (sum[3] / (B * B));
    float* row = a.metrics + static_cast<size_t>(s) * 5;
    row[0] = auto_loss;
    row[1] = center;
    row[2] = reg;
    row[3] = dist;
    row[4] = auto_loss + center + reg + dist;
  }
}

// Phases of the optional cycle trace (Args::clocks), as thread 0 of each
// CTA sees them (ops/fused_train.py::GRID_PHASES); a wait is the time its
// CTA idles at a grid-wide barrier.
enum Phase {
  kPhGather, kPhForward, kPhLosses, kPhWaitLatents, kPhPairs, kPhWaitSlots, kPhPairGrad, kPhBackward,
  kPhWaitGrads, kPhAdam, kPhWaitUpdate
};

// The sums live in shared memory, so that the trace costs no registers.
struct Trace {
  long long* acc;
  long long t;
  bool on;
  __device__ Trace(bool enabled, long long* sums)
      : acc(sums), t(0), on(enabled && threadIdx.x == 0) {
    if (!on) return;
    for (int i = 0; i < kPhases; ++i) acc[i] = 0;
    t = clock64();
  }
  __device__ void lap(int phase) {
    if (!on) return;
    const long long now = clock64();
    acc[phase] += now - t;
    t = now;
  }
};

template <bool PERIODIC>
// The arguments are __grid_constant__: the phases, which are not inlined
// (each then has the registers to itself), read them where they lie
// instead of from a copy in each thread's local memory.
__global__ void __launch_bounds__(kThreads, 2) fused_train_kernel(const __grid_constant__ Args a) {
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cta = blockIdx.x, n_ctas = gridDim.x;
  const int grp = cta / kCluster;
  const int r0 = grp * a.rows;
  const int nr = max(0, min(a.rows, a.B - r0));
  const int n_pair = a.nt * (a.nt + 1) / 2;
  __shared__ Layer layers[kMaxLayers];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l)
      layers[l] = Layer{a.din[l], a.dout[l], a.w_off[l], a.b_off[l], a.act_off[l],
                        a.act_off[l + 1]};
  }
  __syncthreads();
  __shared__ long long trace_sums[kPhases];
  Trace tr(a.clocks != nullptr, trace_sums);
  for (int s = 0; s < a.steps; ++s) {
    float* part = a.scratch + a.part_off + (static_cast<size_t>(s & 1) * n_ctas + cta) * kMetrics;
    gather(a, s, r0, nr, rank);
    cluster_sync(cluster);
    tr.lap(kPhGather);
    for (int l = 0; l < a.n_layers; ++l) {
      forward_layer(a, layers[l], is_tanh(a, l), r0, nr, rank);
      cluster_sync(cluster);
    }
    tr.lap(kPhForward);
    local_losses(a, part, r0, nr, rank);
    tr.lap(kPhLosses);
    grid.sync();  // 1: every row's raw input and latent
    tr.lap(kPhWaitLatents);

    float loss = 0.f;
    for (int t = cta; t < n_pair; t += n_ctas) loss += pair_tile<PERIODIC>(pairs(a), t);
    const float dist = block_sum(loss);
    if (threadIdx.x == 0) part[3] = dist;
    tr.lap(kPhPairs);
    grid.sync();  // 2: every pair slot
    tr.lap(kPhWaitSlots);

    pair_gradients(a, r0, nr, rank);
    cluster_sync(cluster);
    tr.lap(kPhPairGrad);
    for (int l = a.n_layers - 1; l >= 0; --l) {
      backward_layer(a, layers[l], l, grp, r0, nr, rank);
      if (l > 0) cluster_sync(cluster);
    }
    tr.lap(kPhBackward);
    grid.sync();  // 3: every row group's partial gradients
    tr.lap(kPhWaitGrads);

    const float reg = block_sum(adam(a, s, cta, n_ctas));
    if (threadIdx.x == 0) part[2] = reg;
    tr.lap(kPhAdam);
    grid.sync();  // 4: the parameters are updated; every partial sum is in
    tr.lap(kPhWaitUpdate);
    if (cta == 0) write_metrics(a, s, n_ctas);
    tr.lap(kPhAdam);
  }
  if (tr.on)
    for (int i = 0; i < kPhases; ++i) a.clocks[cta * kPhases + i] = trace_sums[i];
}

// The plan ops/fused_train.py::grid_plan makes: row groups, rows per group,
// the three tile constants it assumed, then the scratch items' sizes in
// floats, in the order they lie in scratch.
enum Plan { kPlanGroups, kPlanRows, kPlanCluster, kPlanTile, kPlanPair, kPlanBatch,
            kPlanActs, kPlanDeltas, kPlanPairGrad, kPlanSlots, kPlanParts, kPlanGradSlots };

// Fill the layer table, and the scratch offsets from the plan's sizes;
// false if the plan does not fit this source's tiles or the batch.
bool layout(Args& a, int n_enc, int n_dec, const int* dims, int B, int d0,
            const long long* plan) {
  const int L = n_enc + n_dec;
  a.n_enc = n_enc;
  a.n_layers = L;
  a.B = B;
  a.d0 = d0;
  a.groups = static_cast<int>(plan[kPlanGroups]);
  a.rows = static_cast<int>(plan[kPlanRows]);
  if (plan[kPlanCluster] != kCluster || plan[kPlanTile] != kTile || plan[kPlanPair] != kPair ||
      a.groups < 1 || a.rows % kTile != 0 || static_cast<long long>(a.groups) * a.rows < B ||
      static_cast<long long>(a.groups - 1) * a.rows >= B)
    return false;
  a.maxw = 0;
  for (int l = 0; l <= L; ++l) a.maxw = dims[l] > a.maxw ? dims[l] : a.maxw;
  a.nt = (B + kPair - 1) / kPair;
  long long off = 0;
  for (int l = 0; l < L; ++l) {
    a.din[l] = dims[l];
    a.dout[l] = dims[l + 1];
    a.w_off[l] = off;
    off += static_cast<long long>(dims[l]) * dims[l + 1];
  }
  a.n_weights = off;
  for (int l = 0; l < L; ++l) {
    a.b_off[l] = off;
    off += dims[l + 1];
  }
  a.n_params = off;
  // the raw rows (B, d0); every layer's input and output (B, dims[l]) one
  // after another; two delta regions of rows x maxw per row group; the
  // latent gradient (B, dl); the pair slots (nt, dl, B); the metric
  // partials; the weight-gradient slots (groups, n_params)
  a.xb_off = 0;
  a.act_off[0] = plan[kPlanBatch];
  for (int l = 0; l < L; ++l) a.act_off[l + 1] = a.act_off[l] + static_cast<long long>(B) * dims[l];
  long long s = a.act_off[0] + plan[kPlanActs];
  a.dl = dims[n_enc];
  a.lat_off = a.act_off[n_enc];
  a.dec_off = a.act_off[L];
  a.dbuf_off[0] = s;
  a.dbuf_off[1] = s + plan[kPlanDeltas] / 2;
  s += plan[kPlanDeltas];
  a.gpair_off = s;
  s += plan[kPlanPairGrad];
  a.slot_off = s;
  s += plan[kPlanSlots];
  a.part_off = s;
  s += plan[kPlanParts];
  a.wslot_off = s;
  return true;
}

using Kernel = void (*)(Args);

// The launch configuration of `groups` clusters (0: one, to ask the
// occupancy calculator) and the kernel, its attributes set.
cudaError_t configure(bool periodic, int groups, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr, Kernel* kernel) {
  *kernel = periodic ? fused_train_kernel<true> : fused_train_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemFloats * 4);
  if (err != cudaSuccess) return err;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  *cfg = {};
  cfg->gridDim = dim3(kCluster * (groups > 0 ? groups : 1));
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = kSmemFloats * 4;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 2;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Clusters of the kernel the card holds at once (the row groups' most).
int em_fused_train_max_clusters(int periodic, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  Kernel kernel;
  cudaError_t err = configure(periodic != 0, 0, nullptr, &cfg, attr, &kernel);
  if (err != cudaSuccess) return err;
  cfg.numAttrs = 1;  // the calculator takes the cluster dimension only
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

// Run `steps` optimizer steps as `plan` (Plan above) cuts them; params, mu
// and nu are updated in place, scratch holds the plan's scratch floats.
// hyper = [auto, center, l2, dist scales, sig_h, a_h, b_h, sig_l, a_l, b_l,
// periodicity (inf: none), learning rate]. clocks, if not null, receives
// (groups * kCluster, 11) int64 cycle counts per phase (Phase above),
// summed over the steps.
int em_fused_train(float* params, float* mu, float* nu, const float* data,
                   const long long* idx, int steps, int B, int d0, int n_enc,
                   int n_dec, const int* dims, double step0, const double* hyper,
                   float* metrics, float* scratch, const long long* plan,
                   long long* clocks, void* stream) {
  if (n_enc + n_dec > kMaxLayers || d0 > kMaxInput) return cudaErrorInvalidValue;
  Args a{};
  if (!layout(a, n_enc, n_dec, dims, B, d0, plan)) return cudaErrorInvalidValue;
  a.params = params;
  a.mu = mu;
  a.nu = nu;
  a.data = data;
  a.idx = idx;
  a.metrics = metrics;
  a.scratch = scratch;
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

  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  Kernel kernel;
  cudaError_t err = configure(a.periodic != 0, a.groups, static_cast<cudaStream_t>(stream), &cfg,
                              attr, &kernel);
  if (err != cudaSuccess) return err;
  // a cooperative launch of more clusters than the card holds is refused
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
