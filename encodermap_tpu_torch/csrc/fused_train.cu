// encodermap_tpu_torch/csrc/fused_train.cu
//
// A chunk of EncoderMap optimizer steps in one launch, for Hopper (sm_90a).
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
// What bounds it: at the main path's size ([128,128,2], B=256) a step is
// ~52 MFLOP of float32 products, about a microsecond of the card's f32 rate,
// while parameters and both Adam moments (~415 KB) and the activations the
// backward pass needs (~0.5 MB) outgrow one block's 227 KB of shared memory.
// The TPU kept all of it in VMEM across a sequential grid; Hopper cannot.
//
// Design (the simple one, to be made fast later): one persistent
// cooperative launch per chunk. The blocks loop over the steps together and
// split each phase's work grid-wide; cg::this_grid().sync() separates the
// phases (one per layer forward, one for the losses, one per layer backward,
// one for Adam). Parameters, moments, gradients and activations live in
// global scratch the wrapper allocates, small enough to stay in the 50 MB L2.
// So the kernel is bound by the grid barriers and L2 latency, not by the
// arithmetic: a thread-block cluster with distributed shared memory, or a
// single-SM design, is the redesign that would remove the barriers.
// Sums that feed the metrics are taken per block and added by block 0 in a
// fixed order, so a chunk is deterministic.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 16;  // encoder + decoder layers
constexpr int kMaxBlocks = 1024;
constexpr int kLatGroup = 8;    // latent components accumulated per pass
constexpr int kMetrics = 4;     // per-block partial sums: auto, center, reg, dist
constexpr float kTwoPi = 6.28318530717958647692f;

struct Args {
  // flat parameters, Adam moments: [W_0 .. W_{L-1}, b_0 .. b_{L-1}], W (din, dout)
  float* params;
  float* mu;
  float* nu;
  const float* data;      // (n_data, d0)
  const long long* idx;   // (steps, B)
  float* metrics;         // (steps, 5)
  float* scratch;
  int steps, B, d0, n_enc, n_layers;
  int din[kMaxLayers], dout[kMaxLayers];
  long long w_off[kMaxLayers], b_off[kMaxLayers];
  long long act_off[kMaxLayers + 1];  // act 0: encoder input, act l+1: output of layer l
  long long n_weights, n_params;
  // scratch offsets
  long long dbuf_off[2], xb_off, pair_off, part_off, grad_off;
  int periodic;
  float period;
  float auto_scale, center_scale, l2, dist_scale, lr;
  double step0;
  Sig sh, sl;
};

__device__ __forceinline__ bool is_tanh(const Args& a, int l) {
  return l != a.n_enc - 1 && l != a.n_layers - 1;
}

// Gather step s's batch: raw rows to xb (B, d0) and the encoder input
// (sin/cos folded if periodic) to act 0.
__device__ void gather(const Args& a, int s, int tid, int nth) {
  float* xb = a.scratch + a.xb_off;
  float* x0 = a.scratch + a.act_off[0];
  const long long* ix = a.idx + static_cast<size_t>(s) * a.B;
  for (int e = tid; e < a.B * a.d0; e += nth) {
    const int b = e / a.d0, k = e % a.d0;
    const float x = a.data[static_cast<size_t>(ix[b]) * a.d0 + k];
    xb[e] = x;
    if (a.periodic) {
      const float xs = a.period == kTwoPi ? x : x / a.period * kTwoPi;
      x0[b * 2 * a.d0 + k] = sinf(xs);
      x0[b * 2 * a.d0 + a.d0 + k] = cosf(xs);
    } else {
      x0[e] = x;
    }
  }
}

__device__ void forward_layer(const Args& a, int l, int tid, int nth) {
  const int din = a.din[l], dout = a.dout[l];
  const float* W = a.params + a.w_off[l];
  const float* bias = a.params + a.b_off[l];
  const float* in = a.scratch + a.act_off[l];
  float* out = a.scratch + a.act_off[l + 1];
  const bool act = is_tanh(a, l);
  for (int e = tid; e < a.B * dout; e += nth) {
    const int b = e / dout, o = e % dout;
    const float* row = in + static_cast<size_t>(b) * din;
    float acc = 0.f;
    for (int k = 0; k < din; ++k) acc += row[k] * W[static_cast<size_t>(k) * dout + o];
    acc += bias[o];
    out[e] = act ? tanhf(acc) : acc;
  }
}

// Sum over the block in a fixed order; every thread gets the total.
__device__ float block_sum(float v, float* red) {
  __syncthreads();
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

// Losses, the output gradient (to the delta buffer of the last layer), the
// sigmoid loss's latent gradient (to the pair buffer), and the block's
// partial sums of the four metrics.
__device__ void loss_phase(const Args& a, int tid, int nth, float* red) {
  const int B = a.B, d0 = a.d0, L = a.n_layers;
  const int dl = a.dout[a.n_enc - 1];
  const float* xb = a.scratch + a.xb_off;
  const float* lat = a.scratch + a.act_off[a.n_enc];
  const float* dec = a.scratch + a.act_off[L];
  float* gout = a.scratch + a.dbuf_off[(L - 1) & 1];
  float* pair = a.scratch + a.pair_off;
  float p_auto = 0.f, p_center = 0.f, p_reg = 0.f, p_dist = 0.f;

  // sketch-map sigmoid: one warp per row i, lanes over j
  const int lane = threadIdx.x % 32;
  const int gwarp = tid / 32, nwarps = nth / 32;
  const float mscale = 4.f * a.dist_scale / (static_cast<float>(B) * B);
  for (int i = gwarp; i < B; i += nwarps) {
    for (int k0 = 0; k0 < dl; k0 += kLatGroup) {
      const int kg = min(kLatGroup, dl - k0);
      float rowsum = 0.f, sq = 0.f, ml[kLatGroup];
#pragma unroll
      for (int k = 0; k < kLatGroup; ++k) ml[k] = 0.f;
      for (int j = lane; j < B; j += 32) {
        float dh2 = 0.f;
        for (int k = 0; k < d0; ++k) {
          float d = xb[i * d0 + k] - xb[j * d0 + k];
          if (a.periodic) {
            d = fabsf(d);
            d = fminf(d, a.period - d);
          }
          dh2 += d * d;
        }
        float dl2 = 0.f;
        for (int k = 0; k < dl; ++k) {
          const float d = lat[i * dl + k] - lat[j * dl + k];
          dl2 += d * d;
        }
        const float rl = sqrt_guard(dl2);
        const float sdiff = sig_value(rl, a.sl) - sig_value(sqrt_guard(dh2), a.sh);
        sq += sdiff * sdiff;
        const float m = sdiff * dsig_over_r(dl2, rl, a.sl);
        rowsum += m;
#pragma unroll
        for (int k = 0; k < kLatGroup; ++k)
          if (k < kg) ml[k] += m * lat[j * dl + k0 + k];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        rowsum += __shfl_down_sync(0xffffffffu, rowsum, off);
        sq += __shfl_down_sync(0xffffffffu, sq, off);
#pragma unroll
        for (int k = 0; k < kLatGroup; ++k) ml[k] += __shfl_down_sync(0xffffffffu, ml[k], off);
      }
      if (lane == 0) {
        if (k0 == 0) p_dist += sq;
        for (int k = 0; k < kg; ++k)
          pair[i * dl + k0 + k] = mscale * (rowsum * lat[i * dl + k0 + k] - ml[k]);
      }
    }
  }

  // auto loss and its gradient into the decoder output
  const float gscale = a.auto_scale / (static_cast<float>(B) * d0);
  for (int e = tid; e < B * d0; e += nth) {
    const int b = e / d0, k = e % d0;
    const float x = xb[e];
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
  for (int e = tid; e < B * dl; e += nth) p_center += lat[e] * lat[e];
  for (long long e = tid; e < a.n_weights; e += nth) p_reg += a.params[e] * a.params[e];

  float* part = a.scratch + a.part_off + static_cast<size_t>(blockIdx.x) * kMetrics;
  const float s0 = block_sum(p_auto, red);
  const float s1 = block_sum(p_center, red);
  const float s2 = block_sum(p_reg, red);
  const float s3 = block_sum(p_dist, red);
  if (threadIdx.x == 0) {
    part[0] = s0;
    part[1] = s1;
    part[2] = s2;
    part[3] = s3;
  }
}

// Backward through layer l: its weight and bias gradients, and (l > 0) the
// delta of layer l - 1, through tanh' or, at the latent, plus the center and
// sigmoid-loss gradients.
__device__ void backward_layer(const Args& a, int l, int tid, int nth) {
  const int B = a.B, din = a.din[l], dout = a.dout[l];
  const float* W = a.params + a.w_off[l];
  const float* in = a.scratch + a.act_off[l];
  const float* delta = a.scratch + a.dbuf_off[l & 1];
  float* prev = a.scratch + a.dbuf_off[(l + 1) & 1];
  float* grads = a.scratch + a.grad_off;
  const int n_w = din * dout;
  const int n_all = n_w + dout + (l > 0 ? B * din : 0);
  const bool at_latent = l - 1 == a.n_enc - 1;
  const float cscale = 2.f * a.center_scale / (static_cast<float>(B) * din);
  const float* pair = a.scratch + a.pair_off;
  for (int e = tid; e < n_all; e += nth) {
    if (e < n_w) {
      const int k = e / dout, o = e % dout;
      float acc = 0.f;
      for (int b = 0; b < B; ++b)
        acc += in[static_cast<size_t>(b) * din + k] * delta[static_cast<size_t>(b) * dout + o];
      grads[a.w_off[l] + e] = acc;
    } else if (e < n_w + dout) {
      const int o = e - n_w;
      float acc = 0.f;
      for (int b = 0; b < B; ++b) acc += delta[static_cast<size_t>(b) * dout + o];
      grads[a.b_off[l] + o] = acc;
    } else {
      const int f = e - n_w - dout, b = f / din, k = f % din;
      const float* drow = delta + static_cast<size_t>(b) * dout;
      const float* wrow = W + static_cast<size_t>(k) * dout;
      float acc = 0.f;
      for (int o = 0; o < dout; ++o) acc += drow[o] * wrow[o];
      const float x = in[f];
      if (at_latent) {
        acc += cscale * x + pair[f];
      } else {
        acc *= 1.f - x * x;
      }
      prev[f] = acc;
    }
  }
}

// Adam on every parameter (L2 gradient added to the kernels, clip to +-1),
// block 0 writes the metrics row, and the next step's batch is gathered.
__device__ void adam_phase(const Args& a, int s, int tid, int nth) {
  const float t = static_cast<float>(a.step0 + s + 1);
  const float b1 = 0.9f, b2 = 0.999f, eps = 1e-7f;
  const float bc1 = 1.f - powf(b1, t), bc2 = 1.f - powf(b2, t);
  const float* grads = a.scratch + a.grad_off;
  for (long long e = tid; e < a.n_params; e += nth) {
    const float p = a.params[e];
    float g = grads[e];
    if (e < a.n_weights) g += 2.f * a.l2 * p;
    g = fminf(fmaxf(g, -1.f), 1.f);
    const float m = b1 * a.mu[e] + (1.f - b1) * g;
    const float v = b2 * a.nu[e] + (1.f - b2) * g * g;
    a.mu[e] = m;
    a.nu[e] = v;
    a.params[e] = p - a.lr * (m / bc1) / (sqrtf(v / bc2) + eps);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const float* part = a.scratch + a.part_off;
    float sum[kMetrics] = {0.f, 0.f, 0.f, 0.f};
    for (int blk = 0; blk < gridDim.x; ++blk)
      for (int m = 0; m < kMetrics; ++m) sum[m] += part[blk * kMetrics + m];
    const int dl = a.dout[a.n_enc - 1];
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
  if (s + 1 < a.steps) gather(a, s + 1, tid, nth);
}

__global__ void __launch_bounds__(kThreads) fused_train_kernel(Args a) {
  __shared__ float red[kThreads];
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nth = gridDim.x * blockDim.x;
  gather(a, 0, tid, nth);
  grid.sync();
  for (int s = 0; s < a.steps; ++s) {
    for (int l = 0; l < a.n_layers; ++l) {
      forward_layer(a, l, tid, nth);
      grid.sync();
    }
    loss_phase(a, tid, nth, red);
    grid.sync();
    for (int l = a.n_layers - 1; l >= 0; --l) {
      backward_layer(a, l, tid, nth);
      grid.sync();
    }
    adam_phase(a, s, tid, nth);
    grid.sync();
  }
}

// Fill the layer table and scratch layout; returns the scratch size in floats.
long long layout(Args& a, int n_enc, int n_dec, const int* dims, int B, int d0) {
  const int L = n_enc + n_dec;
  a.n_enc = n_enc;
  a.n_layers = L;
  a.B = B;
  a.d0 = d0;
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
  long long s = 0;
  int maxw = 0;
  for (int l = 0; l <= L; ++l) {
    a.act_off[l] = s;
    s += static_cast<long long>(B) * dims[l];
    maxw = dims[l] > maxw ? dims[l] : maxw;
  }
  a.dbuf_off[0] = s;
  s += static_cast<long long>(B) * maxw;
  a.dbuf_off[1] = s;
  s += static_cast<long long>(B) * maxw;
  a.xb_off = s;
  s += static_cast<long long>(B) * d0;
  a.pair_off = s;
  s += static_cast<long long>(B) * dims[n_enc];
  a.part_off = s;
  s += static_cast<long long>(kMaxBlocks) * kMetrics;
  a.grad_off = s;
  s += a.n_params;
  return s;
}

}  // namespace

extern "C" {

// Scratch floats a chunk needs; dims = [d_in, widths of the L layers].
long long em_fused_train_workspace(int n_enc, int n_dec, const int* dims, int B, int d0) {
  if (n_enc + n_dec > kMaxLayers) return -1;
  Args a;
  return layout(a, n_enc, n_dec, dims, B, d0);
}

// Run `steps` optimizer steps; params, mu and nu are updated in place.
// hyper = [auto, center, l2, dist scales, sig_h, a_h, b_h, sig_l, a_l, b_l,
//          periodicity (inf: none), learning rate].
int em_fused_train(float* params, float* mu, float* nu, const float* data,
                   const long long* idx, int steps, int B, int d0, int n_enc,
                   int n_dec, const int* dims, double step0, const double* hyper,
                   float* metrics, float* scratch, void* stream) {
  if (n_enc + n_dec > kMaxLayers) return cudaErrorInvalidValue;
  Args a;
  layout(a, n_enc, n_dec, dims, B, d0);
  a.params = params;
  a.mu = mu;
  a.nu = nu;
  a.data = data;
  a.idx = idx;
  a.metrics = metrics;
  a.scratch = scratch;
  a.steps = steps;
  a.step0 = step0;
  a.auto_scale = static_cast<float>(hyper[0]);
  a.center_scale = static_cast<float>(hyper[1]);
  a.l2 = static_cast<float>(hyper[2]);
  a.dist_scale = static_cast<float>(hyper[3]);
  a.sh = make_sig(hyper[4], hyper[5], hyper[6]);
  a.sl = make_sig(hyper[7], hyper[8], hyper[9]);
  a.periodic = std::isfinite(hyper[10]) ? 1 : 0;
  a.period = static_cast<float>(a.periodic ? hyper[10] : 0.0);
  a.lr = static_cast<float>(hyper[11]);

  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_train_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  int blocks = per_sm < 1 ? 0 : sms;  // one block per SM: fewer blocks, cheaper barriers
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks == 0) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_train_kernel), blocks,
                                    kThreads, args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
