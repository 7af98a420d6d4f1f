// encodermap_tpu_torch/csrc/sigmoid_loss.cu
//
// The sketch-map sigmoid loss over all pairs of a batch and its latent
// gradient, for Hopper (sm_90a).
//
//   loss     = mean_{i,j} (s_h(D_h[i,j]) - s_l(D_l[i,j]))^2
//   dloss/dl = (4/B^2) sum_j (s_l - s_h)[i,j] s_l'(D_l)/D_l (l_i - l_j)
//
// Replaces the TPU kernels encodermap_tpu/ops/pallas_sigmoid.py::_fwd_kernel
// (forward) and ::_bwd_kernel (backward), which walked (256, 512) tiles of
// the full pair matrix in a sequential grid and carried the sums in SMEM.
//
// What bounds them here: operations, not bytes. The inputs are O(B (D + d))
// bytes and the work O(B^2): per pair the component differences on the FP32
// pipe and the two sigmoids, whose powers go to the MUFU unit (16 results per
// clock per SM against 128 FP32 lanes). What the design does about it:
//
// * Each unordered pair once. D_h, D_l and so every pair term are symmetric
//   bit for bit, so a block takes one T x T tile (I, J), J >= I, of the
//   upper triangle (T = 128 where B gives over two waves of tiles, else 64;
//   the backward takes 64 for a latent over 32 wide), from a linear index
//   over the nt (nt + 1) / 2 tiles. An off-diagonal tile counts each
//   pair for (i, j) and (j, i); a diagonal tile evaluates i <= j.
// * Register tiles. 256 threads as 16 x 16, each owning 4 x 4 pairs of a
//   64 x 64 pass (a tile is (T/64)^2 passes). A tile stages its T I rows
//   and T J rows into shared memory column-major once (h where D <= 32, l
//   where d <= 32; a wider side a pass's 64 rows 32 columns at a time), and
//   each thread reads its 4 i values and 4 j values of a column as two
//   float4 loads for 16 pair updates.
// * Cheap powers (sigmoid_pairs.cuh): exponents are classified on the host,
//   so the defaults take one rsqrtf and two reciprocals a pair, no powf; each
//   side's s = 1 - u^e comes without the cancellation of 1 - u^e near u = 1
//   (sig_s), so a small s keeps a few ulp of relative accuracy.
// * Forward: each tile writes one partial; a one-block pass adds them in
//   double in a fixed order. Backward: each tile reduces its pair terms f_ij
//   into row partials of its I rows (sum_j f_ij and sum_j f_ij l_j) and
//   column partials of its J rows (sum_i f_ij, sum_i f_ij l_i), all d latent
//   components from one pair pass, and writes them to a workspace slot
//   (row, partner tile); a second kernel adds each row's slots in tile
//   order. A 128-wide tile holds its d + 1 row and column sums in shared
//   memory over its four passes; a 64-wide tile (one pass) writes each
//   group of 4 sums as soon as it is reduced, so shared memory bounds no
//   latent width. Every sum has a fixed order, so two runs give the same
//   bits. No float atomics.
//
// Guards, as the reference: a Euclidean D^2 = 0 gives s = 0; periodic
// components that are exactly zero become 1e-12, and 1e-12 is added after
// the sqrt; pairs at zero latent distance contribute no gradient. Ragged
// edges (B not a multiple of T) are masked here. Any B, D and d; f32 in,
// f32 out.
#include "common.cuh"
#include "sigmoid_pairs.cuh"

namespace {

constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kWarps = kThreads / 32;
constexpr int kPass = 64;        // rows (and columns) of pairs in a pass
constexpr int kChunk = 32;       // feature columns staged at once
constexpr int kNP = 16;          // pairs per thread and pass (4 x 4)
constexpr int kHalf = kNP / 2;   // pairs whose sigmoids are taken at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int kVGroup = 4;       // column sums passed between warps at once
constexpr int kSumRows = 32;     // rows per block of the slot sum
constexpr int kSumParts = kThreads / kSumRows;
// Tiles of edge 128 from this many on (two blocks on each of 132 SMs, twice
// over), else 64
constexpr long long kTiles128 = 2 * 2 * 132;

// Floats of dynamic shared memory of a tile kernel (the host sizes the
// launch with the same function): the staged rows of both sides, then the
// forward's reduction buffer or the backward's column buffer and its row
// (and, at T = 128, column) sums.
__host__ __device__ inline int smem_floats(bool bwd, int T, int D, int d) {
  const int kc = D < kChunk ? D : kChunk, dc = d < kChunk ? d : kChunk;
  const int staged = 2 * (kc + dc) * (T + 4);
  const int sums = T == kPass ? kVGroup * T : 2 * (d + 1) * T;
  return staged + (bwd ? kWarps * kVGroup * kPass + sums : kThreads);
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
// dst[k * ld + row]; zeros past row n.
__device__ __forceinline__ void stage(const float* __restrict__ X, int n, int w, int r0,
                                      int rows, int c0, int kc, float* dst, int ld) {
  for (int e = threadIdx.x; e < rows * kc; e += kThreads) {
    const int row = e / kc, k = e - row * kc, i = r0 + row;
    dst[k * ld + row] = i < n ? X[static_cast<size_t>(i) * w + c0 + k] : 0.f;
  }
}

// acc[4 r + c] += squared difference of staged rows 4 ty + r and 4 tx + c
// over kc columns; periodic: min-image with the 1e-12 guard on exact zeros.
template <bool PERIODIC>
__device__ __forceinline__ void accum_d2(const float* xi, const float* xj, int ld, int kc,
                                         int ty, int tx, float period, float (&acc)[kNP]) {
#pragma unroll 2
  for (int k = 0; k < kc; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(xi + k * ld + 4 * ty);
    const float4 b = *reinterpret_cast<const float4*>(xj + k * ld + 4 * tx);
    const float ai[4] = {a.x, a.y, a.z, a.w}, bj[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float t = ai[r] - bj[c];
        if (PERIODIC) {
          t = fabsf(t);
          t = fminf(t, period - t);
          if (t == 0.f) t = 1e-12f;
        }
        acc[4 * r + c] = fmaf(t, t, acc[4 * r + c]);
      }
    }
  }
}

// Stages the tile's h rows and l rows, each where its width fits one
// chunk, into shared memory (row stride ld = T + 4), once per tile.
__device__ __forceinline__ void stage_tile(const float* __restrict__ h,
                                           const float* __restrict__ l, int n, int D, int d,
                                           int T, int iT, int jT, float* hsI, float* hsJ,
                                           float* lsI, float* lsJ) {
  const int ld = T + 4;
  if (d <= kChunk) {
    stage(l, n, d, iT, T, 0, d, lsI, ld);
    stage(l, n, d, jT, T, 0, d, lsJ, ld);
  }
  if (D <= kChunk) {
    stage(h, n, D, iT, T, 0, D, hsI, ld);
    stage(h, n, D, jT, T, 0, D, hsJ, ld);
  }
  __syncthreads();
}

// acc += the squared distances over the W columns of X of the pass's rows
// i0.. and j0.., at sI and sJ in the staged tile: from the tile's staging
// where W fits one chunk, else restaged there kChunk columns at a time (the
// pass's 64 rows only).
template <bool PERIODIC>
__device__ __forceinline__ void side_d2(const float* __restrict__ X, int n, int W, int ld,
                                        int i0, int j0, float period, float* sI, float* sJ,
                                        float (&acc)[kNP]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  if (W <= kChunk) {
    accum_d2<PERIODIC>(sI, sJ, ld, W, ty, tx, period, acc);
    return;
  }
  for (int c0 = 0; c0 < W; c0 += kChunk) {
    const int kc = min(kChunk, W - c0);
    __syncthreads();  // the previous chunk's or pass's reads are done
    stage(X, n, W, i0, kPass, c0, kc, sI, ld);
    stage(X, n, W, j0, kPass, c0, kc, sJ, ld);
    __syncthreads();
    accum_d2<PERIODIC>(sI, sJ, ld, kc, ty, tx, period, acc);
  }
}

// The pass's squared distances, the pass's rows at offsets oi, oj of the
// staged tile.
template <bool PERIODIC>
__device__ __forceinline__ void pass_d2(const float* __restrict__ h,
                                        const float* __restrict__ l, int n, int D, int d,
                                        int ld, int i0, int j0, int oi, int oj, float period,
                                        float* hsI, float* hsJ, float* lsI, float* lsJ,
                                        float (&dh)[kNP], float (&dl)[kNP]) {
#pragma unroll
  for (int p = 0; p < kNP; ++p) dh[p] = dl[p] = 0.f;
  side_d2<PERIODIC>(h, n, D, ld, i0, j0, period, hsI + oi, hsJ + oj, dh);
  side_d2<false>(l, n, d, ld, i0, j0, 0.f, lsI + oi, lsJ + oj, dl);
}

// Sum over the block in a fixed order (tree in shared memory).
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

template <int P, bool PERIODIC>
__global__ void __launch_bounds__(kThreads, 2)
sigmoid_fwd_kernel(const float* __restrict__ h, const float* __restrict__ l, int n, int D,
                   int d, SideSig sh, SideSig sl, float period, float* __restrict__ partials) {
  constexpr int T = P * kPass;
  extern __shared__ float4 smem4[];
  float* hsI = reinterpret_cast<float*>(smem4);
  constexpr int ld = T + 4;
  const int kc = min(D, kChunk), dc = min(d, kChunk);
  float* hsJ = hsI + kc * ld;
  float* lsI = hsJ + kc * ld;
  float* lsJ = lsI + dc * ld;
  float* red = lsJ + dc * ld;
  int I, J;
  tile_of(blockIdx.x, (n + T - 1) / T, I, J);
  const bool diag = I == J, masked = diag || (J + 1) * T > n;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  stage_tile(h, l, n, D, d, T, I * T, J * T, hsI, hsJ, lsI, lsJ);
  float acc = 0.f;
#pragma unroll 1
  for (int pi = 0; pi < P; ++pi) {
#pragma unroll 1
    for (int pj = diag ? pi : 0; pj < P; ++pj) {
      const int i0 = I * T + pi * kPass, j0 = J * T + pj * kPass;
      if (i0 >= n || j0 >= n) continue;
      float dh[kNP], dl[kNP];
      pass_d2<PERIODIC>(h, l, n, D, d, ld, i0, j0, pi * kPass, pj * kPass, period, hsI,
                        hsJ, lsI, lsJ, dh, dl);
      // s_h - s_l in two halves of kHalf pairs, to keep registers low
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float th[kHalf], tl[kHalf], y[kHalf], iu[kHalf];
#pragma unroll
        for (int q = 0; q < kHalf; ++q) {
          th[q] = dh[half * kHalf + q];
          tl[q] = dl[half * kHalf + q];
        }
        sig_t<kHalf, PERIODIC>(sh, th);
        sig_s<kHalf>(sh, th, y, iu);
        sig_t<kHalf, false>(sl, tl);
        sig_s<kHalf>(sl, tl, y, iu);
        if (masked) {
#pragma unroll
          for (int q = 0; q < kHalf; ++q) {
            const int p = half * kHalf + q;
            const int i = i0 + 4 * ty + p / 4, j = j0 + 4 * tx + p % 4;
            const float w =
                (i < n && j < n) ? (!diag || i < j ? 2.f : (i == j ? 1.f : 0.f)) : 0.f;
            const float diff = th[q] - tl[q];  // s_h - s_l
            acc = fmaf(w * diff, diff, acc);
          }
        } else {
#pragma unroll
          for (int q = 0; q < kHalf; ++q) {
            const float diff = th[q] - tl[q];
            acc = fmaf(diff, diff, acc);
          }
        }
      }
    }
  }
  const float total = block_sum(acc, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = masked ? total : 2.f * total;
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

// Slot v of staged row x of tile (I, J), T wide, from the row's sum over
// the J rows and the column's sum over the I rows: on a diagonal tile both
// go to row I T + x's slot I; else the row sum to row I T + x's slot J and
// the column sum to row J T + x's slot I.
__device__ __forceinline__ void put_slot(float* __restrict__ ws, int n, int nv, int T, int I,
                                         int J, int v, int x, float row, float col) {
  const int i = I * T + x, j = J * T + x;
  if (I == J) {
    if (i < n) ws[(static_cast<size_t>(I) * nv + v) * n + i] = row + col;
  } else {
    ws[(static_cast<size_t>(J) * nv + v) * n + i] = row;
    if (j < n) ws[(static_cast<size_t>(I) * nv + v) * n + j] = col;
  }
}

// Backward, one tile: pair terms f_ij once, then its slots of the workspace
// ws[(t * (d + 1) + v) * n + row]: v = 0 the sum of f over the row's partners
// in tile t, v = k + 1 the sum of f times the partner's l[k].
template <int P, bool PERIODIC>
__global__ void __launch_bounds__(kThreads, 2)
sigmoid_bwd_kernel(const float* __restrict__ h, const float* __restrict__ l, int n, int D,
                   int d, SideSig sh, SideSig sl, float period, float* __restrict__ ws) {
  constexpr int T = P * kPass;
  extern __shared__ float4 smem4[];
  float* hsI = reinterpret_cast<float*>(smem4);
  constexpr int ld = T + 4;
  const int kc = min(D, kChunk), dc = min(d, kChunk), nv = d + 1;
  float* hsJ = hsI + kc * ld;
  float* lsI = hsJ + kc * ld;
  float* lsJ = lsI + dc * ld;
  float* colbuf = lsJ + dc * ld;          // [warp][v - v0][kPass]
  // row sums [v - vb][T]: at T = 64 (one pass) a group of kVGroup, whose
  // slots are written as soon as it is reduced (vb = v0); at T = 128 all
  // d + 1 over the tile's passes (vb = 0), and then the column sums [v][T]
  float* rowacc = colbuf + kWarps * kVGroup * kPass;
  float* colacc = rowacc + nv * T;
  for (int e = threadIdx.x; e < (P == 1 ? kVGroup : 2 * nv) * T; e += kThreads)
    rowacc[e] = 0.f;
  const int nt = (n + T - 1) / T;
  int I, J;
  tile_of(blockIdx.x, nt, I, J);
  const bool diag = I == J, masked = diag || (J + 1) * T > n;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool b2 = tx & 4, b3 = tx & 8, b4 = lane & 16;
  stage_tile(h, l, n, D, d, T, I * T, J * T, hsI, hsJ, lsI, lsJ);
#pragma unroll 1
  for (int pi = 0; pi < P; ++pi) {
#pragma unroll 1
    for (int pj = diag ? pi : 0; pj < P; ++pj) {
      const int i0 = I * T + pi * kPass, j0 = J * T + pj * kPass;
      if (i0 >= n || j0 >= n) continue;
      float yh[kNP], f[kNP];
      unsigned keep = 0;  // bit p: the pair is counted and its latent distance is not zero
      {
        float dl[kNP];
        pass_d2<PERIODIC>(h, l, n, D, d, ld, i0, j0, pi * kPass, pj * kPass, period, hsI,
                          hsJ, lsI, lsJ, yh, dl);
        if (masked) {
#pragma unroll
          for (int p = 0; p < kNP; ++p) {
            const int i = i0 + 4 * ty + p / 4, j = j0 + 4 * tx + p % 4;
            if (i < n && j < n && (!diag || i < j) && dl[p] != 0.f) keep |= 1u << p;
          }
        } else {
#pragma unroll
          for (int p = 0; p < kNP; ++p)
            if (dl[p] != 0.f) keep |= 1u << p;
        }
        // each side in two halves of kHalf pairs, to keep registers low:
        // s_h into yh; then f = (s_l - s_h) s_l'(r)/r, s_l'(r)/r = dscale
        // u^(e-1) [t / r^2 unless a == 2], u^(e-1) = y / u
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float t[kHalf], y[kHalf], iu[kHalf];
#pragma unroll
          for (int q = 0; q < kHalf; ++q) t[q] = yh[half * kHalf + q];
          sig_t<kHalf, PERIODIC>(sh, t);
          sig_s<kHalf>(sh, t, y, iu);
#pragma unroll
          for (int q = 0; q < kHalf; ++q) yh[half * kHalf + q] = t[q];
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float t[kHalf], y[kHalf], iu[kHalf], g[kHalf];
#pragma unroll
          for (int q = 0; q < kHalf; ++q) t[q] = dl[half * kHalf + q];
          sig_t<kHalf, false>(sl, t);
          if (sl.half_a != 1) {  // t / r^2, 0 where t underflows
#pragma unroll
            for (int q = 0; q < kHalf; ++q) g[q] = t[q] / dl[half * kHalf + q];
          }
          sig_s<kHalf>(sl, t, y, iu);
#pragma unroll
          for (int q = 0; q < kHalf; ++q) {
            const int p = half * kHalf + q;
            float gq = sl.dscale * y[q] * iu[q];
            if (sl.half_a != 1) gq *= g[q];
            // zero latent distance: no contribution
            f[p] = (keep >> p) & 1u ? (t[q] - yh[p]) * gq : 0.f;
          }
        }
      }
      for (int v0 = 0; v0 < nv; v0 += kVGroup) {
        const int vn = min(kVGroup, nv - v0), vb = P == 1 ? v0 : 0;
        for (int v = v0; v < v0 + vn; ++v) {
          float wi[4] = {1.f, 1.f, 1.f, 1.f}, wj[4] = {1.f, 1.f, 1.f, 1.f};
          if (v && d <= kChunk) {
            const float4 a =
                *reinterpret_cast<const float4*>(lsI + (v - 1) * ld + pi * kPass + 4 * ty);
            const float4 b =
                *reinterpret_cast<const float4*>(lsJ + (v - 1) * ld + pj * kPass + 4 * tx);
            wi[0] = a.x; wi[1] = a.y; wi[2] = a.z; wi[3] = a.w;
            wj[0] = b.x; wj[1] = b.y; wj[2] = b.z; wj[3] = b.w;
          } else if (v) {  // l is not staged: from global memory
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = i0 + 4 * ty + r, j = j0 + 4 * tx + r;
              wi[r] = i < n ? l[static_cast<size_t>(i) * d + v - 1] : 0.f;
              wj[r] = j < n ? l[static_cast<size_t>(j) * d + v - 1] : 0.f;
            }
          }
          float pr[4], pc[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pr[r] = f[4 * r] * wj[0];
#pragma unroll
            for (int c = 1; c < 4; ++c) pr[r] = fmaf(f[4 * r + c], wj[c], pr[r]);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            pc[c] = f[c] * wi[0];
#pragma unroll
            for (int r = 1; r < 4; ++r) pc[c] = fmaf(f[4 * r + c], wi[r], pc[c]);
          }
          // rows: sum over the 16 tx lanes of the half-warp, halving the
          // values held at each of the first two steps; the lane ends with
          // row 2 b3 + b2 of its 4
          float k0 = b3 ? pr[2] : pr[0], k1 = b3 ? pr[3] : pr[1];
          k0 += __shfl_xor_sync(kFull, b3 ? pr[0] : pr[2], 8);
          k1 += __shfl_xor_sync(kFull, b3 ? pr[1] : pr[3], 8);
          float x = (b2 ? k1 : k0) + __shfl_xor_sync(kFull, b2 ? k0 : k1, 4);
          x += __shfl_xor_sync(kFull, x, 2);
          x += __shfl_xor_sync(kFull, x, 1);
          if ((tx & 3) == 0) rowacc[(v - vb) * T + pi * kPass + 4 * ty + 2 * b3 + b2] += x;
          // columns: sum over the warp's two ty; the lane ends with columns
          // 2 b4 and 2 b4 + 1 of its 4, then the warps are added in order
          const float c0 = (b4 ? pc[2] : pc[0]) + __shfl_xor_sync(kFull, b4 ? pc[0] : pc[2], 16);
          const float c1 = (b4 ? pc[3] : pc[1]) + __shfl_xor_sync(kFull, b4 ? pc[1] : pc[3], 16);
          float* cb = colbuf + (warp * kVGroup + v - v0) * kPass + 4 * tx + 2 * b4;
          cb[0] = c0;
          cb[1] = c1;
        }
        __syncthreads();
        for (int e = threadIdx.x; e < vn * kPass; e += kThreads) {
          const int g = e / kPass, x = e - g * kPass;
          float s = colbuf[g * kPass + x];
          for (int w = 1; w < kWarps; ++w) s += colbuf[(w * kVGroup + g) * kPass + x];
          if (P == 1) {  // the tile's one pass: the group's sums are final
            put_slot(ws, n, nv, T, I, J, v0 + g, x, rowacc[g * T + x], s);
            rowacc[g * T + x] = 0.f;
          } else {
            colacc[(v0 + g) * T + pj * kPass + x] += s;
          }
        }
        __syncthreads();  // colbuf and rowacc are read before the next group writes them
      }
    }
  }
  if (P > 1)
    for (int e = threadIdx.x; e < nv * T; e += kThreads)
      put_slot(ws, n, nv, T, I, J, e / T, e % T, rowacc[e], colacc[e]);
}

// grad[i, k] = gout 4/B^2 (S_0 l[i, k] - S_{k+1}), S_v the sum of row i's
// slots v over the nt tiles in tile order: kSumParts threads per row take
// fixed ranges of tiles, and warp 0 adds their sums in order, one v at a
// time.
__global__ void __launch_bounds__(kThreads)
sum_slots_kernel(const float* __restrict__ ws, const float* __restrict__ l, int n, int d,
                 int nt, const float* __restrict__ gout, float* __restrict__ grad) {
  __shared__ float part[kSumParts][kSumRows];
  const int nv = d + 1, r = threadIdx.x % kSumRows, q = threadIdx.x / kSumRows;
  const int i = blockIdx.x * kSumRows + r;
  const int t0 = q * nt / kSumParts, t1 = (q + 1) * nt / kSumParts;
  const float scale = 4.f / (static_cast<float>(n) * static_cast<float>(n)) * gout[0];
  float rs = 0.f;  // S_0, in warp 0
  for (int v = 0; v < nv; ++v) {
    float s = 0.f;
    if (i < n)
      for (int t = t0; t < t1; ++t) s += ws[(static_cast<size_t>(t) * nv + v) * n + i];
    part[q][r] = s;
    __syncthreads();
    if (q == 0) {
      float sum = 0.f;
      for (int p = 0; p < kSumParts; ++p) sum += part[p][r];
      if (v == 0) {
        rs = sum;
      } else if (i < n) {
        const size_t at = static_cast<size_t>(i) * d + v - 1;
        grad[at] = scale * (rs * l[at] - sum);
      }
    }
    __syncthreads();
  }
}

// Tile edge T for batch n: 128 from kTiles128 tiles of that edge on, else
// 64; the backward takes 64 for a latent wider than one chunk, whose d + 1
// row and column sums a 128-wide tile would hold in shared memory.
int tile_for(int n, int d, bool bwd) {
  if (bwd && d > kChunk) return kPass;
  const long long nt = (n + 127) / 128;
  return nt * (nt + 1) / 2 >= kTiles128 ? 128 : 64;
}

long long n_tiles(int n, int T) {
  const long long nt = (n + T - 1) / T;
  return nt * (nt + 1) / 2;
}

using Kernel = void (*)(const float*, const float*, int, int, int, SideSig, SideSig, float,
                        float*);

Kernel pick(bool bwd, int T, bool periodic) {
  if (bwd) {
    if (T == 128) return periodic ? &sigmoid_bwd_kernel<2, true> : &sigmoid_bwd_kernel<2, false>;
    return periodic ? &sigmoid_bwd_kernel<1, true> : &sigmoid_bwd_kernel<1, false>;
  }
  if (T == 128) return periodic ? &sigmoid_fwd_kernel<2, true> : &sigmoid_fwd_kernel<2, false>;
  return periodic ? &sigmoid_fwd_kernel<1, true> : &sigmoid_fwd_kernel<1, false>;
}

// The kernel and its dynamic shared memory, the attribute set where it
// passes the default 48 KB.
cudaError_t prepare(bool bwd, int T, bool periodic, int D, int d, Kernel* kern,
                    size_t* bytes) {
  *kern = pick(bwd, T, periodic);
  *bytes = sizeof(float) * smem_floats(bwd, T, D, d);
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(*kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

cudaError_t launch_tiles(bool bwd, const float* h, const float* l, int n, int D, int d,
                         double sig_h, double a_h, double b_h, double sig_l, double a_l,
                         double b_l, double period, int periodic, float* out,
                         cudaStream_t st) {
  const int T = tile_for(n, d, bwd);
  Kernel kern;
  size_t bytes;
  cudaError_t err = prepare(bwd, T, periodic != 0, D, d, &kern, &bytes);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(n_tiles(n, T)), kThreads, bytes, st>>>(
      h, l, n, D, d, make_side(sig_h, a_h, b_h), make_side(sig_l, a_l, b_l),
      static_cast<float>(period), out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks per SM of a tile kernel at these widths (tile 0: the batch's
// choice is not known here, so 0 means 128), or minus a CUDA error.
int em_sigmoid_occupancy(int bwd, int periodic, int tile, int D, int d) {
  Kernel kern;
  size_t bytes;
  cudaError_t err = prepare(bwd != 0, tile == 64 ? 64 : 128, periodic != 0, D, d, &kern,
                            &bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kern, kThreads, bytes);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Floats of scratch the forward pass needs for its per-tile partial sums,
// at either tile edge.
int em_sigmoid_fwd_workspace(int n) { return static_cast<int>(n_tiles(n, 64)); }

// Floats of scratch the backward pass needs: (d + 1) slots per row and
// tile.
long long em_sigmoid_bwd_workspace(int n, int d) {
  const int T = tile_for(n, d, true);
  return static_cast<long long>((n + T - 1) / T) * (d + 1) * n;
}

// out[0] = the loss of h (n, D) and l (n, d), both float32 row-major.
int em_sigmoid_fwd(const float* h, const float* l, int n, int D, int d, double sig_h,
                   double a_h, double b_h, double sig_l, double a_l, double b_l,
                   double period, int periodic, float* partials, float* out,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_tiles(false, h, l, n, D, d, sig_h, a_h, b_h, sig_l, a_l, b_l,
                                 period, periodic, partials, st);
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<1, 1024, 0, st>>>(partials,
                                          static_cast<int>(n_tiles(n, tile_for(n, d, false))),
                                          1.0 / (static_cast<double>(n) * n), out);
  return cudaGetLastError();
}

// grad (n, d) = gout[0] * d loss / d l; the loss has no gradient in h.
// workspace: em_sigmoid_bwd_workspace(n, d) floats.
int em_sigmoid_bwd(const float* h, const float* l, int n, int D, int d, double sig_h,
                   double a_h, double b_h, double sig_l, double a_l, double b_l,
                   double period, int periodic, const float* gout, float* workspace,
                   float* grad, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_tiles(true, h, l, n, D, d, sig_h, a_h, b_h, sig_l, a_l, b_l,
                                 period, periodic, workspace, st);
  if (err != cudaSuccess) return err;
  const int T = tile_for(n, d, true);
  sum_slots_kernel<<<(n + kSumRows - 1) / kSumRows, kThreads, 0, st>>>(
      workspace, l, n, d, (n + T - 1) / T, gout, grad);
  return cudaGetLastError();
}

}  // extern "C"
