// scripts/cluster_microbench.cu
//
// Costs of the building blocks of encodermap_tpu_torch/csrc/fused_train_cluster.cu
// on one Hopper card, in SM cycles (clock64):
//   - one cluster barrier (cluster.sync) across a 16-CTA cluster;
//   - the latency of a dependent L2 load (__ldcg) and of a dependent load from a
//     peer CTA's shared memory (distributed shared memory);
//   - the time to stage 64 KB of weights from L2 into shared memory, as the kernel
//     does (float4 __ldcg, 16 loads in flight per thread);
//   - cycles per instruction of straight-line code as it outgrows the SM's
//     instruction cache (256 threads, 8 independent FMA chains).
//
// Build and run on a machine with the card:
//   mkdir -p build && nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o build/cluster_microbench scripts/cluster_microbench.cu
//   build/cluster_microbench
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdio>

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kCluster = 16;

__global__ void blocks(const float* __restrict__ w, float* out, long long* res, int n) {
  extern __shared__ float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  float acc = 0.f;
  cluster.sync();
  long long t = clock64();
  for (int r = 0; r < 100; ++r) cluster.sync();
  if (threadIdx.x == 0) res[rank * 4 + 0] = (clock64() - t) / 100;

  t = clock64();
  int idx = threadIdx.x;
  for (int r = 0; r < 64; ++r) {  // each address depends on the last load
    const float v = __ldcg(w + (idx & (n - 1)));
    idx += 32 * 33 + static_cast<int>(v * 0.f);
    acc += v;
  }
  if (threadIdx.x == 0) res[rank * 4 + 1] = (clock64() - t) / 64;

  for (int e = threadIdx.x; e < 4096; e += kThreads) sm[e] = static_cast<float>(e);
  cluster.sync();
  const float* peer = cluster.map_shared_rank(sm, (rank + 1) % kCluster);
  t = clock64();
  idx = threadIdx.x;
  for (int r = 0; r < 64; ++r) {
    const float v = peer[idx & 4095];
    idx += 37 + static_cast<int>(v * 0.f);
    acc += v;
  }
  if (threadIdx.x == 0) res[rank * 4 + 2] = (clock64() - t) / 64;
  cluster.sync();

  const float4* w4 = reinterpret_cast<const float4*>(w);
  float4* s4 = reinterpret_cast<float4*>(sm);
  __syncthreads();
  t = clock64();
  for (int rep = 0; rep < 10; ++rep) {
    float4 v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = __ldcg(w4 + threadIdx.x + u * kThreads);
#pragma unroll
    for (int u = 0; u < 16; ++u) s4[threadIdx.x + u * kThreads] = v[u];
    __syncthreads();
  }
  if (threadIdx.x == 0) res[rank * 4 + 3] = (clock64() - t) / 10;
  cluster.sync();
  out[rank * kThreads + threadIdx.x] = acc + sm[threadIdx.x];
}

template <int N>
__global__ void straight(float* out, long long* cyc, float x, float y) {
  float a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3;
  float a4 = a0 + 4, a5 = a0 + 5, a6 = a0 + 6, a7 = a0 + 7;
  long long t = 0;
  for (int rep = 0; rep < 11; ++rep) {
    if (rep == 1) t = clock64();  // the first pass fills the cache
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(a0) : "f"(x), "f"(y));
      asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(a1) : "f"(x), "f"(y));
      asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(a2) : "f"(x), "f"(y));
      asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(a3) : "f"(x), "f"(y));
      asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(a4) : "f"(x), "f"(y));
      asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(a5) : "f"(x), "f"(y));
      asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(a6) : "f"(x), "f"(y));
      asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(a7) : "f"(x), "f"(y));
    }
  }
  if (threadIdx.x == 0) cyc[blockIdx.x] = (clock64() - t) / 10;
  out[blockIdx.x * blockDim.x + threadIdx.x] = a0 + a1 + a2 + a3 + a4 + a5 + a6 + a7;
}

static int check(cudaError_t e, const char* what) {
  if (e != cudaSuccess) std::printf("%s: %s\n", what, cudaGetErrorString(e));
  return e != cudaSuccess;
}

template <int N>
static int run_straight(float* out, long long* cyc) {
  for (int i = 0; i < 2; ++i) straight<N><<<16, kThreads>>>(out, cyc, 1.0001f, 0.5f);
  if (check(cudaDeviceSynchronize(), "straight")) return 1;
  long long h = 0;
  cudaMemcpy(&h, cyc, sizeof(h), cudaMemcpyDeviceToHost);
  // 8 warps on 4 schedulers: 2 cycles per FMA per warp at one instruction per cycle each
  std::printf("straight-line code %4d KB: %.2f cycles per instruction per warp (2.00 at one "
              "instruction per scheduler per cycle)\n",
              N * 16 / 1024, static_cast<double>(h) / N);
  return 0;
}

int main() {
  const int n = 1 << 20;
  float *w, *out;
  long long* res;
  if (check(cudaMalloc(&w, n * 4), "malloc") || check(cudaMalloc(&out, 16 * 1024 * 4), "malloc") ||
      check(cudaMalloc(&res, 16 * 16 * 8), "malloc"))
    return 1;
  cudaMemset(w, 0, n * 4);
  const int smem = 64 * 1024;
  cudaFuncSetAttribute(blocks, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(blocks, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (int it = 0; it < 2; ++it) {
    if (check(cudaLaunchKernelEx(&cfg, blocks, static_cast<const float*>(w), out, res, n),
              "launch") ||
        check(cudaDeviceSynchronize(), "run"))
      return 1;
  }
  long long h[64];
  cudaMemcpy(h, res, sizeof(h), cudaMemcpyDeviceToHost);
  const char* names[] = {"cluster.sync, 16 CTAs", "dependent L2 load (__ldcg)",
                         "dependent load from a peer CTA's shared memory",
                         "64 KB from L2 into shared memory (float4, 16 in flight)"};
  for (int i = 0; i < 4; ++i)
    std::printf("%-56s %lld cycles (rank 0), %lld (rank 15)\n", names[i], h[i], h[15 * 4 + i]);
  int bad = 0;
  bad |= run_straight<4096>(out, res);
  bad |= run_straight<6144>(out, res);
  bad |= run_straight<8192>(out, res);
  bad |= run_straight<10240>(out, res);
  bad |= run_straight<12288>(out, res);
  return bad;
}
