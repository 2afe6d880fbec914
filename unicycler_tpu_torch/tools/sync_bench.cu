// Per-iteration cost of the synchronisation pieces of a row of the row
// forward kernel (csrc/tape_fwd.cu), on 12 clusters of C blocks of 288 or
// 864 threads: __syncthreads, cluster.sync(), a relaxed cluster barrier,
// and a cluster barrier followed by a distributed-shared-memory read.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o sync_bench sync_bench.cu
//   ./sync_bench
#include <cooperative_groups.h>
#include <cstdio>
namespace cg = cooperative_groups;

__global__ void k(int mode, int iters, int* out, int* gsink) {
  cg::cluster_group cl = cg::this_cluster();
  __shared__ int slot[2][8];
  __shared__ int wt[32];
  const int C = cl.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int acc = threadIdx.x;
  for (int it = 0; it < iters; ++it) {
    int* sl = slot[it & 1];
    if (threadIdx.x == 0) sl[0] = acc + it;
    if (lane == 31) wt[warp] = acc;
    if (mode == 0) {
      __syncthreads();
    } else if (mode == 1) {
      cl.sync();
    } else if (mode == 2) {
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    } else if (mode == 3) {
      cl.sync();
      int v = 0;
      if (lane < C) v = cl.map_shared_rank(sl, lane)[0];
      acc += __shfl_sync(0xffffffffu, v, C - 1);
    } else if (mode == 4) {
      __syncthreads();
      acc += wt[(warp + 1) % (blockDim.x >> 5)];
      cl.sync();
      int v = 0;
      if (lane < C) v = cl.map_shared_rank(sl, lane)[0];
      acc += __shfl_sync(0xffffffffu, v, C - 1);
    } else if (mode == 5) {
      __syncthreads();
      acc += wt[(warp + 1) % (blockDim.x >> 5)];
      cl.sync();
      int v = 0;
      if (lane < C) v = cl.map_shared_rank(sl, lane)[0];
      acc += __shfl_sync(0xffffffffu, v, C - 1);
      if ((it & 7) == 7) gsink[((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 2 + (it & 1)] = acc;
    } else if (mode == 6) {
      for (int s = 0; s < 20; ++s) acc = max(acc, __shfl_up_sync(0xffffffffu, acc, 1) + 1);
    } else if (mode == 7) {
      __syncthreads();
      acc += wt[(warp + 1) % (blockDim.x >> 5)];
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
      int v = 0;
      if (lane < C) v = cl.map_shared_rank(sl, lane)[0];
      acc += __shfl_sync(0xffffffffu, v, C - 1);
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
  cl.sync();  // no block leaves while another may read its shared memory
}

int main() {
  int *out, *gsink;
  cudaMalloc(&out, 1 << 24);
  cudaMalloc(&gsink, 1 << 26);
  const char* names[] = {"__syncthreads", "cluster.sync", "cluster relaxed arrive+wait",
                         "cluster.sync + DSMEM read", "syncthreads + cluster.sync + DSMEM",
                         "... + global store every 8", "20 dependent shuffles", "syncthreads + release/acquire + DSMEM"};
  const int iters = 20000;
  for (int threads : {288, 864}) {
    for (int mode = 0; mode < 8; ++mode) {
      for (int C : {1, 2, 4, 8}) {
        cudaLaunchConfig_t cfg = {};
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = C; attr[0].val.clusterDim.y = 1; attr[0].val.clusterDim.z = 1;
        cfg.gridDim = dim3(12 * C); cfg.blockDim = dim3(threads); cfg.attrs = attr; cfg.numAttrs = 1;
        cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
        cudaLaunchKernelEx(&cfg, k, mode, 100, out, gsink);
        cudaEventRecord(e0);
        cudaError_t err = cudaLaunchKernelEx(&cfg, k, mode, iters, out, gsink);
        cudaEventRecord(e1);
        cudaEventSynchronize(e1);
        float ms = 0; cudaEventElapsedTime(&ms, e0, e1);
        printf("threads %d  %-40s C=%d  %.1f ns/iter  (%s)\n", threads, names[mode], C, 1e6 * ms / iters,
               cudaGetErrorString(err));
      }
    }
  }
  return 0;
}
