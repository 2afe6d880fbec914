// Round-trip latency of a (row, value) word between two blocks of a
// cluster through distributed shared memory, by store / fence variant: the
// mailbox exchange of the row forward kernel (csrc/tape_fwd.cu).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o dsmem_pingpong dsmem_pingpong.cu
//   ./dsmem_pingpong
#include <cooperative_groups.h>
#include <cstdio>
namespace cg = cooperative_groups;

__device__ __forceinline__ void st_volatile(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}
__device__ __forceinline__ unsigned long long ld_volatile(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}
__device__ __forceinline__ void st_relaxed_cluster(unsigned long long* generic_remote, unsigned long long v) {
  asm volatile("st.relaxed.cluster.u64 [%0], %1;" :: "l"(generic_remote), "l"(v) : "memory");
}
__device__ __forceinline__ void st_release_cluster(unsigned long long* generic_remote, unsigned long long v) {
  asm volatile("st.release.cluster.u64 [%0], %1;" :: "l"(generic_remote), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long ld_acquire_cluster(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.cluster.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned long long ld_relaxed_cluster(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.cluster.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__global__ void k(int mode, int iters, long long* out) {
  cg::cluster_group cl = cg::this_cluster();
  __shared__ unsigned long long box;
  const int rank = cl.block_rank();
  if (threadIdx.x == 0) box = ~0ull;
  cl.sync();
  unsigned long long* peer = cl.map_shared_rank(&box, rank ^ 1);
  long long t0 = clock64();
  if (threadIdx.x == 0 && rank < 2) {
    for (int i = 0; i < iters; ++i) {
      const unsigned long long want = (unsigned long long)i << 32;
      if (rank == 0) {
        const unsigned long long v = (unsigned long long)i << 32;
        if (mode == 0) st_volatile(peer, v);
        else if (mode == 1) { st_volatile(peer, v); asm volatile("fence.acq_rel.cluster;" ::: "memory"); }
        else if (mode == 2) st_relaxed_cluster(peer, v);
        else if (mode == 3) st_release_cluster(peer, v);
        else { st_volatile(peer, v); __threadfence_block(); }
        if (mode == 3) { while (ld_acquire_cluster(&box) != want) {} }
        else if (mode == 2) { while (ld_relaxed_cluster(&box) != want) {} }
        else { while (ld_volatile(&box) != want) {} }
      } else {
        if (mode == 3) { while (ld_acquire_cluster(&box) != want) {} }
        else if (mode == 2) { while (ld_relaxed_cluster(&box) != want) {} }
        else { while (ld_volatile(&box) != want) {} }
        if (mode == 0) st_volatile(peer, want);
        else if (mode == 1) { st_volatile(peer, want); asm volatile("fence.acq_rel.cluster;" ::: "memory"); }
        else if (mode == 2) st_relaxed_cluster(peer, want);
        else if (mode == 3) st_release_cluster(peer, want);
        else { st_volatile(peer, want); __threadfence_block(); }
      }
    }
  }
  long long t1 = clock64();
  if (threadIdx.x == 0 && rank == 0) *out = t1 - t0;
  cl.sync();
}

int main() {
  long long* out;
  cudaMalloc(&out, 8);
  const char* names[] = {"volatile st + volatile ld", "volatile st + fence.acq_rel.cluster",
                         "st.relaxed.cluster + ld.relaxed.cluster", "st.release.cluster + ld.acquire.cluster",
                         "volatile st + threadfence_block"};
  for (int threads : {32, 288}) {
    for (int mode = 0; mode < 5; ++mode) {
      for (int C : {2, 8}) {
        cudaLaunchConfig_t cfg = {};
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = C; attr[0].val.clusterDim.y = 1; attr[0].val.clusterDim.z = 1;
        cfg.gridDim = dim3(C); cfg.blockDim = dim3(threads); cfg.attrs = attr; cfg.numAttrs = 1;
        const int iters = 2000;
        cudaLaunchKernelEx(&cfg, k, mode, iters, out);
        cudaError_t err = cudaDeviceSynchronize();
        long long cyc = 0;
        cudaMemcpy(&cyc, out, 8, cudaMemcpyDeviceToHost);
        printf("threads %3d C=%d %-45s one way %.0f cycles (%s)\n", threads, C, names[mode],
               cyc / (2.0 * iters), cudaGetErrorString(err));
      }
    }
  }
  return 0;
}
