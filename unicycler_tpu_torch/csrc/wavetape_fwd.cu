// Wavefront (anti-diagonal) banded Gotoh DP over a task tape.
//
// Replaces: unicycler_tpu/ops/pallas_wavetape.py:_make_wavetape_kernel
// (entry wavetape_forward). Same arithmetic, same move bits, same capture
// tie order; the per-group prolog (window bases, advances, slice starts) and
// the end selection are computed by the wrapper in
// unicycler_tpu_torch/ops/wavetape_kernels.py, as XLA did around the TPU
// kernel.
//
// What bounds it on an H100: int32 operations, once the card is full. Each
// track is a serial chain of wavefronts (every step depends on the two
// before it); a step costs about 45 integer operations per lane and one
// block barrier. With one task a track (ops/wavetape.build_wave_launches) a
// launch holds hundreds of tracks, so the chains run side by side on all
// 132 SMs and the card's integer rate, not one chain's latency, sets the
// time.
//
// Design: one block per track, 128 or 256 threads, each thread holding
// W / threads diagonal lanes (strided, so every access below is coalesced
// across a warp). Registers (at most 64 a thread for 1-2 lanes) and about
// 14 KB of shared memory at W = 512 leave room for four resident blocks an
// SM, which hide each other's barrier and load latency
// (wavetape_fwd_occupancy reports the count).
//   * The H/E/F values of wavefront a-1 sit in shared memory, double
//     buffered: a step reads its neighbours' lanes from one buffer and
//     writes the other, so one __syncthreads() a wavefront. H of wavefront
//     a-2 is only read by its own lane and stays in a register.
//   * Bases come from shared memory. At each group's entry the block has
//     the group's query and reference windows ((W + G) / 2 + 1 bytes each,
//     read at the TPU kernel's repeat-2 lane offsets) and its plane row in
//     shared memory: cp.async copies them one group ahead (plane rows two
//     groups ahead, since a window's offsets are in its plane row), so the
//     copy of group g + 1 is in flight while group g runs its 32 steps.
//   * A block stops after its track's last real group (ngt): padding is
//     not executed. Moves and best past it stay unwritten; nothing reads
//     them (end selection reads best at each task's lastg, and the walker
//     starts at each task's end cell).
//   * Captures (corner, best row-n value with its smallest j, best
//     column-m value with its smallest i) run only in groups where this
//     track's own windows cross its task's row n or column m, and merge
//     into per-track scalars with warp reductions plus shared-memory
//     atomics.
//   * Each thread packs its lanes' eight 4-bit moves into registers and
//     stores one int32 per 8 wavefronts, coalesced across lanes: the
//     (B, LA/8, W) layout of the TPU kernel.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int NEG = -(1 << 30);
constexpr int NEG_HALF = -(1 << 29);
constexpr int BIG = 1 << 30;
constexpr int G = 32;        // wavefronts per group
constexpr int NF = 9;        // per-group plane fields
constexpr int RING = 4;      // plane rows held in shared memory
enum { P_DB = 0, P_ADV, P_RST, P_HIT, P_A0, P_N2, P_M2, P_SQ, P_SR };

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// bytes of one staged base window: the (W + G - 1) / 2 + 1 bytes a group
// reads, plus up to 15 in front from aligning its start down to 16 bytes
__host__ __device__ __forceinline__ int window_bytes(int W) {
  return ((W + G) / 2 + 32 + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ size_t shmem_bytes(int W) {
  return 4 * (size_t)window_bytes(W) + sizeof(int) * (RING * NF + 6 * (size_t)(W + 2));
}

// first byte (aligned down to 16) of the window a group reads at half-base
// offset s, and its 16-byte chunk count
__device__ __forceinline__ void window_span(int s, int W, int& first, int& chunks) {
  first = (s >> 1) & ~15;
  chunks = (((s + W + G - 2) >> 1) - first) / 16 + 1;
}

// one thread per 16-byte chunk: the query window, then the reference window
__device__ __forceinline__ void stage_bases(const uint8_t* q, const int8_t* r,
                                            const int* prow, uint8_t* qs, uint8_t* rs,
                                            int W, int tid) {
  int q0, nq, r0, nr;
  window_span(prow[P_SQ], W, q0, nq);
  window_span(prow[P_SR], W, r0, nr);
  if (tid < nq)
    cp_async16(qs + 16 * tid, q + q0 + 16 * tid);
  else if (tid < nq + nr)
    cp_async16(rs + 16 * (tid - nq), r + r0 + 16 * (tid - nq));
}

template <int LPT>
__global__ void __launch_bounds__(256, LPT <= 2 ? 4 : (LPT <= 4 ? 2 : 1))
wavetape_fwd_kernel(const uint8_t* __restrict__ q_tape, int LR,
                    const int8_t* __restrict__ r_flat, int M,
                    const int* __restrict__ plane, const int* __restrict__ ngt, int NG,
                    int* __restrict__ moves, int* __restrict__ best,
                    int W, int match_s, int mismatch, int open_, int ext, int fs1, int fs2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[5];
  const int b = blockIdx.x;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int ng = min(ngt[b], NG);
  if (ng <= 0) return;
  const int QB = window_bytes(W);
  uint8_t* qwin = smem;                       // 2 buffers of QB bytes
  uint8_t* rwin = smem + 2 * QB;              // 2 buffers of QB bytes
  int* ring = reinterpret_cast<int*>(smem + 4 * QB);
  int* hef = ring + RING * NF;
  const int Wp = W + 2;          // lane k at index k + 1; NEG pads at 0, W + 1
  const uint8_t* q = q_tape + (size_t)b * LR;
  const int8_t* r = r_flat + (size_t)b * M;
  const int* pl = plane + (size_t)b * NG * NF;
  unsigned* mv_out = moves ? reinterpret_cast<unsigned*>(moves) + (size_t)b * NG * (G / 8) * W
                           : nullptr;
  int* best_out = best + (size_t)b * NG * 5;

  // prologue: plane rows 0 and 1, then group 0's windows
  if (tid < 2 * NF && tid / NF < ng) cp_async4(ring + tid, pl + tid);
  cp_async_commit();
  for (int x = tid; x < 6 * Wp; x += nt) hef[x] = NEG;
  cp_async_wait_all();
  __syncthreads();
  stage_bases(q, r, ring, qwin, rwin, W, tid);
  cp_async_commit();

  int h1o[LPT], h2[LPT];
#pragma unroll
  for (int s = 0; s < LPT; ++s) { h1o[s] = NEG; h2[s] = NEG; }
  int cor = NEG, rnv = NEG, rnj = 0, lcv = NEG, lci = 0;   // thread 0 only
  int cur = 0;

  for (int g = 0; g < ng; ++g) {
    // group g's windows and plane row g + 1 have landed; start the copies
    // of group g + 1's windows and plane row g + 2
    cp_async_wait_all();
    __syncthreads();
    if (g + 2 < ng && tid < NF)
      cp_async4(ring + ((g + 2) % RING) * NF + tid, pl + (size_t)(g + 2) * NF + tid);
    if (g + 1 < ng)
      stage_bases(q, r, ring + ((g + 1) % RING) * NF, qwin + ((g + 1) & 1) * QB,
                  rwin + ((g + 1) & 1) * QB, W, tid);
    cp_async_commit();

    const int* p = ring + (g % RING) * NF;
    const int c0w = p[P_DB], adv = p[P_ADV], rst = p[P_RST], hit = p[P_HIT];
    const int ag0 = p[P_A0], n2 = p[P_N2], m2 = p[P_M2];
    // half-base offsets relative to the staged windows' first bytes:
    // (s >> 1) - first == (s - 2 * first) >> 1
    const int sq = p[P_SQ] - 2 * ((p[P_SQ] >> 1) & ~15);
    const int sr = p[P_SR] - 2 * ((p[P_SR] >> 1) & ~15);
    const uint8_t* qs = qwin + (g & 1) * QB;
    const int8_t* rs = reinterpret_cast<const int8_t*>(rwin + (g & 1) * QB);
    int* Hc = hef + cur * 3 * Wp;
    int* Ec = Hc + Wp;
    int* Fc = Ec + Wp;

    if (adv != 0) {
      // realign the carries to this group's window: new lane k takes old
      // lane k + adv, NEG where that leaves the window
      int* Ho = hef + (1 - cur) * 3 * Wp;      // free: scratch for H(a-2)
#pragma unroll
      for (int s = 0; s < LPT; ++s) Ho[tid + s * nt + 1] = h2[s];
      __syncthreads();
      int nh1[LPT], ne[LPT], nf[LPT], nh2[LPT];
#pragma unroll
      for (int s = 0; s < LPT; ++s) {
        const int src = tid + s * nt + adv;
        const bool ok = src >= 0 && src < W;
        nh1[s] = ok ? Hc[src + 1] : NEG;
        ne[s] = ok ? Ec[src + 1] : NEG;
        nf[s] = ok ? Fc[src + 1] : NEG;
        nh2[s] = ok ? Ho[src + 1] : NEG;
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < LPT; ++s) {
        const int k = tid + s * nt;
        Hc[k + 1] = nh1[s]; Ec[k + 1] = ne[s]; Fc[k + 1] = nf[s];
        h1o[s] = nh1[s]; h2[s] = nh2[s];
      }
    }
    if (rst) {
#pragma unroll
      for (int s = 0; s < LPT; ++s) {
        const int k = tid + s * nt;
        Hc[k + 1] = NEG; Ec[k + 1] = NEG; Fc[k + 1] = NEG;
        h1o[s] = NEG; h2[s] = NEG;
      }
      if (tid == 0) { cor = NEG; rnv = NEG; rnj = 0; lcv = NEG; lci = 0; }
    }
    if (adv != 0 || rst) __syncthreads();

    const int mm = m2 >> 1, nn = n2 >> 1;
    int hat_l[LPT], cor_l[LPT], lcv_l[LPT], lci_l[LPT];
    unsigned mv_acc[LPT];
#pragma unroll
    for (int s = 0; s < LPT; ++s) {
      hat_l[s] = NEG; cor_l[s] = NEG; lcv_l[s] = NEG; lci_l[s] = 0; mv_acc[s] = 0u;
    }

    for (int t = 0; t < G; ++t) {
      const int a = ag0 + t;
      const int u = a - c0w;
      const int jv = a + c0w;
      int* Hn = hef + (1 - cur) * 3 * Wp;
      int* En = Hn + Wp;
      int* Fn = En + Wp;
      int h0v;
      if (fs2) h0v = a >= 0 ? 0 : NEG;
      else h0v = a > 0 ? open_ + (a - 1) * ext : (a == 0 ? 0 : NEG);
      if (a > mm) h0v = NEG;
      const int col0 = fs1 ? 0 : open_ + (a - 1) * ext;
      const int qoff = sq + (G - 1 - t);
      const int roff = sr + t;
#pragma unroll
      for (int s = 0; s < LPT; ++s) {
        const int k = tid + s * nt;
        const int fl = Fc[k + 2];
        const int er = Ec[k];
        const int hl = Hc[k + 2];
        const int hr = Hc[k];
        const int f_new = max(hl + open_, fl + ext);
        const bool f_ext_bit = (f_new == fl + ext) && (fl > NEG_HALF);
        int e_new = max(hr + open_, er + ext);
        const bool e_ext_bit = (e_new == er + ext) && (er > NEG_HALF);
        e_new = e_new > NEG_HALF ? e_new : NEG;

        const int qv = qs[(qoff + k) >> 1];
        const int rv = rs[(roff + k) >> 1];
        const int sub = qv == rv ? match_s : mismatch;
        const bool i1n = (k <= u - 2) && (k >= u - n2);
        const bool jge1 = k >= 2 - jv;
        const bool jge0 = k >= -jv;
        const bool jlem = k <= m2 - jv;
        int diag = (i1n && jge1 && jlem) ? h2[s] + sub : NEG;
        if (i1n && k == -jv) diag = col0;
        const int e_m = jge1 ? e_new : NEG;
        const int gg = max(diag, jge1 ? f_new : NEG);
        int h = max(gg, e_m);
        h = (i1n && jge0 && jlem) ? h : NEG;
        if (mv_out) {
          const unsigned hsrc = h == diag ? 0u : (h == e_m ? 1u : 2u);
          const unsigned m4 = hsrc | (e_ext_bit ? 4u : 0u) | (f_ext_bit ? 8u : 0u);
          mv_acc[s] |= m4 << (4 * (t & 7));
          if ((t & 7) == 7) {
            mv_out[(size_t)(g * (G / 8) + (t >> 3)) * W + k] = mv_acc[s];
            mv_acc[s] = 0u;
          }
        }
        if (k == u) h = h0v;            // row-0 boundary cell (0, a)
        if (hit) {
          const bool rowm = k == u - n2;
          const bool colm = k == m2 - jv;
          if (rowm) hat_l[s] = h;
          if (rowm && colm) cor_l[s] = h;
          if (colm && (u - k) >= 0 && (u - k) <= n2 && h > lcv_l[s]) {
            lcv_l[s] = h;
            lci_l[s] = (u - k) >> 1;
          }
        }
        Hn[k + 1] = h; En[k + 1] = e_new; Fn[k + 1] = f_new;
        h2[s] = h1o[s];
        h1o[s] = h;
      }
      __syncthreads();
      cur = 1 - cur;
      Hc = hef + cur * 3 * Wp;
      Ec = Hc + Wp;
      Fc = Ec + Wp;
    }

    if (hit) {
      // merge the group's lane captures into the running scalars
      if (tid == 0) {
        red[0] = INT_MIN; red[1] = INT_MIN; red[2] = INT_MIN; red[3] = BIG; red[4] = BIG;
      }
      __syncthreads();
      int mc = INT_MIN, mg = INT_MIN, ml = INT_MIN;
#pragma unroll
      for (int s = 0; s < LPT; ++s) {
        mc = max(mc, cor_l[s]); mg = max(mg, hat_l[s]); ml = max(ml, lcv_l[s]);
      }
      mc = warp_max(mc); mg = warp_max(mg); ml = warp_max(ml);
      if ((tid & 31) == 0) {
        atomicMax(&red[0], mc); atomicMax(&red[1], mg); atomicMax(&red[2], ml);
      }
      __syncthreads();
      const int gv = red[1], lgv = red[2];
      int gj = BIG, lgi = BIG;
#pragma unroll
      for (int s = 0; s < LPT; ++s) {
        const int k = tid + s * nt;
        if (hat_l[s] == gv && gv > NEG_HALF) gj = min(gj, c0w + k + nn);
        if (lcv_l[s] == lgv && lgv > NEG_HALF) lgi = min(lgi, lci_l[s]);
      }
      gj = warp_min(gj); lgi = warp_min(lgi);
      if ((tid & 31) == 0) { atomicMin(&red[3], gj); atomicMin(&red[4], lgi); }
      __syncthreads();
      if (tid == 0) {
        cor = max(cor, red[0]);
        if (gv > rnv) { rnv = gv; rnj = red[3]; }
        if (lgv > lcv) { lcv = lgv; lci = red[4]; }
      }
    }
    if (tid == 0) {
      int* o = best_out + g * 5;
      o[0] = cor; o[1] = rnv; o[2] = rnj; o[3] = lcv; o[4] = lci;
    }
  }
}

// threads a block for band W: 256 where W is a multiple of 256, else 128;
// each thread takes W / threads lanes
int block_threads(int W) { return W % 256 == 0 ? 256 : 128; }

template <int LPT>
int launch(const uint8_t* q_tape, int LR, const int8_t* r_flat, int M,
           const int* plane, const int* ngt, int B, int NG, int* moves, int* best, int W,
           int match_s, int mismatch, int open_, int ext, int fs1, int fs2,
           cudaStream_t stream) {
  const size_t shmem = shmem_bytes(W);
  cudaError_t err = cudaFuncSetAttribute(wavetape_fwd_kernel<LPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shmem);
  if (err != cudaSuccess) return (int)err;
  wavetape_fwd_kernel<LPT><<<B, block_threads(W), shmem, stream>>>(
      q_tape, LR, r_flat, M, plane, ngt, NG, moves, best, W, match_s, mismatch,
      open_, ext, fs1, fs2);
  return (int)cudaGetLastError();
}

template <int LPT>
int occupancy(int W, int* blocks) {
  const size_t shmem = shmem_bytes(W);
  cudaError_t err = cudaFuncSetAttribute(wavetape_fwd_kernel<LPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shmem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, wavetape_fwd_kernel<LPT>, block_threads(W), shmem);
}

}  // namespace

// W is one of 128, 256, 384, 512, 1024, 2048 (ops/banded.band_width up to
// the wave route's 2048); any other width is refused.
#define WAVETAPE_FWD_DISPATCH(CALL)                       \
  switch (W / block_threads(W)) {                         \
    case 1: return CALL(1);                               \
    case 2: return CALL(2);                               \
    case 3: return CALL(3);                               \
    case 4: return CALL(4);                               \
    case 8: return CALL(8);                               \
    default: return (int)cudaErrorInvalidValue;           \
  }

extern "C" int wavetape_fwd_launch(const uint8_t* q_tape, int LR,
                                   const int8_t* r_flat, int M,
                                   const int* plane, const int* ngt, int B, int NG,
                                   int* moves, int* best, int W,
                                   int match_s, int mismatch, int open_,
                                   int ext, int fs1, int fs2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W % 128 != 0 || W < 128 || W > 2048 || B <= 0 || LR % 16 != 0 || M % 16 != 0)
    return (int)cudaErrorInvalidValue;
#define FWD_CALL(L)                                                              \
  launch<L>(q_tape, LR, r_flat, M, plane, ngt, B, NG, moves, best, W, match_s,   \
            mismatch, open_, ext, fs1, fs2, st)
  WAVETAPE_FWD_DISPATCH(FWD_CALL)
#undef FWD_CALL
}

// Resident blocks per SM of the kernel at band W (block size and shared
// memory as wavetape_fwd_launch gives them), and the block's threads.
extern "C" int wavetape_fwd_occupancy(int W, int* blocks, int* threads) {
  if (W % 128 != 0 || W < 128 || W > 2048) return (int)cudaErrorInvalidValue;
  *threads = block_threads(W);
#define OCC_CALL(L) occupancy<L>(W, blocks)
  WAVETAPE_FWD_DISPATCH(OCC_CALL)
#undef OCC_CALL
}
