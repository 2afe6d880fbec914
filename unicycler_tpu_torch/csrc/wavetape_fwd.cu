// Wavefront (anti-diagonal) banded Gotoh DP over a task tape.
//
// Replaces: unicycler_tpu/ops/pallas_wavetape.py:_make_wavetape_kernel
// (entry wavetape_forward). Same arithmetic, same move bits, same capture
// tie order; the per-group prolog (window bases, advances, slice starts) and
// the end selection are computed by the wrapper in
// unicycler_tpu_torch/ops/wavetape_kernels.py, as XLA did around the TPU
// kernel.
//
// What bounds it on an H100: neither bytes nor operations. Each track is a
// serial chain of wavefronts (every step depends on the two before it), so
// the time is (wavefronts per track) x (latency of one step), and a step is
// about 30 integer operations per lane plus one block barrier. A launch has
// only 8-32 tracks, so 8-32 of the 132 SMs are busy.
//
// Design: one block per track, one thread per diagonal lane (1, 2 or 4
// lanes per thread so that a block never exceeds 512 threads). The H/E/F
// values of wavefront a-1 sit in shared memory, double buffered, so a
// step reads its neighbours' lanes from one buffer and writes the other:
// one __syncthreads() per wavefront. H of wavefront a-2 is only ever read
// by its own lane and stays in a register. Query and reference bases are
// read straight from q_tape / r_flat at the index the TPU kernel's lane
// window gives each lane (the repeat-2 lane tapes it built are not needed).
// Each thread packs its lane's eight 4-bit moves into a register and stores
// one int32 per 8 wavefronts, coalesced across lanes: the (B, LA/8, W)
// layout of the TPU kernel. Captures (corner, best row-n value with its
// smallest j, best column-m value with its smallest i) run only in groups
// whose capture flag is set, and merge into per-track scalars with warp
// reductions plus shared-memory atomics.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int NEG = -(1 << 30);
constexpr int NEG_HALF = -(1 << 29);
constexpr int BIG = 1 << 30;
constexpr int G = 32;        // wavefronts per group
constexpr int NF = 9;        // per-group plane fields
enum { P_DB = 0, P_ADV, P_RST, P_HIT, P_A0, P_N2, P_M2, P_SQ, P_SR };

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int LPT>
__global__ void __launch_bounds__(512) wavetape_fwd_kernel(
    const uint8_t* __restrict__ q_tape, int LR,
    const int8_t* __restrict__ r_flat, int M,
    const int* __restrict__ plane, int NG,
    int* __restrict__ moves, int* __restrict__ best,
    int W, int match_s, int mismatch, int open_, int ext, int fs1, int fs2) {
  extern __shared__ int smem[];
  __shared__ int red[5];
  const int b = blockIdx.x;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int Wp = W + 2;          // lane k at index k + 1; NEG pads at 0, W + 1
  const uint8_t* q = q_tape + (size_t)b * LR;
  const int8_t* r = r_flat + (size_t)b * M;
  const int* pl = plane + (size_t)b * NG * NF;
  unsigned* mv_out = moves ? reinterpret_cast<unsigned*>(moves) + (size_t)b * NG * (G / 8) * W
                           : nullptr;
  int* best_out = best + (size_t)b * NG * 5;

  for (int x = tid; x < 6 * Wp; x += nt) smem[x] = NEG;
  int h1o[LPT], h2[LPT];
#pragma unroll
  for (int s = 0; s < LPT; ++s) { h1o[s] = NEG; h2[s] = NEG; }
  int cor = NEG, rnv = NEG, rnj = 0, lcv = NEG, lci = 0;   // thread 0 only
  int cur = 0;
  __syncthreads();

  for (int g = 0; g < NG; ++g) {
    const int* p = pl + g * NF;
    const int c0w = p[P_DB], adv = p[P_ADV], rst = p[P_RST], hit = p[P_HIT];
    const int ag0 = p[P_A0], n2 = p[P_N2], m2 = p[P_M2], sq = p[P_SQ], sr = p[P_SR];
    int* Hc = smem + cur * 3 * Wp;
    int* Ec = Hc + Wp;
    int* Fc = Ec + Wp;

    if (adv != 0) {
      // realign the carries to this group's window: new lane k takes old
      // lane k + adv, NEG where that leaves the window
      int* Ho = smem + (1 - cur) * 3 * Wp;     // free: scratch for H(a-2)
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
      int* Hn = smem + (1 - cur) * 3 * Wp;
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

        const int qv = q[(qoff + k) >> 1];
        const int rv = r[(roff + k) >> 1];
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
      Hc = smem + cur * 3 * Wp;
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

template <int LPT>
int launch(const uint8_t* q_tape, int LR, const int8_t* r_flat, int M,
           const int* plane, int B, int NG, int* moves, int* best, int W,
           int match_s, int mismatch, int open_, int ext, int fs1, int fs2,
           cudaStream_t stream) {
  const int threads = W / LPT;
  const size_t shmem = sizeof(int) * 6 * (size_t)(W + 2);
  cudaError_t err = cudaFuncSetAttribute(wavetape_fwd_kernel<LPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shmem);
  if (err != cudaSuccess) return (int)err;
  wavetape_fwd_kernel<LPT><<<B, threads, shmem, stream>>>(
      q_tape, LR, r_flat, M, plane, NG, moves, best, W, match_s, mismatch,
      open_, ext, fs1, fs2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wavetape_fwd_launch(const uint8_t* q_tape, int LR,
                                   const int8_t* r_flat, int M,
                                   const int* plane, int B, int NG,
                                   int* moves, int* best, int W,
                                   int match_s, int mismatch, int open_,
                                   int ext, int fs1, int fs2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W % 128 != 0 || W < 128 || W > 2048) return (int)cudaErrorInvalidValue;
  if (W <= 512)
    return launch<1>(q_tape, LR, r_flat, M, plane, B, NG, moves, best, W,
                     match_s, mismatch, open_, ext, fs1, fs2, st);
  if (W <= 1024)
    return launch<2>(q_tape, LR, r_flat, M, plane, B, NG, moves, best, W,
                     match_s, mismatch, open_, ext, fs1, fs2, st);
  return launch<4>(q_tape, LR, r_flat, M, plane, B, NG, moves, best, W,
                   match_s, mismatch, open_, ext, fs1, fs2, st);
}
