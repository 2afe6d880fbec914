// Per-task anti-diagonal banded Gotoh forward, score only.
//
// Replaces: unicycler_tpu/ops/pallas_wavefront.py:_make_wavefront_kernel
// (entry _wavefront_call, via wavefront_batch_corridor). Lanes are
// diagonals: within a group of G = 32 wavefronts a = i + j the window
// [dbase_g, dbase_g + W) is fixed and lane k holds diagonal dbase_g + k. At
// group entry the carries (H of wavefronts a-1 and a-2, E, F) realign by
// the group's advance adv: new lane k takes old lane k + adv, NEG where
// that leaves the window. The row-n and column-m captures are kept per
// lane in the group's frame and merged at group exit into the task's
// absolute-frame outputs hatn, lcv, lci (lane = diagonal - dmin, Wcap
// wide): hatn takes a captured value above NEG, lcv a strictly larger one
// (with its row in lci). Odd-parity lanes compute the same shadow DP as on
// the TPU and are never captured. The host (ops/wavefront.py) stages the
// per-group windows, advances, capture flags and base planes and selects
// the ends, as the JAX package does around its kernel.
//
// What bounds it on an H100: latency, as for the wave tape kernel. A task
// is a serial chain of wavefronts, each about 40 integer operations per
// lane and one block barrier; a launch has one block per task, so a batch
// of 8 tasks keeps 8 of the 132 SMs busy.
//
// Design: one block per task, one thread per lane (2 or 4 lanes a thread
// above W = 512, so a block stays at 512 threads). H/E/F of wavefront a-1
// sit in shared memory, double buffered with NEG pads at both ends, so a
// step reads its neighbours from one buffer and writes the other: one
// __syncthreads() per wavefront. H of wavefront a-2 is only read by its
// own lane and stays in a register. The group's query and reference base
// planes are staged in shared memory at group entry.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 30);
constexpr int NEG_HALF = -(1 << 29);
constexpr int G = 32;        // wavefronts per group
constexpr int PAR = 128;     // par / db row width

template <int LPT>
__global__ void __launch_bounds__(512) wavefront_fwd_kernel(
    const int* __restrict__ par, const int* __restrict__ db,
    const int8_t* __restrict__ zq, const int8_t* __restrict__ zr,
    int* __restrict__ hatn, int* __restrict__ lcv, int* __restrict__ lci,
    int B, int W, int Wcap, int GWp, int n_groups, int a_lo, int match_s,
    int mismatch, int open_, int ext, int fs1, int fs2) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int Wp = W + 2;          // lane k at index k + 1; NEG pads at 0, W + 1
  int8_t* zqs = reinterpret_cast<int8_t*>(smem + 7 * Wp);
  int8_t* zrs = zqs + GWp;
  const int nn = par[b * PAR], mm = par[b * PAR + 1], dmin = par[b * PAR + 2];
  const int n2 = 2 * nn, m2 = 2 * mm;
  int* ho = hatn + (size_t)b * Wcap;
  int* lo = lcv + (size_t)b * Wcap;
  int* io = lci + (size_t)b * Wcap;

  for (int x = tid; x < 7 * Wp; x += nt) smem[x] = NEG;
  for (int x = tid; x < Wcap; x += nt) { ho[x] = NEG; lo[x] = NEG; io[x] = 0; }
  int h1o[LPT], h2[LPT];
#pragma unroll
  for (int s = 0; s < LPT; ++s) { h1o[s] = NEG; h2[s] = NEG; }
  int cur = 0;
  __syncthreads();

  for (int g = 0; g < n_groups; ++g) {
    const int* d = db + ((size_t)g * B + b) * PAR;
    const int c0 = d[0], adv = d[1], hit = d[2];
    int* Hc = smem + cur * 3 * Wp;
    int* Ec = Hc + Wp;
    int* Fc = Ec + Wp;
    int* H2s = smem + 6 * Wp;
    const int8_t* zqg = zq + ((size_t)g * B + b) * GWp;
    const int8_t* zrg = zr + ((size_t)g * B + b) * GWp;
    for (int x = tid; x < GWp; x += nt) { zqs[x] = zqg[x]; zrs[x] = zrg[x]; }

    if (adv != 0) {
      // new lane k takes old lane k + adv, NEG outside the window
#pragma unroll
      for (int s = 0; s < LPT; ++s) H2s[tid + s * nt + 1] = h2[s];
      __syncthreads();
      int nh1[LPT], ne[LPT], nf[LPT], nh2[LPT];
#pragma unroll
      for (int s = 0; s < LPT; ++s) {
        const int src = tid + s * nt + adv;
        const bool ok = src >= 0 && src < W;
        nh1[s] = ok ? Hc[src + 1] : NEG;
        ne[s] = ok ? Ec[src + 1] : NEG;
        nf[s] = ok ? Fc[src + 1] : NEG;
        nh2[s] = ok ? H2s[src + 1] : NEG;
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < LPT; ++s) {
        const int k = tid + s * nt;
        Hc[k + 1] = nh1[s]; Ec[k + 1] = ne[s]; Fc[k + 1] = nf[s];
        h1o[s] = nh1[s]; h2[s] = nh2[s];
      }
    }
    __syncthreads();

    int hat_l[LPT], lcv_l[LPT], lci_l[LPT];
#pragma unroll
    for (int s = 0; s < LPT; ++s) { hat_l[s] = NEG; lcv_l[s] = NEG; lci_l[s] = 0; }
    const int a0 = a_lo + g * G;

    for (int t = 0; t < G; ++t) {
      const int a = a0 + t;
      const int u = a - c0;
      const int jv = a + c0;
      int* Hn = smem + (1 - cur) * 3 * Wp;
      int* En = Hn + Wp;
      int* Fn = En + Wp;
      int h0v;
      if (fs2) h0v = a >= 0 ? 0 : NEG;
      else h0v = a > 0 ? open_ + (a - 1) * ext : (a == 0 ? 0 : NEG);
      if (a > mm) h0v = NEG;
      const int col0 = fs1 ? 0 : open_ + (a - 1) * ext;
#pragma unroll
      for (int s = 0; s < LPT; ++s) {
        const int k = tid + s * nt;
        const int f_new = max(Hc[k + 2] + open_, Fc[k + 2] + ext);
        int e_new = max(Hc[k] + open_, Ec[k] + ext);
        e_new = e_new > NEG_HALF ? e_new : NEG;

        const int sub = zqs[G - 1 - t + k] == zrs[t + k] ? match_s : mismatch;
        const bool i1n = (k <= u - 2) && (k >= u - n2);
        const bool jge1 = k >= 2 - jv;
        const bool jge0 = k >= -jv;
        const bool jlem = k <= m2 - jv;
        int diag = (i1n && jge1 && jlem) ? h2[s] + sub : NEG;
        if (i1n && k == -jv) diag = col0;
        const int gg = max(diag, jge1 ? f_new : NEG);
        int h = max(gg, jge1 ? e_new : NEG);
        h = (i1n && jge0 && jlem) ? h : NEG;
        if (k == u) h = h0v;            // row-0 boundary cell (0, a)

        if (k == u - n2) hat_l[s] = h;
        const bool lcm = k == m2 - jv && u - k >= 0 && u - k <= n2;
        const int hlc = lcm ? h : NEG;
        if (hlc > lcv_l[s]) {
          lcv_l[s] = hlc;
          lci_l[s] = (u - k) >> 1;
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
      // merge into the absolute frame: lane k is diagonal c0 + k, at
      // c0 - dmin + k < Wcap; each lane is one thread's, so no race
      const int sh = c0 - dmin;
#pragma unroll
      for (int s = 0; s < LPT; ++s) {
        const int xa = tid + s * nt + sh;
        if (hat_l[s] > NEG) ho[xa] = hat_l[s];
        if (lcv_l[s] > lo[xa]) { lo[xa] = lcv_l[s]; io[xa] = lci_l[s]; }
      }
    }
  }
}

template <int LPT>
int launch(const int* par, const int* db, const int8_t* zq, const int8_t* zr,
           int* hatn, int* lcv, int* lci, int B, int W, int Wcap, int GWp,
           int n_groups, int a_lo, int match_s, int mismatch, int open_,
           int ext, int fs1, int fs2, cudaStream_t stream) {
  const int threads = W / LPT;
  const size_t shmem = sizeof(int) * 7 * (size_t)(W + 2) + 2 * (size_t)GWp;
  cudaError_t err = cudaFuncSetAttribute(wavefront_fwd_kernel<LPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shmem);
  if (err != cudaSuccess) return (int)err;
  wavefront_fwd_kernel<LPT><<<B, threads, shmem, stream>>>(
      par, db, zq, zr, hatn, lcv, lci, B, W, Wcap, GWp, n_groups, a_lo,
      match_s, mismatch, open_, ext, fs1, fs2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wavefront_fwd_launch(const int* par, const int* db,
                                    const int8_t* zq, const int8_t* zr,
                                    int* hatn, int* lcv, int* lci, int B,
                                    int W, int Wcap, int GWp, int n_groups,
                                    int a_lo, int match_s, int mismatch,
                                    int open_, int ext, int fs1, int fs2,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W % 128 != 0 || W < 128 || W > 2048 || B <= 0 || n_groups <= 0 ||
      Wcap < W || GWp < W + G)
    return (int)cudaErrorInvalidValue;
  if (W <= 512)
    return launch<1>(par, db, zq, zr, hatn, lcv, lci, B, W, Wcap, GWp,
                     n_groups, a_lo, match_s, mismatch, open_, ext, fs1, fs2,
                     st);
  if (W <= 1024)
    return launch<2>(par, db, zq, zr, hatn, lcv, lci, B, W, Wcap, GWp,
                     n_groups, a_lo, match_s, mismatch, open_, ext, fs1, fs2,
                     st);
  return launch<4>(par, db, zq, zr, hatn, lcv, lci, B, W, Wcap, GWp,
                   n_groups, a_lo, match_s, mismatch, open_, ext, fs1, fs2,
                   st);
}
