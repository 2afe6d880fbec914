// Bucketed per-task banded Gotoh DP along a per-row corridor c[i].
//
// Replaces: unicycler_tpu/ops/pallas_banded.py:_make_kernel (entry
// pallas_banded_batch), whose plain twin is the XLA scan
// unicycler_tpu/ops/banded.py:_banded_single. This kernel reproduces
// _banded_single exactly: scores, end cells (first-maximum tie order) and
// the 4-bit moves in nibble-plane layout (word w of a row holds lanes
// w + g * W/8 in nibble g), which native/cigar_decode.cpp decodes.
//
// What bounds it on an H100: latency of the row chain. Row i needs row
// i-1, and within a row the horizontal gap state E is a prefix maximum
// across all W lanes, so a row costs a block-wide scan and three block
// barriers. Only the band-escape retries run it, a few tasks at a time.
//
// Design: one block per task, W/LPT threads with LPT contiguous lanes each
// (so the E scan is a serial pass over a thread's lanes, then a warp scan
// with shuffles, then a pass over the per-warp totals in shared memory).
// H and F of the previous row sit in shared memory, double buffered; the
// moves of a row are staged as bytes in shared memory and packed into
// nibble-plane words by W/8 threads. End selection runs on thread 0 after
// the row loop, in the order of _banded_single.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int NEG = -(1 << 30);
constexpr int NEG_HALF = -(1 << 29);

template <int LPT>
__global__ void __launch_bounds__(512) banded_kernel(
    const int8_t* __restrict__ q, int n_pad, const int8_t* __restrict__ r_ext, int RL,
    const int* __restrict__ c_all, const int* __restrict__ n_acts,
    const int* __restrict__ m_acts, int* __restrict__ moves,
    int* __restrict__ score_out, int* __restrict__ ei_out, int* __restrict__ ej_out,
    int W, int match_s, int mismatch, int open_, int ext,
    int fs1, int fs2, int fe1, int fe2) {
  extern __shared__ int smem[];
  __shared__ int wtot[32];
  __shared__ int best_lc[2];          // running best last-column (value, row)
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane32 = tid & 31, warp = tid >> 5;
  const int8_t* qb = q + (size_t)b * n_pad;
  const int8_t* rb = r_ext + (size_t)b * RL;
  const int* c = c_all + (size_t)b * (n_pad + 1);
  const int n_act = n_acts[b], m_act = m_acts[b];
  int* Hbuf = smem;                 // [2][W]
  int* Fbuf = Hbuf + 2 * W;         // [2][W]
  int* E = Fbuf + 2 * W;            // [W]
  int* HN = E + W;                  // H of row n_act
  int* H0 = HN + W;                 // row 0
  uint8_t* MV = reinterpret_cast<uint8_t*>(H0 + W);
  const int w8 = W / 8;

  const int c0 = c[0];
#pragma unroll
  for (int s = 0; s < LPT; ++s) {
    const int k = tid * LPT + s;
    const int j0 = c0 + k;
    int h0;
    if (fs2) h0 = j0 >= 0 ? 0 : NEG;
    else h0 = j0 > 0 ? open_ + (j0 - 1) * ext : (j0 == 0 ? 0 : NEG);
    if (j0 > m_act) h0 = NEG;
    Hbuf[k] = h0;
    Fbuf[k] = NEG;
    H0[k] = h0;
    HN[k] = n_act == 0 ? h0 : NEG;
  }
  __syncthreads();
  if (tid == 0) {
    const int k0 = m_act - c0;
    best_lc[0] = (k0 >= 0 && k0 < W) ? H0[k0] : NEG;
    best_lc[1] = 0;
  }
  int cur = 0;

  for (int i = 1; i <= n_pad; ++i) {
    const int ci = c[i];
    const int si = ci - c[i - 1];
    const int qi = qb[i - 1];
    const int* Hp = Hbuf + cur * W;
    const int* Fp = Fbuf + cur * W;
    int* Hn = Hbuf + (1 - cur) * W;
    int* Fn = Fbuf + (1 - cur) * W;
    const int col0 = fs1 ? 0 : open_ + (i - 1) * ext;

    int dg[LPT], gv[LPT], fv[LPT], incl[LPT];
    bool fext[LPT];
    int run = INT_MIN;
#pragma unroll
    for (int s = 0; s < LPT; ++s) {
      const int k = tid * LPT + s;
      const int ku = k + si;
      const int h_up = ku < W ? Hp[ku] : NEG;
      const int f_up = ku < W ? Fp[ku] : NEG;
      const int kd = ku - 1;
      const int h_diag = (kd >= 0 && kd < W) ? Hp[kd] : NEG;
      const int f = max(h_up + open_, f_up + ext);
      fext[s] = (f == f_up + ext) && (f_up > NEG_HALF);
      fv[s] = f;
      const int j = ci + k;
      const int rw = rb[ci + W - 1 + k];
      const int sub = qi == rw ? match_s : mismatch;
      int d = (j >= 1 && j <= m_act) ? h_diag + sub : NEG;
      if (j == 0) d = col0;
      dg[s] = d;
      const int g = max(d, j >= 1 ? f : NEG);
      gv[s] = g;
      run = max(run, g + open_ - (k + 1) * ext);
      incl[s] = run;
    }
    // exclusive prefix max of cvec across the block
    int v = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, v, o);
      if (lane32 >= o) v = max(v, n);
    }
    int ex_w = __shfl_up_sync(0xffffffffu, v, 1);
    if (lane32 == 0) ex_w = INT_MIN;
    if (lane32 == 31) wtot[warp] = v;
    __syncthreads();
    int base = ex_w;
    for (int w = 0; w < warp; ++w) base = max(base, wtot[w]);
    int ev[LPT];
#pragma unroll
    for (int s = 0; s < LPT; ++s) {
      const int k = tid * LPT + s;
      const int j = ci + k;
      int ex = s == 0 ? base : max(base, incl[s - 1]);
      if (k == 0) ex = NEG;
      int e = ex + k * ext;
      e = j >= 1 ? e : NEG;
      e = e < NEG_HALF ? NEG : e;
      ev[s] = e;
      E[k] = e;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < LPT; ++s) {
      const int k = tid * LPT + s;
      const int j = ci + k;
      const int e = ev[s];
      const int e_prev = k > 0 ? E[k - 1] : NEG;
      const bool eext = (e == e_prev + ext) && (e_prev > NEG_HALF);
      int h = max(gv[s], e);
      h = (j >= 0 && j <= m_act) ? h : NEG;
      const int hsrc = h == dg[s] ? 0 : (h == e ? 1 : 2);
      MV[k] = (uint8_t)(hsrc | (eext ? 4 : 0) | (fext[s] ? 8 : 0));
      Hn[k] = h;
      Fn[k] = fv[s];
      if (i == n_act) HN[k] = h;
      if (k == m_act - ci && i <= n_act && h > best_lc[0]) {
        best_lc[0] = h;
        best_lc[1] = i;
      }
    }
    if (tid == 0) {
      const int kl = m_act - ci;
      if (!(kl >= 0 && kl < W && i <= n_act) && NEG > best_lc[0]) {
        best_lc[0] = NEG;
        best_lc[1] = i;
      }
    }
    __syncthreads();
    if (moves != nullptr) {
      for (int w = tid; w < w8; w += blockDim.x) {
        unsigned word = 0u;
#pragma unroll
        for (int gq = 0; gq < 8; ++gq) word |= (unsigned)MV[gq * w8 + w] << (4 * gq);
        reinterpret_cast<unsigned*>(moves)[((size_t)b * n_pad + (i - 1)) * w8 + w] = word;
      }
    }
    cur = 1 - cur;
  }
  __syncthreads();

  if (tid == 0) {
    const int c_n = c[n_act];
    const int kc = m_act - c_n;
    int best = (kc >= 0 && kc < W) ? HN[kc] : NEG;
    int ei = n_act, ej = m_act;
    if (fe2) {
      int kb = 0, sv = INT_MIN;
      for (int k = 0; k < W; ++k) {
        const int val = (c_n + k <= m_act) ? HN[k] : NEG;
        if (val > sv) { sv = val; kb = k; }
      }
      if (sv > best) ej = c_n + kb;
      best = max(best, sv);
    }
    if (fe1) {
      const int sv = best_lc[0];
      if (sv > best) { ei = best_lc[1]; ej = m_act; }
      best = max(best, sv);
    }
    score_out[b] = best;
    ei_out[b] = ei;
    ej_out[b] = ej;
  }
}

template <int LPT>
int launch(const int8_t* q, int n_pad, const int8_t* r_ext, int RL, const int* c,
           const int* n_acts, const int* m_acts, int* moves, int* score,
           int* end_i, int* end_j, int B, int W, int match_s, int mismatch,
           int open_, int ext, int fs1, int fs2, int fe1, int fe2,
           cudaStream_t stream) {
  const int threads = W / LPT;
  const size_t shmem = sizeof(int) * 7 * (size_t)W + (size_t)W;
  cudaError_t err = cudaFuncSetAttribute(banded_kernel<LPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shmem);
  if (err != cudaSuccess) return (int)err;
  banded_kernel<LPT><<<B, threads, shmem, stream>>>(
      q, n_pad, r_ext, RL, c, n_acts, m_acts, moves, score, end_i, end_j, W,
      match_s, mismatch, open_, ext, fs1, fs2, fe1, fe2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int banded_launch(const int8_t* q, int n_pad, const int8_t* r_ext,
                             int RL, const int* c, const int* n_acts,
                             const int* m_acts, int* moves, int* score,
                             int* end_i, int* end_j, int B, int W,
                             int match_s, int mismatch, int open_, int ext,
                             int fs1, int fs2, int fe1, int fe2,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W % 128 != 0 || W < 128 || W > 2048 || B <= 0)
    return (int)cudaErrorInvalidValue;
  if (W <= 512)
    return launch<1>(q, n_pad, r_ext, RL, c, n_acts, m_acts, moves, score,
                     end_i, end_j, B, W, match_s, mismatch, open_, ext, fs1,
                     fs2, fe1, fe2, st);
  if (W <= 1024)
    return launch<2>(q, n_pad, r_ext, RL, c, n_acts, m_acts, moves, score,
                     end_i, end_j, B, W, match_s, mismatch, open_, ext, fs1,
                     fs2, fe1, fe2, st);
  return launch<4>(q, n_pad, r_ext, RL, c, n_acts, m_acts, moves, score,
                   end_i, end_j, B, W, match_s, mismatch, open_, ext, fs1,
                   fs2, fe1, fe2, st);
}
