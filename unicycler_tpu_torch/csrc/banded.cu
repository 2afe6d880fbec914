// Bucketed per-task banded Gotoh DP along a per-row corridor c[i]: the
// band-escape retry kernel.
//
// Replaces: unicycler_tpu/ops/pallas_banded.py:_make_kernel (entry
// pallas_banded_batch), whose plain twin is the XLA scan
// unicycler_tpu/ops/banded.py:_banded_single. This kernel reproduces
// _banded_single exactly: scores, end cells (first-maximum tie order) and
// the 4-bit moves in nibble-plane layout (word w of a row holds band lanes
// w + g * W/8 in nibble g), which native/cigar_decode.cpp and
// csrc/banded_walk.cu decode. Row i covers columns [c[i], c[i] + W); like
// the TPU kernel it takes corridors whose rows drift right by 0..MAX_SHIFT
// columns (ops/banded.build_corridor caps them so; the wrapper checks).
//
// The n_act contract: a task's block stops after its row n_act. The score
// and ends do not depend on later rows (H is taken at row n_act, the last
// column only for rows <= n_act), and every walk starts at end_i <= n_act,
// so moves rows at and past n_act are left unwritten (unspecified); a slot
// with n_act 0 writes its ends and exits.
//
// What bounds it on an H100: latency of the row chain. Row i needs row
// i - 1, and the horizontal gap E is a prefix maximum across the row. The
// bytes (half a byte of moves a cell) and the operations are far below the
// card's rates; a retry launch holds a few tasks, a block each.
//
// Design for W <= 4096 (banded_fast): one block per task, PER contiguous
// lanes a thread, H and F of the previous row in registers. Rows come in
// groups of G = 32 that share one frame of W + 128 lanes (lane k is column
// c[first row of the group - 1] + k), in which row i's band is the window
// [d_i, d_i + W), d_i <= 32 * MAX_SHIFT: a lane's vertical neighbour is
// the same lane and its diagonal neighbour the lane to its left, so
// registers and one shuffle carry the row, and values outside a row's
// window are held at NEG, as the TPU kernel reads outside its band. The
// frame moves once a group (the carries realign through shared memory). A
// row has ONE block barrier:
//   (A) F, the diagonal, G and the E candidates of the thread's lanes and
//       their serial max; the warp's total (and its total without its
//       last lane) by __reduce_max_sync to shared memory. The diagonal of
//       a warp's first lane needs the previous row's H of the lane to its
//       left, which the warp to its left owns: that warp computes the
//       candidate and publishes it. A warp whose lanes all lie inside
//       the band with 1 <= j <= m_act takes a path without masks;
//   (B) after the barrier, the shuffle scan inside the warp and, beside
//       it, the prefixes of the warps to the left (two more reductions);
//   (C) E, H, the extension bits and the move nibble of each lane in one
//       branch-free pass. E's extension bit at a thread's first lane needs
//       E of the lane to its left: a shuffle of the left thread's last E
//       (computed from its prefix in closed form), at a warp edge the same
//       closed form from the totals without the warp's last lane.
// The moves of a group's rows are staged as bytes in shared memory and
// packed into nibble-plane words and stored, 32 rows at a time, at the
// next group's start; the next group's row scalars and bases are loaded
// a group ahead. The end cell is chosen by block reductions (largest
// value, then first index) in _banded_single's order. What is left is
// latency: a row is one dependent chain of ~300 instructions
// (tools/retry_profile.py gives its cycles by phase).
//
// Design for W > 4096 (banded_wide, simple): one block of 512 threads per
// task, the previous row's H and F and the row's G, diagonal, E prefixes
// and move bytes in a global scratch (L2-resident); elementwise passes
// with neighbouring threads on neighbouring lanes (coalesced), and E by a
// scan of each warp's segment of lanes; five block barriers a row.
//
// Ties keep the TPU order (h == diag, then h == e); the extension bits need
// their predecessor above NEG/2; E is clamped to NEG below NEG/2.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 30);
constexpr int NEG_HALF = -(1 << 29);
constexpr unsigned FULL = 0xffffffffu;
constexpr int G = 32;                 // rows a group: one frame, one moves flush
constexpr int MAX_SHIFT = 4;          // c[i] - c[i - 1] in [0, MAX_SHIFT]
constexpr int SLACK = G * MAX_SHIFT;  // frame lanes beyond the band
constexpr int MAXT = 576;             // threads a block at most (113 registers each)
constexpr int MAXW = 32;              // warps a block at most
constexpr int FAST_MAX_W = 4096;
constexpr int WT = 512;               // threads a block of the wide kernel
constexpr int WIDE_SCRATCH = 10;      // ints of scratch a lane of the wide kernel

struct Args {
  const int8_t* q;       // (B, n_pad)
  const int8_t* r_ext;   // (B, RL): column j's base at j + W - 1
  const int* c;          // (B, n_pad + 1)
  const int* n_acts;
  const int* m_acts;
  int* moves;            // (B, n_pad, W/8) or null
  int* score;
  int* end_i;
  int* end_j;
  int* scratch;          // wide kernel: (B, WIDE_SCRATCH * W)
  int n_pad, RL, W, match_s, mismatch, open_, ext, fs1, fs2, fe1, fe2;
};

__device__ __forceinline__ int h0_of(int j, int m_act, const Args& a) {
  int h0;
  if (a.fs2)
    h0 = j >= 0 ? 0 : NEG;
  else
    h0 = j > 0 ? a.open_ + (j - 1) * a.ext : (j == 0 ? 0 : NEG);
  return j > m_act ? NEG : h0;
}

__device__ __forceinline__ int base_at(const int8_t* rb, int idx, int RL) {
  return (idx >= 0 && idx < RL) ? (int)rb[idx] : 0x7FFF;
}

// (value, index) merge: the larger value, then the smaller index
__device__ __forceinline__ void first_max(int& v, int& ix, int ov, int oi) {
  if (ov > v || (ov == v && oi < ix)) {
    v = ov;
    ix = oi;
  }
}

// first_max over the block; the result is thread 0's
__device__ void block_first_max(int& v, int& ix, int* red_v, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    first_max(v, ix, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, ix, o));
  __syncthreads();
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = ix;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < nw ? red_v[lane] : INT_MIN;
    ix = lane < nw ? red_i[lane] : INT_MAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      first_max(v, ix, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, ix, o));
  }
}

// End selection in _banded_single's order: the corner (n_act, m_act), then
// with free_end_s2 the first maximum of row n_act (HN, by band lane), then
// with free_end_s1 the running best of the last column (bv at row bi, each
// thread's, merged largest value then earliest row, row 0 included).
__device__ void end_select(const Args& a, int b, const int* HN, int bv, int bi, int n_act,
                           int m_act, int c_n, int* red_v, int* red_i) {
  __syncthreads();  // HN complete
  int sv = INT_MIN, sk = INT_MAX;
  for (int k = threadIdx.x; k < a.W; k += blockDim.x)
    first_max(sv, sk, c_n + k <= m_act ? HN[k] : NEG, k);
  block_first_max(sv, sk, red_v, red_i);
  block_first_max(bv, bi, red_v, red_i);
  if (threadIdx.x == 0) {
    const int kc = m_act - c_n;
    int best = (kc >= 0 && kc < a.W) ? HN[kc] : NEG;
    int ei = n_act, ej = m_act;
    if (a.fe2) {
      if (sv > best) ej = c_n + sk;
      best = max(best, sv);
    }
    if (a.fe1) {
      if (bv > best) {
        ei = bi;
        ej = m_act;
      }
      best = max(best, bv);
    }
    a.score[b] = best;
    a.end_i[b] = ei;
    a.end_j[b] = ej;
  }
}

// pack staged move bytes (MV: nrows rows of W bytes, by band lane) into
// nibble-plane words of moves rows row0 .. row0 + nrows - 1
__device__ __forceinline__ void pack_rows(const Args& a, int b, const uint8_t* MV, int row0,
                                          int nrows) {
  const int w8 = a.W / 8;
  unsigned* out = reinterpret_cast<unsigned*>(a.moves) + ((size_t)b * a.n_pad + row0) * w8;
  // x = rr * w8 + w, stepped by blockDim.x without a division a word
  const int drr = blockDim.x / w8, dw = blockDim.x - drr * w8;
  int rr = threadIdx.x / w8, w = threadIdx.x - rr * w8;
  for (int x = threadIdx.x; x < nrows * w8; x += blockDim.x) {
    const uint8_t* src = MV + (size_t)rr * a.W + w;
    unsigned word = 0u;
#pragma unroll
    for (int gq = 0; gq < 8; ++gq) word |= (unsigned)src[gq * w8] << (4 * gq);
    out[(size_t)rr * w8 + w] = word;
    rr += drr;
    w += dw;
    if (w >= w8) {
      w -= w8;
      ++rr;
    }
  }
}

__host__ __device__ __forceinline__ size_t fast_smem(int W) {
  return sizeof(int) * (2 * (size_t)(W + SLACK) + W) + (size_t)G * W;
}

// Pass A of a row over a thread's lanes: F, the diagonal, G and the E
// candidates; returns the thread's running maxima. EDGE = false is the
// interior case (every lane in the band window with 1 <= j <= m_act),
// where the masks are constants.
template <int PER, bool EDGE>
__device__ __forceinline__ void pass_a(int (&h)[PER], int (&f)[PER], int (&gv)[PER],
                                       int (&dgv)[PER], unsigned& fx, int& run, int& runx,
                                       int& fb, int prev, const unsigned (&regp)[(PER + 3) / 4],
                                       int qi, int k0, int d, int base, int m_act, int col0,
                                       bool defer, const Args& a) {
  const int W = a.W, open_ = a.open_, ext = a.ext;
  fx = 0u;
  run = NEG;
  runx = NEG;
  fb = 0;
#pragma unroll
  for (int s = 0; s < PER; ++s) {
    const int k = k0 + s;
    const int j = base + k;
    const bool inw = !EDGE || (k >= d && k < d + W);
    const bool j1 = !EDGE || (inw && j >= 1);
    const bool vdg = !EDGE || (j1 && j <= m_act);
    const int fe = f[s] + ext;
    const int fnew = max(h[s] + open_, fe);
    if (inw && fnew == fe && f[s] > NEG_HALF) fx |= 1u << s;
    f[s] = inw ? fnew : NEG;
    const int sub =
        (int)((regp[s >> 2] >> (8 * (s & 3))) & 0xFFu) == qi ? a.match_s : a.mismatch;
    int dg = vdg ? prev + sub : NEG;
    if (EDGE && inw && j == 0) dg = col0;
    if (s == 0 && defer) {  // the left warp publishes this diagonal's candidate
      fb = sub;
      if (vdg) dg = NEG;
    }
    prev = h[s];
    const int gg = max(dg, j1 ? fnew : NEG);
    dgv[s] = dg;
    gv[s] = gg;
    const int cand = inw ? gg + open_ - (k + 1) * ext : NEG;
    run = max(run, cand);
    if (s < PER - 1) runx = max(runx, cand);
  }
}

// Pass C of a row: E, H and the move nibbles (to the group's staging row)
// of the thread's lanes, from the exclusive prefix `pre` at its first lane
// and E of the lane left of it (ep). Branch-free, so the compiler can
// interleave the lanes; the captures of row n_act and of the last column
// follow it.
template <int PER, bool EDGE>
__device__ __forceinline__ void pass_c(int (&h)[PER], const int (&f)[PER], int (&gv)[PER],
                                       int (&dgv)[PER], unsigned fx, int pre, int ep, int hdef,
                                       int fb, int k0, int d, int base, int m_act, bool defer,
                                       uint8_t* mvr, const Args& a) {
  const int W = a.W, open_ = a.open_, ext = a.ext;
#pragma unroll
  for (int s = 0; s < PER; ++s) {
    const int k = k0 + s;
    const int j = base + k;
    const bool inw = !EDGE || (k >= d && k < d + W);
    const bool j1 = !EDGE || (inw && j >= 1);
    const bool vh = !EDGE || (inw && j >= 0 && j <= m_act);
    if (s == 0 && defer && (!EDGE || (j1 && j <= m_act))) {
      // the deferred diagonal, now whole
      dgv[0] = hdef + fb;
      gv[0] = max(dgv[0], f[0]);
    }
    int ev = pre + k * ext;
    ev = (j1 && ev >= NEG_HALF) ? ev : NEG;
    pre = inw ? max(pre, gv[s] + open_ - (k + 1) * ext) : pre;
    const int hn = vh ? max(gv[s], ev) : NEG;
    const bool eext = ev == ep + ext && ep > NEG_HALF;
    const int m4 = (hn == dgv[s] ? 0 : (hn == ev ? 1 : 2)) | (eext ? 4 : 0) |
                   (((fx >> s) & 1u) ? 8 : 0);
    if (inw) mvr[k - d] = (uint8_t)m4;
    ep = ev;
    h[s] = hn;
  }
}

template <int PER>
__global__ void __launch_bounds__(MAXT) banded_fast(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // per-warp values of a row, double-buffered by row parity
  __shared__ int wtot[2][MAXW], wxl[2][MAXW], wdef[2][MAXW], hedge[2][MAXW];
  __shared__ int cs[G + 1];  // the group's c[i - 1 .. i + 31]
  __shared__ int qs[G];
  __shared__ int red_v[MAXW], red_i[MAXW];
  const int b = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int W = a.W, FW = W + SLACK;
  const int open_ = a.open_, ext = a.ext;
  int* shb = reinterpret_cast<int*>(smem);   // 2 * FW: carries for the realignment
  int* HN = shb + 2 * FW;                    // W: H of row n_act, by band lane
  uint8_t* MV = reinterpret_cast<uint8_t*>(HN + W);  // G rows of W move bytes
  const int8_t* qb = a.q + (size_t)b * a.n_pad;
  const int8_t* rb = a.r_ext + (size_t)b * a.RL;
  const int* cb = a.c + (size_t)b * (a.n_pad + 1);
  const int n_act = min(a.n_acts[b], a.n_pad), m_act = a.m_acts[b];
  const int k0 = tid * PER;  // the thread's first frame lane
  // a warp's first lane defers its diagonal (the warp to its left owns it)
  const bool defer = lane == 0 && warp > 0;

  int h[PER], f[PER], gv[PER], dgv[PER];
  unsigned regp[(PER + 3) / 4];  // the lanes' reference bases, four a word
  int bnext[PER];                // ... of the next group, loaded a group ahead
  int rbase = 0, rnext;          // the base of the lane right of the thread's
  // the next group's row scalars: c and q of its row tid (tid < G), and
  // thread 0 also c of its row G
  int c_next = 0, q_next = 0, c_last = 0;
  int base = cb[0];              // the frame's lane 0 column
  int bv = NEG, bi = 0;          // the thread's running best last column
#pragma unroll
  for (int s = 0; s < PER; ++s) {
    const int k = k0 + s;
    h[s] = k < W ? h0_of(base + k, m_act, a) : NEG;
    f[s] = NEG;
    if (k < W) {
      HN[k] = h[s];
      if (base + k == m_act) bv = h[s];
    }
  }
  // the first group's scalars and bases
  if (tid < G) {
    c_next = cb[min(tid, a.n_pad)];
    q_next = qb[min(tid, a.n_pad - 1)];
  }
  if (tid == 0) c_last = cb[min(G, a.n_pad)];
#pragma unroll
  for (int s = 0; s < PER; ++s) bnext[s] = base_at(rb, base + k0 + s + W - 1, a.RL);
  rnext = base_at(rb, base + k0 + PER + W - 1, a.RL);

  for (int i = 1; i <= n_act; ++i) {
    const int r = (i - 1) & (G - 1);
    if (r == 0) {
      // a new group: flush the last group's moves, move the frame to
      // c[i - 1], take the group's row scalars and the lanes' bases, and
      // load the next group's
      __syncthreads();
      const int g = (i - 1) / G;
      if (g > 0) {
#pragma unroll
        for (int s = 0; s < PER; ++s)
          if (k0 + s < FW) {
            shb[k0 + s] = h[s];
            shb[FW + k0 + s] = f[s];
          }
        if (a.moves) pack_rows(a, b, MV, i - 1 - G, G);
      }
      if (tid < G) {
        cs[tid] = c_next;
        qs[tid] = q_next;
      }
      if (tid == 0) cs[G] = c_last;
      __syncthreads();
      const int nb = cs[0];
      if (g > 0) {
        const int adv = nb - base;
#pragma unroll
        for (int s = 0; s < PER; ++s) {
          const int src = k0 + s + adv;
          const bool in = src >= 0 && src < FW;
          h[s] = in ? shb[src] : NEG;
          f[s] = in ? shb[FW + src] : NEG;
        }
      }
      base = nb;
#pragma unroll
      for (int x = 0; x < (PER + 3) / 4; ++x) regp[x] = 0u;
#pragma unroll
      for (int s = 0; s < PER; ++s) regp[s >> 2] |= (unsigned)(bnext[s] & 0xFF) << (8 * (s & 3));
      rbase = rnext & 0xFF;
      if (lane == 31) hedge[(i - 1) & 1][warp] = h[PER - 1];
      if (tid < G) {
        c_next = cb[min(i - 1 + G + tid, a.n_pad)];
        q_next = qb[min(i - 1 + G + tid, a.n_pad - 1)];
      }
      if (tid == 0) c_last = cb[min(i - 1 + 2 * G, a.n_pad)];
      const int nbase = cs[G];
#pragma unroll
      for (int s = 0; s < PER; ++s) bnext[s] = base_at(rb, nbase + k0 + s + W - 1, a.RL);
      rnext = base_at(rb, nbase + k0 + PER + W - 1, a.RL);
    }
    const int pb = i & 1, he = (i - 1) & 1;
    const int d = cs[r + 1] - base;  // the row's band starts at frame lane d
    const int qi = qs[r] & 0xFF;
    const int col0 = a.fs1 ? 0 : open_ + (i - 1) * ext;
    // every lane of the warp in the window, with 1 <= j <= m_act
    const bool interior = __all_sync(FULL, k0 >= d && k0 + PER <= d + W && base + k0 >= 1 &&
                                               base + k0 + PER - 1 <= m_act);

    // (A) F, diagonal, G and the E candidates; the warp's maxima
    const int hleft = __shfl_up_sync(FULL, h[PER - 1], 1);
    if (lane == 31 && warp + 1 < nwarps) {
      // the next warp's deferred diagonal candidate, from this thread's
      // last H of the previous row
      const int kr = k0 + PER, jr = base + kr;
      const bool vdr = kr >= d && kr < d + W && jr >= 1 && jr <= m_act;
      wdef[pb][warp + 1] = vdr ? h[PER - 1] + (rbase == qi ? a.match_s : a.mismatch) + open_ -
                                     (kr + 1) * ext
                               : NEG;
    }
    unsigned fx;
    int run, runx, fb;
    if (interior)
      pass_a<PER, false>(h, f, gv, dgv, fx, run, runx, fb, lane > 0 ? hleft : NEG, regp, qi,
                         k0, d, base, m_act, col0, defer, a);
    else
      pass_a<PER, true>(h, f, gv, dgv, fx, run, runx, fb, lane > 0 ? hleft : NEG, regp, qi,
                        k0, d, base, m_act, col0, defer, a);
    // the warp's total, and its total without its last lane
    const int tot = __reduce_max_sync(FULL, run);
    const int xtot = __reduce_max_sync(FULL, lane == 31 ? runx : run);
    if (lane == 0) {
      wtot[pb][warp] = tot;
      wxl[pb][warp] = xtot;
    }
    __syncthreads();

    // the scan inside the warp, and (B) the scan over the warps, each
    // warp's deferred first lane included
    int incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl = max(incl, v);
    }
    int excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = NEG;
    int wi = NEG;
    if (lane < nwarps) wi = max(wtot[pb][lane], lane > 0 ? wdef[pb][lane] : NEG);
    // the prefix of the warps left of this one, and of those left of the
    // warp to its left; the deferred candidates of this warp and of that
    // one, and that one's total without its last lane
    const int offw = __reduce_max_sync(FULL, lane < warp ? wi : NEG);
    const int offp = __reduce_max_sync(FULL, lane < warp - 1 ? wi : NEG);
    const int Dme = warp > 0 ? wdef[pb][warp] : NEG;
    const int Dp = warp > 1 ? wdef[pb][warp - 1] : NEG;
    const int Xp = warp > 0 ? wxl[pb][warp - 1] : NEG;

    // (C) the exclusive prefix at this thread's first lane; E of the lane
    // left of it, in closed form
    int pre = max(offw, excl);
    if (lane > 0) pre = max(pre, Dme);
    int ep;
    {
      int lpre = max(pre, runx);
      if (PER > 1 && defer) lpre = max(lpre, Dme);
      const int kl = k0 + PER - 1;
      const int eL = lpre + kl * ext;
      const bool j1l = kl >= d && kl < d + W && base + kl >= 1;
      ep = __shfl_up_sync(FULL, (j1l && eL >= NEG_HALF) ? eL : NEG, 1);
    }
    if (lane == 0) {
      ep = NEG;
      if (warp > 0) {
        const int kp = k0 - 1;
        const int e = max(max(offp, Dp), Xp) + kp * ext;
        ep = (kp >= d && kp < d + W && base + kp >= 1 && e >= NEG_HALF) ? e : NEG;
      }
    }
    const int hdef = defer ? hedge[he][warp - 1] : NEG;
    uint8_t* mvr = MV + (size_t)r * W;
    if (interior)
      pass_c<PER, false>(h, f, gv, dgv, fx, pre, ep, hdef, fb, k0, d, base, m_act, defer, mvr, a);
    else
      pass_c<PER, true>(h, f, gv, dgv, fx, pre, ep, hdef, fb, k0, d, base, m_act, defer, mvr, a);
    if (lane == 31) hedge[pb][warp] = h[PER - 1];
    // the captures: H of row n_act, and the last column's H (one lane)
    if (i == n_act) {
#pragma unroll
      for (int s = 0; s < PER; ++s)
        if (k0 + s >= d && k0 + s < d + W) HN[k0 + s - d] = h[s];
    }
    const int km = m_act - base - k0;
    if (km >= 0 && km < PER && k0 + km >= d && k0 + km < d + W) {
      int v = h[0];
#pragma unroll
      for (int s = 1; s < PER; ++s)
        if (s == km) v = h[s];
      if (v > bv) {
        bv = v;
        bi = i;
      }
    }
  }

  __syncthreads();
  if (a.moves && n_act > 0) {
    const int row0 = (n_act - 1) / G * G;
    pack_rows(a, b, MV, row0, n_act - row0);
  }
  end_select(a, b, HN, bv, bi, n_act, m_act, cb[n_act], red_v, red_i);
}

// The E scan of the wide kernels, by warp segments: warp w scans the
// candidates cand(k) of lanes [w S, (w + 1) S) (S a multiple of 32), 32
// lanes a step with a shuffle scan and a carry, and writes each lane's
// exclusive prefix inside the segment to ex[k] (NEG at the segment's
// start); returns the segment's total.
template <typename Cand>
__device__ __forceinline__ int segment_scan(int n, int S, int* ex, Cand cand) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = NEG;
  const int k1 = min((warp + 1) * S, n);
  for (int k0 = warp * S; k0 < k1; k0 += 32) {
    const int k = k0 + lane;
    int incl = k < k1 ? cand(k) : NEG;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl = max(incl, v);
    }
    int excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = NEG;
    if (k < k1) ex[k] = max(carry, excl);
    carry = max(carry, __shfl_sync(FULL, incl, 31));
  }
  return carry;
}

// after segment_scan: off[w] = the prefix of the segments left of warp
// w's, from their totals (one per warp, in tot); the caller syncs after
__device__ __forceinline__ void segment_offsets(const int* tot, int* off) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  if (threadIdx.x >= 32) return;
  int v = lane < nw ? tot[lane] : NEG;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v = max(v, x);
  }
  const int ex = __shfl_up_sync(FULL, v, 1);
  if (lane < nw) off[lane] = lane == 0 ? NEG : ex;
}

__global__ void __launch_bounds__(WT) banded_wide(Args a) {
  __shared__ int segtot[WT / 32], segoff[WT / 32], red_v[WT / 32], red_i[WT / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int W = a.W, w8 = W / 8;
  const int open_ = a.open_, ext = a.ext;
  int* Hb = a.scratch + (size_t)b * WIDE_SCRATCH * W;  // [2][W]
  int* Fb = Hb + 2 * W;                                 // [2][W]
  int* Gv = Fb + 2 * W;                                 // G = max(diag, F)
  int* Dv = Gv + W;                                     // the diagonal term
  int* Ev = Dv + W;                                     // E's prefix in its segment
  int* HN = Ev + W;                                     // H of row n_act
  uint8_t* MVb = reinterpret_cast<uint8_t*>(HN + W);    // the row's move bytes
  const int8_t* qb = a.q + (size_t)b * a.n_pad;
  const int8_t* rb = a.r_ext + (size_t)b * a.RL;
  const int* cb = a.c + (size_t)b * (a.n_pad + 1);
  const int n_act = min(a.n_acts[b], a.n_pad), m_act = a.m_acts[b];
  // lanes k = tid + x * WT in the elementwise passes; segments of S lanes
  // a warp in the scan
  const int S = (W / (WT / 32) + 31) / 32 * 32;

  const int c0 = cb[0];
  int bv = NEG, bi = 0;
  for (int k = tid; k < W; k += WT) {
    const int h0 = h0_of(c0 + k, m_act, a);
    Hb[k] = h0;
    Fb[k] = NEG;
    HN[k] = h0;
    if (c0 + k == m_act) bv = h0;
  }
  __syncthreads();
  int cur = 0;
  for (int i = 1; i <= n_act; ++i) {
    const int ci = cb[i];
    const int si = ci - cb[i - 1];
    const int qi = qb[i - 1];
    const int col0 = a.fs1 ? 0 : open_ + (i - 1) * ext;
    const int* Hp = Hb + cur * W;
    const int* Fp = Fb + cur * W;
    int* Hn = Hb + (1 - cur) * W;
    int* Fn = Fb + (1 - cur) * W;
    for (int k = tid; k < W; k += WT) {
      const int ku = k + si, kd = ku - 1;
      const int h_up = (ku >= 0 && ku < W) ? Hp[ku] : NEG;
      const int f_up = (ku >= 0 && ku < W) ? Fp[ku] : NEG;
      const int h_diag = (kd >= 0 && kd < W) ? Hp[kd] : NEG;
      const int fe = f_up + ext;
      const int fnew = max(h_up + open_, fe);
      const int j = ci + k;
      const int sub = base_at(rb, ci + W - 1 + k, a.RL) == qi ? a.match_s : a.mismatch;
      int dg = (j >= 1 && j <= m_act) ? h_diag + sub : NEG;
      if (j == 0) dg = col0;
      Fn[k] = fnew;
      Gv[k] = max(dg, j >= 1 ? fnew : NEG);
      Dv[k] = dg;
      MVb[k] = (fnew == fe && f_up > NEG_HALF) ? 8 : 0;
    }
    __syncthreads();
    const int tot = segment_scan(W, S, Ev, [&](int k) { return Gv[k] + open_ - (k + 1) * ext; });
    if ((tid & 31) == 0) segtot[tid >> 5] = tot;
    __syncthreads();
    segment_offsets(segtot, segoff);
    __syncthreads();
    for (int k = tid; k < W; k += WT) {
      // E of lane k and of lane k - 1, from the prefix of their segments
      const int j = ci + k;
      int e = max(segoff[k / S], Ev[k]) + k * ext;
      e = (j >= 1 && e >= NEG_HALF) ? e : NEG;
      int ep = NEG;
      if (k > 0) {
        ep = max(segoff[(k - 1) / S], Ev[k - 1]) + (k - 1) * ext;
        ep = (j - 1 >= 1 && ep >= NEG_HALF) ? ep : NEG;
      }
      const int hn = (j >= 0 && j <= m_act) ? max(Gv[k], e) : NEG;
      const bool eext = e == ep + ext && ep > NEG_HALF;
      MVb[k] |= (uint8_t)((hn == Dv[k] ? 0 : (hn == e ? 1 : 2)) | (eext ? 4 : 0));
      Hn[k] = hn;
      if (i == n_act) HN[k] = hn;
      if (j == m_act && hn > bv) {
        bv = hn;
        bi = i;
      }
    }
    __syncthreads();
    if (a.moves) {
      unsigned* out = reinterpret_cast<unsigned*>(a.moves) + ((size_t)b * a.n_pad + i - 1) * w8;
      for (int w = tid; w < w8; w += WT) {
        unsigned word = 0u;
#pragma unroll
        for (int gq = 0; gq < 8; ++gq) word |= (unsigned)MVb[gq * w8 + w] << (4 * gq);
        out[w] = word;
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  end_select(a, b, HN, bv, bi, n_act, m_act, cb[n_act], red_v, red_i);
}

template <int PER>
int launch_fast(const Args& a, int B, cudaStream_t stream) {
  const int threads = ((a.W + SLACK + PER - 1) / PER + 31) / 32 * 32;
  if (threads > MAXT) return (int)cudaErrorInvalidValue;
  const size_t shmem = fast_smem(a.W);
  cudaError_t err = cudaFuncSetAttribute(banded_fast<PER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  banded_fast<PER><<<B, threads, shmem, stream>>>(a);
  return (int)cudaGetLastError();
}

// lanes a thread of the fast kernel at band W (0: the wide kernel)
int default_lanes(int W) {
  if (W > FAST_MAX_W) return 0;
  if (W <= 1024) return 2;
  if (W <= 2048) return 4;
  return 8;
}

}  // namespace

// lanes: lanes a thread of the fast kernel (2, 4 or 8), 0 for the
// default; ignored above W = 4096, where the wide kernel runs with
// `scratch` ((B, 10 W) int32). Returns a cudaError_t.
extern "C" int banded_launch(const int8_t* q, int n_pad, const int8_t* r_ext,
                             int RL, const int* c, const int* n_acts,
                             const int* m_acts, int* moves, int* score,
                             int* end_i, int* end_j, int* scratch, int B,
                             int W, int match_s, int mismatch, int open_,
                             int ext, int fs1, int fs2, int fe1, int fe2,
                             int lanes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W % 128 != 0 || W < 128 || B <= 0 || n_pad <= 0 || RL < 2 * W)
    return (int)cudaErrorInvalidValue;
  Args a{q, r_ext, c, n_acts, m_acts, moves, score, end_i, end_j, scratch,
         n_pad, RL, W, match_s, mismatch, open_, ext, fs1, fs2, fe1, fe2};
  if (W > FAST_MAX_W) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    banded_wide<<<B, WT, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  switch (lanes ? lanes : default_lanes(W)) {
    case 2: return launch_fast<2>(a, B, st);
    case 4: return launch_fast<4>(a, B, st);
    case 8: return launch_fast<8>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
