// Full-matrix Gotoh DP over a padded batch of pairs: the short pairs of
// bridging, consensus and polish (ops/dispatch.batch_align sends a pair
// here when its bucketed cells are <= settings.MAX_FULL_DP_CELLS).
//
// Replaces: unicycler_tpu/ops/pairwise.py:_align_single, the lax.scan over
// rows at :167 that align_batch_device (:198) vmaps over the batch. It is a
// JAX device program, not a Pallas kernel. Plain twin:
// ops/pairwise.align_batch_plain. This kernel reproduces _align_single
// exactly: the scores, the end cells (the corner, then row n_act's first
// maximum, then column m_act's first maximum with row 0 first, each taken
// only when strictly larger) and the moves bytes (bits 0-1 the H source
// DIAG 0 / E 1 / F 2, bit 2 E-extend, bit 3 F-extend; (B, n_pad, m_pad + 1)
// uint8, which native/cigar_decode.cpp and decode_traceback read), for every
// AlignConfig and with or without the diagonal band lower <= i - j <= upper.
//
// The n_act contract: a pair's block stops after its row n_act and computes
// columns 0 .. m_act only. The score and ends do not depend on later rows or
// columns (row n_act and column m_act are captured on the way, and a cell
// depends only on cells above and to its left), and every walk starts at
// end_i <= n_act, end_j <= m_act and only decreases, so moves rows >= n_act
// and columns > m_act are left unwritten (unspecified). A pair with n_act 0
// writes its ends from row 0 and exits.
//
// What bounds it on an H100: latency of the row chain. Row i needs row
// i - 1, and the horizontal gap E is a prefix maximum across the row. The
// bytes (one byte of moves a cell) and the operations are far below the
// card's rates. A call holds about 12 pairs (a 1,300 bp repeat's consensus),
// one block each, so 12 of the 132 SMs are busy. Spreading a pair over a
// cluster of blocks, as csrc/tape_fwd.cu does, is later work.
//
// Design (simple): one block per pair, PER = 4 contiguous columns a thread,
// up to 1024 threads; a row wider than 4 * threads runs in sweeps from left
// to right. The previous row's H and F (8 bytes a column) live in dynamic
// shared memory while the padded row fits (SMEM_COLS), else in a global
// scratch (L2-resident); a thread reads and writes its own four columns
// with one 16-byte access each, in place. E is the prefix identity of the
// JAX docstring (unicycler_tpu/ops/pairwise.py:12-17):
//   E(j) = max_{k<j} c(k) + j * ext,  c(k) = G(k) + open - (k + 1) * ext,
// with G = max(diagonal, F). A sweep has two block barriers:
//   (A) F, the diagonal, G and c of the thread's columns and their serial
//       maximum (also without the last column); a shuffle scan inside the
//       warp, the warp's totals to shared memory;
//   (B) after the first barrier, the prefix of the warps to the left (one
//       __reduce_max_sync), then E, H, the band mask, the extension bits
//       and the moves byte of each column; H and F written back, the
//       sweep's carries (c prefix, the old H and the E of its last column)
//       published for the next sweep; the second barrier.
// E of the column left of a thread's first column (for its extension bit)
// comes in closed form from the prefix without that column. Row n_act's
// first maximum is kept by each thread over its columns and reduced at the
// end; column m_act's running first maximum and the corner stay in the
// thread that owns column m_act. Nothing is allocated here: the wrapper
// passes the outputs and the scratch.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 30);
constexpr int NEG_HALF = -(1 << 29);  // NEG // 2
constexpr int NEG_BAND = 1 << 28;     // the unbanded diagonal bound
constexpr unsigned FULL = 0xffffffffu;
constexpr int PER = 4;                // columns a thread in a sweep
constexpr int MAXT = 1024;            // threads a block at most
constexpr int MAXW = MAXT / 32;
// H and F in shared memory up to this many columns (m_pad + 1 rounded up
// to 4): 2 * 4 bytes a column, 229,376 bytes of the H100's 232,448 a
// block; ops/pairwise.SMEM_COLS mirrors it
constexpr int SMEM_COLS = 28672;

struct Args {
  const int8_t* q;      // (B, n_pad)
  const int8_t* r;      // (B, m_pad)
  const int* n_acts;    // (B,)
  const int* m_acts;    // (B,)
  const int* lower;     // (B,) or null: -NEG_BAND
  const int* upper;     // (B,) or null: NEG_BAND
  uint8_t* moves;       // (B, n_pad, m_pad + 1) or null
  int* score;
  int* end_i;
  int* end_j;
  int* scratch;         // (B, 2 * m1r) or null: H and F in shared memory
  int n_pad, m_pad, m1r, match_s, mismatch, open_, ext, fs1, fs2, fe1, fe2;
};

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

__global__ void __launch_bounds__(MAXT) pairwise_fwd(Args a) {
  __shared__ int wtot[MAXW], wtotx[MAXW];  // a warp's max of c, and without its last column
  __shared__ int carry[3];                 // into the next sweep: c prefix, old H, E
  __shared__ int red_v[MAXW], red_i[MAXW];
  __shared__ int fin[3];                   // corner, column m_act's best and its row
  extern __shared__ int4 dyn[];

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int SW = blockDim.x * PER;  // columns a sweep
  int* H = a.scratch ? a.scratch + (size_t)b * 2 * a.m1r : reinterpret_cast<int*>(dyn);
  int* F = H + a.m1r;
  const int8_t* qb = a.q + (size_t)b * a.n_pad;
  const int8_t* rb = a.r + (size_t)b * a.m_pad;
  const int n_act = min(max(a.n_acts[b], 0), a.n_pad);
  const int m_act = min(max(a.m_acts[b], 0), a.m_pad);
  const int lo = a.lower ? a.lower[b] : -NEG_BAND;
  const int up = a.upper ? a.upper[b] : NEG_BAND;
  const int open_ = a.open_, ext = a.ext;
  const int n_sweeps = m_act / SW + 1;
  const size_t m1 = (size_t)a.m_pad + 1;

  int rv = INT_MIN, rj = INT_MAX;     // row n_act's first maximum over this thread's columns
  int corner = NEG, cv = NEG, ci = 0;  // the owner of column m_act: H(n_act, m_act), column best

  // row 0
  for (int s = 0; s < n_sweeps; ++s) {
    const int j0 = s * SW + tid * PER;
    if (j0 > m_act) break;
    int h[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = j0 + k;
      int h0 = a.fs2 ? 0 : (j > 0 ? open_ + (j - 1) * ext : 0);
      if (!(-j >= lo && -j <= up)) h0 = NEG;
      h[k] = h0;
      if (j <= m_act) {
        if (n_act == 0 && h0 > rv) {
          rv = h0;
          rj = j;
        }
        if (j == m_act) {
          cv = h0;
          if (n_act == 0) corner = h0;
        }
      }
    }
    reinterpret_cast<int4*>(H + j0)[0] = make_int4(h[0], h[1], h[2], h[3]);
    reinterpret_cast<int4*>(F + j0)[0] = make_int4(NEG, NEG, NEG, NEG);
  }
  __syncthreads();

  for (int i = 1; i <= n_act; ++i) {
    const int qi = qb[i - 1];
    const int hb = a.fs1 ? 0 : open_ + (i - 1) * ext;  // column 0
    uint8_t* mrow = a.moves ? a.moves + ((size_t)b * a.n_pad + i - 1) * m1 : nullptr;
    for (int s = 0; s < n_sweeps; ++s) {
      // carries from the sweep to the left (none into sweep 0)
      const int cc = s ? carry[0] : NEG;
      const int chl = s ? carry[1] : NEG;
      const int ce = s ? carry[2] : NEG;
      const int j0 = s * SW + tid * PER;
      const bool act = j0 <= m_act;
      int hp[PER], fp[PER];
      if (act) {
        const int4 hv = reinterpret_cast<const int4*>(H + j0)[0];
        const int4 fv = reinterpret_cast<const int4*>(F + j0)[0];
        hp[0] = hv.x, hp[1] = hv.y, hp[2] = hv.z, hp[3] = hv.w;
        fp[0] = fv.x, fp[1] = fv.y, fp[2] = fv.z, fp[3] = fv.w;
      } else {
#pragma unroll
        for (int k = 0; k < PER; ++k) hp[k] = fp[k] = NEG;
      }
      // the previous row's H at column j0 - 1
      int hl = __shfl_up_sync(FULL, hp[PER - 1], 1);
      if (lane == 0) hl = tid == 0 ? chl : (act ? H[j0 - 1] : NEG);

      // (A) F, the diagonal, G and c; the thread's serial maximum of c
      int f[PER], g[PER], dg[PER], c[PER];
      unsigned fbits = 0;
      int run = NEG, runx = NEG;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = j0 + k;
        const int fe = fp[k] + ext;
        f[k] = max(hp[k] + open_, fe);
        if (f[k] == fe && fp[k] > NEG_HALF) fbits |= 1u << k;
        if (j == 0) {
          dg[k] = hb;
          g[k] = hb;
        } else {
          const int hleft = k == 0 ? hl : hp[k - 1];
          const int rj1 = j <= m_act ? (int)rb[j - 1] : -1;
          dg[k] = hleft + (rj1 == qi ? a.match_s : a.mismatch);
          g[k] = max(dg[k], f[k]);
        }
        c[k] = j <= m_act ? g[k] + open_ - (j + 1) * ext : NEG;
        if (k == PER - 1) runx = run;
        run = max(run, c[k]);
      }
      int incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl = max(incl, v);
      }
      int excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = NEG;
      if (lane == 31) {
        wtot[warp] = incl;
        wtotx[warp] = max(excl, runx);
      }
      __syncthreads();

      // (B) the prefix of the warps to the left: of all their columns (pw),
      // and without the last column of the warp just left (pwx)
      const int pw = __reduce_max_sync(FULL, lane < warp ? wtot[lane] : NEG);
      const int pwx = __reduce_max_sync(
          FULL, lane < warp - 1 ? wtot[lane] : (lane == warp - 1 ? wtotx[lane] : NEG));
      const int excl_l = __shfl_up_sync(FULL, excl, 1);
      const int runx_l = __shfl_up_sync(FULL, runx, 1);
      int P = max(cc, max(pw, excl));  // max of c over the columns < j0
      // E of column j0 - 1, band-masked (its extension bit's predecessor)
      int ep;
      if (tid == 0) {
        ep = ce;
      } else {
        const int px = lane == 0 ? max(cc, pwx) : max(max(cc, pw), max(excl_l, runx_l));
        const int jl = j0 - 1;
        ep = (jl >= 1 && i - jl >= lo && i - jl <= up) ? px + jl * ext : NEG;
      }
      int hn[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = j0 + k;
        int e = j == 0 ? NEG : P + j * ext;
        P = max(P, c[k]);
        int h = j == 0 ? hb : max(g[k], e);
        if (!(i - j >= lo && i - j <= up)) {
          h = NEG;
          e = NEG;
          f[k] = NEG;
        }
        const bool eb = e == ep + ext && ep > NEG_HALF;
        const int src = h == dg[k] ? 0 : (h == e ? 1 : 2);
        ep = e;
        hn[k] = h;
        if (j <= m_act) {
          if (mrow) mrow[j] = (uint8_t)(src | (eb ? 4 : 0) | ((fbits >> k) & 1u ? 8 : 0));
          if (i == n_act && h > rv) {
            rv = h;
            rj = j;
          }
          if (j == m_act) {
            if (h > cv) {
              cv = h;
              ci = i;
            }
            if (i == n_act) corner = h;
          }
        }
      }
      if (act) {
        reinterpret_cast<int4*>(H + j0)[0] = make_int4(hn[0], hn[1], hn[2], hn[3]);
        reinterpret_cast<int4*>(F + j0)[0] = make_int4(f[0], f[1], f[2], f[3]);
      }
      if (tid == blockDim.x - 1 && s + 1 < n_sweeps) {
        carry[0] = P;
        carry[1] = hp[PER - 1];
        carry[2] = ep;
      }
      __syncthreads();
    }
  }

  // the end cell in _align_single's order
  if (tid == (m_act % SW) / PER) {
    fin[0] = corner;
    fin[1] = cv;
    fin[2] = ci;
  }
  block_first_max(rv, rj, red_v, red_i);
  if (tid == 0) {
    int best = fin[0], ei = n_act, ej = m_act;
    if (a.fe2 && rv > best) {
      best = rv;
      ej = rj;
    }
    if (a.fe1 && fin[1] > best) {
      best = fin[1];
      ei = fin[2];
      ej = m_act;
    }
    a.score[b] = best;
    a.end_i[b] = ei;
    a.end_j[b] = ej;
  }
}

}  // namespace

// One block per pair on `stream`. lower / upper may be null (unbanded);
// moves null skips the moves; scratch ((B, 2 * m1r) int32, m1r = m_pad + 1
// rounded up to 4) is needed when m1r > SMEM_COLS and ignored otherwise.
// Returns a cudaError_t.
extern "C" int pairwise_launch(const int8_t* q, const int8_t* r, const int* n_acts,
                               const int* m_acts, const int* lower, const int* upper,
                               uint8_t* moves, int* score, int* end_i, int* end_j,
                               int* scratch, int B, int n_pad, int m_pad, int match_s,
                               int mismatch, int open_, int ext, int fs1, int fs2, int fe1,
                               int fe2, void* stream) {
  if (B <= 0 || n_pad < 0 || m_pad < 0 || open_ > ext) return (int)cudaErrorInvalidValue;
  const int m1r = (m_pad + 1 + PER - 1) / PER * PER;
  const bool in_smem = m1r <= SMEM_COLS;
  if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  Args a{q, r, n_acts, m_acts, lower, upper, moves, score, end_i, end_j,
         in_smem ? nullptr : scratch, n_pad, m_pad, m1r, match_s, mismatch, open_, ext,
         fs1, fs2, fe1, fe2};
  const int cols = (m_pad + 1 + PER - 1) / PER;
  const int threads = cols >= MAXT ? MAXT : (cols + 31) / 32 * 32;
  const size_t shmem = in_smem ? sizeof(int) * 2 * (size_t)m1r : 0;
  cudaError_t err = cudaFuncSetAttribute(pairwise_fwd,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  pairwise_fwd<<<B, threads, shmem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
