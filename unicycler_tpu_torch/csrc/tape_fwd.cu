// Row-tape banded Gotoh DP: the forward pass for wide bands (W > 2048).
//
// Replaces: unicycler_tpu/ops/pallas_tape.py:_make_tape_kernel (unrolled
// body, GWp <= 1024) and _make_tape_kernel_rolled (entry tape_forward).
// The two Pallas bodies are the same math; this one kernel reproduces it:
// the 4-bit moves of every row (row-packed, 8 rows a word, (B, L/8, GWp)),
// the H row captured at each task's capture row, and each group's running
// best last-column value and its row. End selection runs in torch after
// the kernel (ops/tape_kernels.tape_forward).
//
// Lane space. Each group of G = 32 rows works in a fixed region frame of
// GWp = roundup128(W + 32 * 4) lanes: lane k is reference column jr + k,
// jr constant over the group, and row i's band is the lane window
// [d_i, d_i + W) with d_i the in-group drift. Carries realign once per
// group, left by the group's advance `adv`, with NEG in the vacated tail;
// a task's first group swaps in the row-0 boundary from its formula.
//
// What bounds it on an H100: latency of the row chain. Row i needs row
// i - 1, and E (the horizontal gap) is a prefix maximum across the row, so
// every row costs a block-wide scan and two block barriers; bytes (one
// 4-bit move per cell) and operations are far below the card's rates.
// Only 8-32 tracks run, one block each, so most SMs are idle; this first
// version is kept simple on purpose.
//
// Design: one block per track, up to 1024 threads, each owning PER
// contiguous lanes whose H and F carries and region bases stay in
// registers. A row: (1) F, the diagonal and G = max(diag, F) per lane, a
// serial max over the thread's lanes, a warp scan with shuffles, warp
// totals to shared memory; barrier; (2) the exclusive prefix of each lane
// (warp totals + warp scan + serial pass) gives E, then H; the thread's
// last H and E go to shared memory for its right neighbour; barrier; (3)
// E's extension bit, the move nibble, captures. The Pallas kernel's
// windowed prefix max (max_dist = W - 1) is a full prefix max here: lanes
// left of the window are outside the band, so their candidates sit near
// NEG and E clamps them back to NEG below NEG/2 either way (the plain
// version keeps the windowed ladder; the card tests hold the two equal).
// The group realignment exchanges the carries through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 30);
constexpr int NEG_HALF = -(1 << 29);
constexpr int G = 32;
constexpr unsigned FULL = 0xffffffffu;

// per-(track, group) scalars, in ops/tape_kernels.GP_* order
enum { GP_JR, GP_M, GP_LB, GP_ADV, GP_RST, GP_C0, GP_RSTART, GP_N = 8 };

struct Params {
  const int* rowinfo;    // (B, L): d | cap << 8 | active << 9 | q << 16
  const int* gplane;     // (B, L/32, GP_N)
  const int8_t* r_flat;  // (B, M)
  int* moves;            // (B, L/8, GWp) or null
  int* hatn;             // (L/32, B, GWp), zeroed; written at capture rows
  int* best;             // (L/32, B, 2): running best last column, its row
  int B, L, M, W, GWp;
  int match_s, mismatch, open_, ext;
  int fs1, fs2;
};

__device__ __forceinline__ int boundary(int j, int m_g, int c0, const Params& p) {
  int h0;
  if (p.fs2)
    h0 = j >= 0 ? 0 : NEG;
  else
    h0 = j > 0 ? p.open_ + (j - 1) * p.ext : (j == 0 ? 0 : NEG);
  return (j <= m_g && j >= c0 && j < c0 + p.W) ? h0 : NEG;
}

template <int PER>
__device__ __forceinline__ void shift_left(int (&x)[PER], int* buf, int k0, int adv,
                                           int GWp) {
#pragma unroll
  for (int i = 0; i < PER; ++i) buf[k0 + i] = x[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int src = k0 + i + adv;
    x[i] = src < GWp ? buf[src] : NEG;
  }
  __syncthreads();
}

template <int PER>
__global__ void __launch_bounds__(1024) tape_fwd_kernel(Params p) {
  extern __shared__ int smem[];
  const int nthr = blockDim.x;
  int* buf = smem;                  // nthr * PER: realignment exchange
  int* hedge = buf + nthr * PER;    // each thread's last H
  int* eedge = hedge + nthr;        // each thread's last E
  int* wtot = eedge + nthr;         // per-warp scan totals
  int* bvbi = wtot + 32;            // running best last column, its row

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int k0 = tid * PER;
  const int GWp = p.GWp, W = p.W;
  const int open_ = p.open_, ext = p.ext;
  const int NGR = p.L / G;
  const int* gp = p.gplane + (size_t)b * NGR * GP_N;
  const int* rows = p.rowinfo + (size_t)b * p.L;
  const int8_t* rf = p.r_flat + (size_t)b * p.M;
  int* mv_out = p.moves ? p.moves + (size_t)b * (p.L / 8) * GWp : nullptr;

  int h[PER], f[PER], dg[PER], gg[PER], e[PER], mv[PER];
  int8_t reg[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    h[i] = NEG;
    f[i] = NEG;
    mv[i] = 0;
  }
  if (tid == 0) {
    bvbi[0] = NEG;
    bvbi[1] = 0;
  }

  for (int g = 0; g < NGR; ++g) {
    const int* gq = gp + (size_t)g * GP_N;
    const int jr = gq[GP_JR], m_g = gq[GP_M], lb = gq[GP_LB];
    const int adv = gq[GP_ADV], rst = gq[GP_RST], c0 = gq[GP_C0];
    const int rstart = gq[GP_RSTART];
    __syncthreads();  // the previous group's rows are done
    if (tid == 0) {
      if (g > 0) {
        p.best[((size_t)(g - 1) * p.B + b) * 2] = bvbi[0];
        p.best[((size_t)(g - 1) * p.B + b) * 2 + 1] = bvbi[1];
      }
      if (rst) {
        bvbi[0] = NEG;
        bvbi[1] = 0;
      }
    }
    if (!rst && adv > 0) {  // uniform over the block
      shift_left<PER>(h, buf, k0, adv, GWp);
      shift_left<PER>(f, buf, k0, adv, GWp);
    }
    if (rst) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        h[i] = boundary(jr + k0 + i, m_g, c0, p);
        f[i] = NEG;
      }
    }
    const int h0m1 = boundary(jr - 1, m_g, c0, p);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = k0 + i;
      reg[i] = k < GWp ? rf[rstart + k] : (int8_t)-1;
    }
    hedge[tid] = h[PER - 1];
    __syncthreads();

    for (int r = 0; r < G; ++r) {
      const int t = g * G + r;
      const int rowv = rows[t];
      const int d = rowv & 255;
      const bool cap = (rowv >> 8) & 1;
      const bool act = (rowv >> 9) & 1;
      const int qv = (rowv >> 16) & 255;
      const int local_i = lb + r;
      const int m_col = act ? m_g : -1;

      // (1) F, diagonal, G; serial max of this thread's E candidates
      int prev = tid == 0 ? ((r == 0 && rst) ? h0m1 : NEG) : hedge[tid - 1];
      unsigned long long fext = 0;
      int run = NEG;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int k = k0 + i;
        const int j = jr + k;
        const bool vb = k >= d && k < d + W;
        const bool vef = vb && j >= 1 && j <= m_col;
        const bool c0l = vb && j == 0 && m_col >= 0;
        const int fe = f[i] + ext;
        const int fnew = max(h[i] + open_, fe);
        if (fnew == fe && f[i] > NEG_HALF) fext |= 1ull << i;
        f[i] = fnew;
        const int sub = reg[i] == qv ? p.match_s : p.mismatch;
        int dgv = vef ? prev + sub : NEG;
        if (c0l) dgv = p.fs1 ? 0 : open_ + (local_i - 1) * ext;
        prev = h[i];
        dg[i] = dgv;
        gg[i] = max(dgv, vef ? fnew : NEG);
        run = max(run, gg[i] + open_ - (k + 1) * ext);
      }
      int incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl = max(incl, v);
      }
      int excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = NEG;
      if (lane == 31) wtot[warp] = incl;
      __syncthreads();

      // (2) E from the exclusive prefix max, then H
      int pre = excl;
      for (int w = 0; w < warp; ++w) pre = max(pre, wtot[w]);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int k = k0 + i;
        const int j = jr + k;
        const bool vb = k >= d && k < d + W;
        const bool vef = vb && j >= 1 && j <= m_col;
        const bool vh = vb && j >= 0 && j <= m_col;
        int ev = pre + k * ext;
        ev = (vef && ev > NEG_HALF) ? ev : NEG;
        pre = max(pre, gg[i] + open_ - (k + 1) * ext);
        e[i] = ev;
        h[i] = vh ? max(gg[i], ev) : NEG;
      }
      hedge[tid] = h[PER - 1];
      eedge[tid] = e[PER - 1];
      __syncthreads();

      // (3) E's extension bit, the move nibble, last column, capture
      int ep = tid == 0 ? NEG : eedge[tid - 1];
      const int sh = 4 * (t & 7);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int k = k0 + i;
        const int j = jr + k;
        if (mv_out) {
          const bool eext = e[i] == ep + ext && ep > NEG_HALF;
          const int hsrc = h[i] == dg[i] ? 0 : (h[i] == e[i] ? 1 : 2);
          const int m4 = hsrc | (eext ? 4 : 0) | (((fext >> i) & 1ull) ? 8 : 0);
          mv[i] = sh == 0 ? m4 : (int)((unsigned)mv[i] | ((unsigned)m4 << sh));
          if ((t & 7) == 7 && k < GWp) mv_out[(size_t)(t >> 3) * GWp + k] = mv[i];
        }
        ep = e[i];
        const bool vb = k >= d && k < d + W;
        if (vb && j == m_col && h[i] > bvbi[0]) {  // one lane per row
          bvbi[0] = h[i];
          bvbi[1] = local_i;
        }
        if (cap && k < GWp) p.hatn[((size_t)g * p.B + b) * GWp + k] = h[i];
      }
    }
  }
  __syncthreads();
  if (tid == 0 && NGR > 0) {
    p.best[((size_t)(NGR - 1) * p.B + b) * 2] = bvbi[0];
    p.best[((size_t)(NGR - 1) * p.B + b) * 2 + 1] = bvbi[1];
  }
}

template <int PER>
int launch(const Params& p, cudaStream_t stream) {
  int threads = (p.GWp + PER - 1) / PER;
  threads = ((threads + 31) / 32) * 32;
  const size_t shmem = sizeof(int) * ((size_t)threads * (PER + 2) + 32 + 2);
  cudaError_t err = cudaFuncSetAttribute(
      tape_fwd_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  tape_fwd_kernel<PER><<<p.B, threads, shmem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tape_fwd_launch(const int* rowinfo, const int* gplane,
                               const int8_t* r_flat, int M, int* moves,
                               int* hatn, int* best, int B, int L, int W,
                               int GWp, int match_s, int mismatch, int open_,
                               int ext, int fs1, int fs2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L % 32 != 0 || W < 128 || GWp < W || GWp % 128 != 0)
    return (int)cudaErrorInvalidValue;
  Params p{rowinfo, gplane, r_flat, moves, hatn, best, B, L, M, W, GWp,
           match_s, mismatch, open_, ext, fs1, fs2};
  const int per = (GWp + 1023) / 1024;
  if (per <= 1) return launch<1>(p, st);
  if (per <= 2) return launch<2>(p, st);
  if (per <= 3) return launch<3>(p, st);
  if (per <= 5) return launch<5>(p, st);
  if (per <= 9) return launch<9>(p, st);
  if (per <= 17) return launch<17>(p, st);
  if (per <= 33) return launch<33>(p, st);
  return (int)cudaErrorInvalidValue;
}
