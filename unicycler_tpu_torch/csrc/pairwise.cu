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
// uint8, which csrc/pairwise_walk.cu, native/cigar_decode.cpp and
// decode_traceback read), for every AlignConfig and with or without the
// diagonal band lower <= i - j <= upper.
//
// The n_act contract: a pair computes rows 1 .. n_act and columns
// 0 .. m_act only. The score and ends do not depend on later rows or
// columns (a cell depends only on cells above and to its left), and every
// walk starts at end_i <= n_act, end_j <= m_act and only decreases, so
// moves rows >= n_act and columns > m_act are left unwritten (unspecified).
//
// What bounds it on an H100: the latency of the DP's dependency chain. The
// bytes (one byte of moves a cell) and the operations (~45 a cell) are far
// below the card's rates; a call holds ~12 pairs (a 1,300 bp repeat's
// consensus), so what sets the time is how many dependent steps a pair
// takes and what each costs. A row-serial order (the JAX scan) makes every
// row a chain of its own: E is a prefix maximum across the row, so each
// row pays a scan and block barriers.
//
// Design: row strips, columns in time. Each thread owns a strip of R
// consecutive rows and takes a block of KC = 4 columns a step, left to
// right; thread t runs one block behind thread t - 1, so the pair is an
// anti-diagonal pipeline of about m_act / 4 + n_act / R steps of 4R cells,
// with no block barrier a step. The four columns of a row are independent
// but for E, so a step has the instruction-level parallelism that one warp
// a scheduler needs (a cell a step, tried first, ran ~900 ns a step). Per
// row a thread keeps in registers H, G and E of the column left of its
// block, so E is a register recurrence, E(j) = max(E(j - 1) + ext,
// G(j - 1) + open), over the UNMASKED values, with the band mask applied
// after: the identity of the JAX docstring (unicycler_tpu/ops/
// pairwise.py:12-17), where E is a prefix maximum over G = max(diag, F)
// before the mask, so E carries a real F from the column left of a band
// into it. The strip's bottom row hands H and F of its block to the next
// thread: inside a warp by __shfl_up_sync; from a warp's last lane to the
// next warp's first through a ring of tagged 8-byte (block, value) words
// in the consumer's shared memory, which the consumer polls (spinning: a
// sleep is longer than a step), and whose free slots it reports back every
// PROG_EVERY blocks. Between the blocks of a cluster (C = 1, 2, 4 or 8
// blocks a pair, on neighbouring SMs) the same ring is written through
// distributed shared memory, as csrc/tape_fwd.cu's mailboxes are: no
// cluster barrier a step (one costs ~750 ns). A cluster holds C * threads
// * R rows (a stripe, at most MAX_STRIPE_ROWS); taller pairs run in turns
// of stripes, the bottom row's H and F passing through a global scratch
// (double-buffered by stripe), with one cluster barrier a stripe. R, the
// block and the cluster size follow n_pad (pairwise_plan; a caller may
// force another through pairwise_launch_plan). The first warp of a stripe
// takes its input (row 0's boundary or the scratch) 32 blocks at a time,
// one block a lane, loaded a window ahead. The reference is staged in
// shared memory shifted by one column, so a block's four bases are one
// aligned word (up to SMEM_COLS bases); each thread loads its rows' query
// bases once a stripe.
//
// Moves: the buffer's rows are m_pad + 1 bytes rounded up to 16 (the
// wrapper returns the (B, n_pad, m_pad + 1) view), so every aligned
// 16-byte group lies in one row. A row's four bytes of a step go into a
// word of its group in registers, and the group leaves by one predicated
// 16-byte store at its fourth block or the row's last (bytes past m_act
// are unspecified).
//
// The step has no branch a lane takes alone: every lane computes (idle
// lanes on a clamped block, their results unused), every lane reads the
// input slot (one broadcast, read at the end of the step before), lane
// 31's hand-off and the moves are predicated stores, and the shuffles to
// the next lane go first after the cells. One warp a scheduler leaves no
// other warp to hide a stall, so the lane index and the shared-memory
// addresses are pinned in registers (the compiler re-read them from
// special registers every step). tools/full_dp_profile.py measures the
// step's phases in cycles.
//
// End cells: as the JAX scan keeps h_at_n and lastcol, the warp that holds
// row n_act stores that row's H, and each lane stores its rows' H at
// column m_act when it reaches its last block, into a small scratch (two
// variants of the step carry these stores, so the others carry none);
// after the last stripe's cluster barrier the first block takes their
// first maxima, row 0's value first, and writes the end cell in
// _align_single's order. Nothing is allocated here: the wrapper passes
// the outputs and the scratches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

// tools/full_dp_profile.py builds this file with -DPAIRWISE_PROF: lane 0 of
// warps 0 and 1 of the first block of pair 0 add up clock64() cycles
// between the marks of a step; otherwise the marks are empty
#ifdef PAIRWISE_PROF
__device__ long long g_prof[2][8];
#define PROF_INIT long long pa[8] = {0}, pl = 0;
#define PROF_ON (lane == 0 && blockIdx.x == 0 && warp < 2)
#define PROF_START if (PROF_ON) pl = clock64();
#define PROF(i)                   \
  if (PROF_ON) {                  \
    const long long c_ = clock64(); \
    pa[i] += c_ - pl;             \
    pl = c_;                      \
  }
#define PROF_SAVE \
  if (PROF_ON)    \
    for (int x = 0; x < 8; ++x) g_prof[warp][x] = pa[x];
#else
#define PROF_INIT
#define PROF_START
#define PROF(i)
#define PROF_SAVE
#endif

namespace {

// a branch the warp rarely takes: its body goes out of line, so the step's
// common path falls through (a taken branch costs a step tens of cycles
// when one warp a scheduler has nothing to hide it behind)
#define RARELY(c) __builtin_expect(!!(c), 0)

constexpr int NEG = -(1 << 30);
constexpr int NEG_HALF = -(1 << 29);  // NEG // 2
constexpr int NEG_BAND = 1 << 28;     // the unbanded diagonal bound
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAXT = 256;             // threads a block at most
constexpr int MAXW = MAXT / 32;
constexpr int MAXC = 8;               // blocks a cluster at most
constexpr int RMAX = 4;               // rows a thread at most
constexpr int KC = 4;                 // columns a thread takes a step
// rows a stripe at most; ops/pairwise.MAX_STRIPE_ROWS mirrors it (the
// wrapper passes a scratch above it)
constexpr int MAX_STRIPE_ROWS = MAXC * MAXT * RMAX;
// reference bases staged in shared memory up to this many (m_pad + 4
// rounded up to 16); ops/pairwise.SMEM_COLS mirrors it. Wider references
// are read from device memory.
constexpr int SMEM_COLS = 163840;
constexpr int K = 64;           // ring slots (column blocks) between two warps
constexpr int PROG_EVERY = 8;   // a consumer reports its progress this often
constexpr int SPINS = 256;      // polls before a waiting thread sleeps
constexpr unsigned long long EMPTY = ~0ull;

// one column block of a strip's bottom row: H and F of each of its KC
// columns in turn, each as (column block tag << 32) | value
struct Slot {
  unsigned long long w[2 * KC];
};

struct Ring {
  Slot s[K];
};

struct Args {
  const int8_t* q;      // (B, n_pad)
  const int8_t* r;      // (B, m_pad)
  const int* n_acts;    // (B,)
  const int* m_acts;    // (B,)
  const int* lower;     // (B,) or null: -NEG_BAND
  const int* upper;     // (B,) or null: NEG_BAND
  uint8_t* moves;       // (B, n_pad, ms) rows of ms >= m_pad + 1 bytes, or null
  int* score;
  int* end_i;
  int* end_j;
  int* scratch;         // (B, 2, 2, m4) H and F rows by stripe parity, or null
  int* caps;            // (B, cw): row n_act's H (m4 columns), then column m_act's
                        // H by row (index i)
  int n_pad, m_pad, ms, m4, cw, match_s, mismatch, open_, ext, fs1, fs2, fe1, fe2, staged;
};

// (value, index) merge: the larger value, then the smaller index
__device__ __forceinline__ void first_max(int& v, int& ix, int ov, int oi) {
  if (ov > v || (ov == v && oi < ix)) {
    v = ov;
    ix = oi;
  }
}

__device__ __forceinline__ void warp_first_max(int& v, int& ix) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    first_max(v, ix, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, ix, o));
}

// first_max of two (value, index) keys over the block; thread 0 holds the
// results
__device__ void block_first_max2(int& v, int& ix, int& w, int& wx, int* rv, int* ri, int* sv,
                                 int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  warp_first_max(v, ix);
  warp_first_max(w, wx);
  if (lane == 0) {
    rv[warp] = v;
    ri[warp] = ix;
    sv[warp] = w;
    si[warp] = wx;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < nw ? rv[lane] : INT_MIN;
    ix = lane < nw ? ri[lane] : INT_MAX;
    w = lane < nw ? sv[lane] : INT_MIN;
    wx = lane < nw ? si[lane] : INT_MAX;
    warp_first_max(v, ix);
    warp_first_max(w, wx);
  }
}

__device__ __forceinline__ unsigned long long tagged(int tag, int v) {
  return ((unsigned long long)(unsigned)tag << 32) | (unsigned)v;
}

// p's address in the shared memory of the cluster's block `rank`
__device__ __forceinline__ unsigned cluster_smem(const void* p, int rank) {
  const unsigned local = (unsigned)__cvta_generic_to_shared(p);
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

// Stores done only where `on` holds: predicated, not branches, so the warp
// neither diverges nor jumps around them. Into a block's shared memory
// they are relaxed at cluster scope: a tagged word is one aligned 8-byte
// store and needs no stronger ordering (a volatile store through a generic
// pointer compiles to a system-scope strong store).
__device__ __forceinline__ void st_cluster_if(bool on, unsigned addr, int v) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %2, 0;\n"
      "  @p st.relaxed.cluster.shared::cluster.s32 [%0], %1; }" ::"r"(addr),
      "r"(v), "r"((int)on)
      : "memory");
}

__device__ __forceinline__ void st_cluster_if(bool on, unsigned addr, unsigned long long v,
                                              unsigned long long w) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %3, 0;\n"
      "  @p st.relaxed.cluster.shared::cluster.v2.u64 [%0], {%1, %2}; }" ::"r"(addr),
      "l"(v), "l"(w), "r"((int)on)
      : "memory");
}

__device__ __forceinline__ void st_global_if(bool on, int* addr, int v) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %2, 0;\n"
      "  @p st.global.s32 [%0], %1; }" ::"l"(addr),
      "r"(v), "r"((int)on)
      : "memory");
}

__device__ __forceinline__ void st_global_v4_if(bool on, void* addr, unsigned x, unsigned y,
                                                unsigned z, unsigned w) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %5, 0;\n"
      "  @p st.global.v4.u32 [%0], {%1, %2, %3, %4}; }" ::"l"(addr),
      "r"(x), "r"(y), "r"(z), "r"(w), "r"((int)on)
      : "memory");
}

// v as an opaque value: the compiler keeps it in a register instead of
// recomputing it (it re-read the thread index and the shared window's base
// from special registers every step, tens of cycles each on the step's
// critical path)
__device__ __forceinline__ unsigned pinned(unsigned v) {
  unsigned r;
  asm volatile("mov.b32 %0, %1;" : "=r"(r) : "r"(v));
  return r;
}

__device__ __forceinline__ unsigned ld_shared_u32(unsigned addr) {
  unsigned v;
  asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// a ring slot's 16 bytes at shared address `addr`, read afresh each time
__device__ __forceinline__ void ld_slot16(unsigned addr, unsigned long long& a,
                                          unsigned long long& b) {
  asm volatile("ld.volatile.shared.v2.u64 {%0, %1}, [%2];" : "=l"(a), "=l"(b) : "r"(addr));
}

// row 0's H at column j (band-masked)
__device__ __forceinline__ int row0(int j, int lo, int up, const Args& a) {
  const int h0 = a.fs2 ? 0 : (j > 0 ? a.open_ + (j - 1) * a.ext : 0);
  return (-j >= lo && -j <= up) ? h0 : NEG;
}

template <int R, bool MV, bool BAND>
__global__ void __launch_bounds__(MAXT) pairwise_fwd(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;

  __shared__ Ring rings[MAXW];  // the input ring of each warp
  __shared__ int prog[MAXW];    // the last block tag warp w's consumer took
  __shared__ int red_v[MAXW], red_i[MAXW], red_w[MAXW], red_x[MAXW];
  // the reference shifted by one: ref_s[j] is the base of column j (j >= 1)
  extern __shared__ __align__(16) uint8_t ref_s[];

  const int tid = threadIdx.x, lane = (int)pinned(tid & 31), warp = tid >> 5,
            nw = blockDim.x >> 5;
  const int WG = C * nw;             // warps a cluster
  const int wg = rank * nw + warp;   // this warp in the cluster
  const int SR = WG * 32 * R;        // rows a stripe
  const int n_act = min(max(a.n_acts[b], 0), a.n_pad);
  const int m_act = min(max(a.m_acts[b], 0), a.m_pad);
  const int lo = a.lower ? a.lower[b] : -NEG_BAND;
  const int up = a.upper ? a.upper[b] : NEG_BAND;
  const int open_ = a.open_, ext = a.ext, ma = a.match_s, mi = a.mismatch;
  const int8_t* qb = a.q + (size_t)b * a.n_pad;
  const int8_t* rb = a.r + (size_t)b * a.m_pad;
  const long long m1 = (long long)a.m_pad + 1;

  if (n_act == 0) {  // uniform over the cluster: the ends come from row 0
    if (rank != 0) return;
    int rv = INT_MIN, rj = INT_MAX, unused = INT_MIN, unused_i = INT_MAX;
    for (int j = tid; j <= m_act; j += blockDim.x) first_max(rv, rj, row0(j, lo, up, a), j);
    block_first_max2(rv, rj, unused, unused_i, red_v, red_i, red_w, red_x);
    if (tid == 0) {
      int best = row0(m_act, lo, up, a), ej = m_act;  // the corner
      if (a.fe2 && rv > best) {
        best = rv;
        ej = rj;
      }
      // column m_act's first maximum is row 0's own value: never larger
      a.score[b] = best;
      a.end_i[b] = 0;
      a.end_j[b] = ej;
    }
    return;
  }

  if (a.staged) {
    if (tid == 0) ref_s[0] = 0xffu;
    for (int x = tid; x < m_act; x += blockDim.x) ref_s[x + 1] = (uint8_t)rb[x];
  }
  for (int x = tid; x < nw * K * 2 * KC; x += blockDim.x)
    rings[x / (K * 2 * KC)].s[(x / (2 * KC)) % K].w[x % (2 * KC)] = EMPTY;
  if (tid < nw) prog[tid] = -1;
  cluster.sync();  // rings ready before any block pushes into them

  // where this warp's bottom row goes, and where it reports its progress
  // (shared::cluster addresses)
  unsigned out_ring = 0u, in_prog = 0u;
  if (warp + 1 < nw)
    out_ring = pinned(cluster_smem(&rings[warp + 1], rank));
  else if (rank + 1 < C)
    out_ring = pinned(cluster_smem(&rings[0], rank + 1));
  if (warp > 0)
    in_prog = cluster_smem(&prog[warp - 1], rank);
  else if (rank > 0)
    in_prog = cluster_smem(&prog[nw - 1], rank - 1);

  int pc = -1;                     // my consumer's progress, as last read
  int* hrow = a.caps + (size_t)b * a.cw;  // row n_act's H by column
  int* hcol = hrow + a.m4;                // column m_act's H by row
  PROF_INIT
  const int n_str = (n_act + SR - 1) / SR;
  const int nblk = m_act / KC + 1;  // column blocks of columns 0 .. m_act
  const int kl = m_act - (nblk - 1) * KC;  // column m_act in the last block

  for (int s = 0; s < n_str; ++s) {
    const int wrow = s * SR + wg * 32 * R;  // rows above this warp
    if (wrow < n_act) {
      const int i0 = wrow + lane * R;        // my rows are i0 + 1 .. i0 + R
      const bool top = wg == 0;              // input: row 0 or the scratch
      const bool to_ring = wg + 1 < WG && wrow + 32 * R < n_act;
      const bool to_scr = wg + 1 == WG && (s + 1) * SR < n_act;
      // (a valid address where unused: its stores are predicated off)
      int* scr_out = to_scr ? a.scratch + ((size_t)b * 2 + (s & 1)) * 2 * a.m4 : hrow;
      const int* scr_in = s > 0 ? a.scratch + ((size_t)b * 2 + ((s - 1) & 1)) * 2 * a.m4 : nullptr;
      const int tag0 = s * nblk;
      const bool own_warp = n_act <= wrow + 32 * R;  // this warp holds row n_act
      int qv[R], hl[R], eu[R], gl[R], el[R];
      unsigned mw[R][4];  // a row's 16-byte group of moves, a word a block
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = i0 + r + 1;
        qv[r] = i <= n_act ? (int)qb[i - 1] : -2;
        hl[r] = eu[r] = gl[r] = el[r] = NEG;
#pragma unroll
        for (int k = 0; k < 4; ++k) mw[r][k] = 0u;
      }
      const long long row0off = ((long long)b * a.n_pad + i0) * a.ms;  // my first row's moves
      // the top warp's input (row 0 or the scratch) goes into its own
      // ring, 32 blocks at a time, one block a lane, so that every warp
      // takes its input the same way
      auto fill_window = [&](int sg0) {
        const int blk = sg0 + lane, t = tag0 + blk;
        int xh[KC], xf[KC];
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          xh[k] = NEG;
          xf[k] = NEG;
        }
        if (blk < nblk) {
          if (scr_in) {
            const int4 h4 = reinterpret_cast<const int4*>(scr_in)[blk];
            const int4 f4 = reinterpret_cast<const int4*>(scr_in + a.m4)[blk];
            xh[0] = h4.x, xh[1] = h4.y, xh[2] = h4.z, xh[3] = h4.w;
            xf[0] = f4.x, xf[1] = f4.y, xf[2] = f4.z, xf[3] = f4.w;
          } else {
#pragma unroll
            for (int k = 0; k < KC; ++k) xh[k] = row0(blk * KC + k, lo, up, a);
          }
        }
        Slot& sl = rings[warp].s[t & (K - 1)];
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          sl.w[2 * k] = tagged(t, xh[k]);
          sl.w[2 * k + 1] = tagged(t, xf[k]);
        }
        __syncwarp();
      };
      const unsigned ring_in = pinned((unsigned)__cvta_generic_to_shared(&rings[warp]));
      unsigned long long v[2 * KC];  // the input slot of the step
      auto read_slot = [&](int sg) {
        const unsigned sa = ring_in + (unsigned)(((tag0 + sg) & (K - 1)) * sizeof(Slot));
#pragma unroll
        for (int k = 0; k < KC; ++k) ld_slot16(sa + 16u * k, v[2 * k], v[2 * k + 1]);
      };
      const unsigned ref_in = pinned((unsigned)__cvta_generic_to_shared(ref_s));
      int th[KC], tf[KC];  // the row above my strip at my block's columns
#pragma unroll
      for (int k = 0; k < KC; ++k) th[k] = tf[k] = NEG;
      int thl = NEG;  // ... at the column left of my block
      const int steps = nblk + 31;
      // one step; ROWCAP (the warp that holds row n_act) and COLCAP (the
      // steps where a lane is at its last block) add the end-cell stores,
      // so that the other steps carry none of their code
      auto step = [&](const int sg, auto rowcap, auto colcap) {
        constexpr bool ROWCAP = decltype(rowcap)::value, COLCAP = decltype(colcap)::value;
        const int cb = sg - lane;  // my column block
        // lane 0's input, taken by the whole warp: every lane holds the
        // slot (one broadcast read, issued at the end of the step before),
        // so no lane waits or diverges alone; the slot is read again while
        // a tag is not yet this block's
        if (sg < nblk) {
          const int t = tag0 + sg;
          auto ok = [&]() {
            bool all = true;
#pragma unroll
            for (int k = 0; k < 2 * KC; ++k) all &= (unsigned)(v[k] >> 32) == (unsigned)t;
            return __all_sync(FULL, all);
          };
          if (RARELY(!ok())) {
            for (int spins = 0;; ++spins) {
              read_slot(sg);
              if (ok()) break;
              if (spins >= SPINS) __nanosleep(32);
            }
          }
#pragma unroll
          for (int k = 0; k < KC; ++k) {
            th[k] = lane == 0 ? (int)(unsigned)v[2 * k] : th[k];
            tf[k] = lane == 0 ? (int)(unsigned)v[2 * k + 1] : tf[k];
          }
          st_cluster_if(!top && lane == 0 &&
                            ((sg & (PROG_EVERY - 1)) == PROG_EVERY - 1 || sg == nblk - 1),
                        in_prog, t);
        }
        PROF(0)
        int hu[KC], fu[KC];
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          hu[k] = th[k];
          fu[k] = tf[k];
        }
        // every lane computes (a lane outside 0 .. nblk - 1 on a clamped
        // block, its results unused), so the warp runs the cells together;
        // only the side effects are guarded by `act`
        const bool act = (unsigned)cb < (unsigned)nblk;
        {
          const int j0 = min(max(cb, 0), nblk - 1) * KC;
          const bool first = cb == 0;  // column 0 is a boundary cell
          int hd = thl;  // H(i - 1, j0 - 1) of my first row
          thl = th[KC - 1];
          int rbase[KC];  // the bases of columns j0 .. j0 + 3
          if (a.staged) {
            const unsigned w4 = ld_shared_u32(ref_in + (unsigned)j0);
#pragma unroll
            for (int k = 0; k < KC; ++k) rbase[k] = (int)(int8_t)(w4 >> (8 * k));
          } else {
#pragma unroll
            for (int k = 0; k < KC; ++k) {
              const int j = j0 + k;
              rbase[k] = (j >= 1 && j <= m_act) ? (int)rb[j - 1] : -1;
            }
          }
          const bool last_blk = act && cb == nblk - 1;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int i = i0 + r + 1;
            const int hb = a.fs1 ? 0 : open_ + (i - 1) * ext;  // column 0
            // the cells of a row in phases, branch-free, so that the four
            // columns' independent work interleaves: F, the diagonal and G;
            // then the E chain; then H, the band, the bits
            int fn[KC], dg[KC], g[KC], e[KC];
            unsigned fb = 0u;
#pragma unroll
            for (int k = 0; k < KC; ++k) {
              const int fe = fu[k] + ext;
              fn[k] = max(hu[k] + open_, fe);
              if (MV) fb |= ((fn[k] == fe) & (fu[k] > NEG_HALF)) ? 1u << k : 0u;
              dg[k] = (k == 0 ? hd : hu[k - 1]) + (rbase[k] == qv[r] ? ma : mi);
              g[k] = max(dg[k], fn[k]);
            }
            dg[0] = first ? hb : dg[0];
            g[0] = first ? hb : g[0];
            e[0] = first ? NEG : max(eu[r] + ext, gl[r] + open_);
#pragma unroll
            for (int k = 1; k < KC; ++k) e[k] = max(e[k - 1] + ext, g[k - 1] + open_);
            eu[r] = e[KC - 1];
            gl[r] = g[KC - 1];
            int nh[KC], nf[KC];
            unsigned word = 0u;
            int ep = first ? NEG : el[r];  // the masked E of the column to the left
#pragma unroll
            for (int k = 0; k < KC; ++k) {
              int h = max(g[k], e[k]);
              if (k == 0) h = first ? hb : h;
              int em = e[k], fm = fn[k];
              if (BAND) {
                const int d = i - (j0 + k);
                const bool inb = (d >= lo) & (d <= up);
                h = inb ? h : NEG;
                em = inb ? em : NEG;
                fm = inb ? fm : NEG;
              }
              if (MV) {
                const unsigned eb = ((em == ep + ext) & (ep > NEG_HALF)) ? 4u : 0u;
                const unsigned src = h == dg[k] ? 0u : (h == em ? 1u : 2u);
                word |= (src | eb | (((fb >> k) & 1u) << 3)) << (8 * k);
              }
              ep = em;
              nh[k] = h;
              nf[k] = fm;
            }
            el[r] = ep;
            PROF(1)
            // row n_act's H and column m_act's H leave by predicated
            // stores; the first block takes their first maxima at the end
            if constexpr (ROWCAP)
              st_global_v4_if(act && i == n_act, hrow + j0, (unsigned)nh[0], (unsigned)nh[1],
                              (unsigned)nh[2], (unsigned)nh[3]);
            if constexpr (COLCAP)
              st_global_if(last_blk && i <= n_act, hcol + i,
                           kl == 0 ? nh[0] : (kl == 1 ? nh[1] : (kl == 2 ? nh[2] : nh[3])));
            PROF(2)
            if (MV) {
              // the block's word into its place in the row's group (stored
              // after the step's shuffles, below)
              const int q = cb & 3;
              mw[r][0] = q == 0 ? word : mw[r][0];
              mw[r][1] = q == 1 ? word : mw[r][1];
              mw[r][2] = q == 2 ? word : mw[r][2];
              mw[r][3] = q == 3 ? word : mw[r][3];
            }
            PROF(3)
            hd = hl[r];  // H(i, j0 - 1): the next row's diagonal at j0
            hl[r] = nh[KC - 1];
#pragma unroll
            for (int k = 0; k < KC; ++k) {
              hu[k] = nh[k];
              fu[k] = nf[k];
            }
          }
          // the bottom row to the next lane first (the step's critical
          // path), then the stores that wait on nothing after them
          PROF(4)
#pragma unroll
          for (int k = 0; k < KC; ++k) {
            th[k] = __shfl_up_sync(FULL, hu[k], 1);
            tf[k] = __shfl_up_sync(FULL, fu[k], 1);
          }
          // the strip's bottom row leaves the warp from lane 31, by
          // predicated stores; the flow control is the warp's, once every
          // PROG_EVERY blocks for the blocks up to the next check
          const int t31 = tag0 + sg - 31;
          const bool act31 = (unsigned)(sg - 31) < (unsigned)nblk;
          if (RARELY(to_ring && act31 && ((sg - 31) & (PROG_EVERY - 1)) == 0)) {
            for (int spins = 0; t31 + PROG_EVERY - 1 - K > pc; ++spins) {
              pc = *reinterpret_cast<volatile int*>(&prog[warp]);
              if (t31 + PROG_EVERY - 1 - K > pc && spins >= SPINS) __nanosleep(32);
            }
          }
          const bool push = to_ring && act31 && lane == 31;
          const unsigned w = out_ring + (unsigned)((t31 & (K - 1)) * sizeof(Slot));
#pragma unroll
          for (int k = 0; k < KC; ++k)
            st_cluster_if(push, w + 16u * k, tagged(t31, hu[k]), tagged(t31, fu[k]));
          if (RARELY(to_scr)) {  // the stripe's bottom row (the cluster's last warp)
            const bool to_s = act && lane == 31;
            st_global_v4_if(to_s, scr_out + KC * cb, (unsigned)hu[0], (unsigned)hu[1],
                            (unsigned)hu[2], (unsigned)hu[3]);
            st_global_v4_if(to_s, scr_out + a.m4 + KC * cb, (unsigned)fu[0], (unsigned)fu[1],
                            (unsigned)fu[2], (unsigned)fu[3]);
          }
          if (MV) {
            // each row's group leaves by one aligned 16-byte store at its
            // fourth block or the row's last (the bytes past m_act are
            // unspecified)
            const bool at_end = (cb & 3) == 3 || last_blk;
#pragma unroll
            for (int r = 0; r < R; ++r)
              st_global_v4_if(act && i0 + r + 1 <= n_act && at_end,
                              a.moves + row0off + (long long)r * a.ms + (j0 & ~15), mw[r][0],
                              mw[r][1], mw[r][2], mw[r][3]);
          }
        }

        // the next step's input: the top warp's window first, then its slot
        if (RARELY(top && ((sg + 1) & 31) == 0)) fill_window(sg + 1);
        read_slot(sg + 1);
        PROF(5)
      };
      // no lane is at its last block before step nblk - 1
      auto run = [&](auto rowcap) {
        int sg = 0;
        for (; sg < nblk - 1; ++sg) step(sg, rowcap, std::false_type{});
        for (; sg < steps; ++sg) step(sg, rowcap, std::true_type{});
      };
      if (top) fill_window(0);
      read_slot(0);
      PROF_START
      if (own_warp)
        run(std::true_type{});
      else
        run(std::false_type{});
    }
    cluster.sync();  // the stripe's scratch row is written
  }

  PROF_SAVE
  // the end cell, from row n_act's and column m_act's H (visible after the
  // last stripe's cluster barrier): their first maxima over the first
  // block, row 0's value first, in _align_single's order
  if (rank != 0) return;
  int rv = INT_MIN, rj = INT_MAX, cv = INT_MIN, ci = INT_MAX;
  for (int j = tid; j <= m_act; j += blockDim.x) first_max(rv, rj, __ldcg(hrow + j), j);
  for (int i = tid + 1; i <= n_act; i += blockDim.x) first_max(cv, ci, __ldcg(hcol + i), i);
  block_first_max2(cv, ci, rv, rj, red_v, red_i, red_w, red_x);
  if (tid == 0) {
    int bv = row0(m_act, lo, up, a), bi = 0;
    first_max(bv, bi, cv, ci);
    int best = __ldcg(hrow + m_act), ei = n_act, ej = m_act;  // the corner
    if (a.fe2 && rv > best) {
      best = rv;
      ej = rj;
    }
    if (a.fe1 && bv > best) {
      best = bv;
      ei = bi;
      ej = m_act;
    }
    a.score[b] = best;
    a.end_i[b] = ei;
    a.end_j[b] = ej;
  }
}

}  // namespace

// the moves buffer's row stride: m_pad + 1 bytes rounded up to 16, so that
// every 16-byte group of moves lies in one row (the wrapper returns the
// (B, n_pad, m_pad + 1) view of it); ops/pairwise.moves_stride mirrors it
static int moves_stride(int m_pad) { return (m_pad + 16) / 16 * 16; }

// R rows a thread, `threads` a block and `cluster` blocks a pair for a call
// whose longest pair has n_pad rows; ops/pairwise.full_plan mirrors it.
static void pairwise_plan(int n_pad, int* rows, int* threads, int* cluster) {
  // R = 2 from 256 rows, 4 past what one stripe of R = 2 holds (more rows
  // a step amortise its fixed cost, fewer keep enough warps for short
  // pairs; tools/full_dp_probe.py --sweep); about 128 threads of the pair
  // a block, the blocks of a cluster on SMs of their own
  const int n = n_pad > 1 ? n_pad : 1;
  const int R = n > 2 * MAXC * MAXT ? RMAX : (n >= 256 ? 2 : 1);
  const int tr = (n + R - 1) / R;  // threads the pair's rows need
  int C = 1;
  while (C < MAXC && C * 128 < tr) C *= 2;
  int T = (n + C * R - 1) / (C * R);
  T = (T + 31) / 32 * 32;
  if (T > MAXT) T = MAXT;
  *rows = R;
  *threads = T;
  *cluster = C;
}

template <int R, bool MV, bool BAND>
static int launch(const Args& a, int B, int T, int C, size_t shmem, cudaStream_t stream) {
  // the limit, not the launch's size: host threads launching at once must
  // not lower it under each other's launches
  cudaError_t err = cudaFuncSetAttribute(pairwise_fwd<R, MV, BAND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_COLS);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * C, 1, 1);
  cfg.blockDim = dim3(T, 1, 1);
  cfg.dynamicSmemBytes = shmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pairwise_fwd<R, MV, BAND>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool MV, bool BAND>
static int launch_r(const Args& a, int B, int R, int T, int C, size_t shmem, cudaStream_t s) {
  if (R == 1) return launch<1, MV, BAND>(a, B, T, C, shmem, s);
  if (R == 2) return launch<2, MV, BAND>(a, B, T, C, shmem, s);
  return launch<RMAX, MV, BAND>(a, B, T, C, shmem, s);
}

// the end-cell scratch's row: row n_act's H over m_pad + 1 columns rounded
// up to 4, then column m_act's H over rows 0 .. n_pad rounded up to 4;
// ops/pairwise.caps_width mirrors it
static int caps_width(int n_pad, int m_pad) {
  return (m_pad + KC) / KC * KC + (n_pad + 4) / 4 * 4;
}

// pairwise_launch with a given plan: R rows a thread (1, 2 or 4), T
// threads a block (a multiple of 32 up to MAXT) and C blocks a pair (1 to
// MAXC); scratch ((B, 2, 2, m4) int32, m4 = m_pad + 1 rounded up to 4) is
// needed when C * T * R < n_pad and ignored otherwise; caps is (B,
// caps_width(n_pad, m_pad)) int32.
extern "C" int pairwise_launch_plan(const int8_t* q, const int8_t* r, const int* n_acts,
                                    const int* m_acts, const int* lower, const int* upper,
                                    uint8_t* moves, int* score, int* end_i, int* end_j,
                                    int* scratch, int* caps, int B, int n_pad, int m_pad,
                                    int match_s,
                                    int mismatch, int open_, int ext, int fs1, int fs2, int fe1,
                                    int fe2, int R, int T, int C, void* stream) {
  if (B <= 0 || n_pad < 0 || m_pad < 0 || open_ > ext) return (int)cudaErrorInvalidValue;
  if ((R != 1 && R != 2 && R != RMAX) || T < 32 || T > MAXT || T % 32 || C < 1 || C > MAXC)
    return (int)cudaErrorInvalidValue;
  if (moves && ((uintptr_t)moves & 15)) return (int)cudaErrorMisalignedAddress;
  const bool stripes = (long long)C * T * R < n_pad;
  if (stripes && (scratch == nullptr || ((uintptr_t)scratch & 15)))
    return (int)cudaErrorInvalidValue;
  if (caps == nullptr || ((uintptr_t)caps & 15)) return (int)cudaErrorInvalidValue;
  const int m16 = (m_pad + KC + 15) / 16 * 16;
  const int staged = m16 <= SMEM_COLS;
  Args a{q, r, n_acts, m_acts, lower, upper, moves, score, end_i, end_j,
         stripes ? scratch : nullptr, caps, n_pad, m_pad, moves_stride(m_pad),
         (m_pad + KC) / KC * KC, caps_width(n_pad, m_pad), match_s, mismatch, open_,
         ext, fs1, fs2, fe1, fe2, staged};
  const size_t shmem = staged ? (size_t)m16 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the band's mask is compiled out where no pair has one
  const bool band = lower != nullptr || upper != nullptr;
  if (moves)
    return band ? launch_r<true, true>(a, B, R, T, C, shmem, s)
                : launch_r<true, false>(a, B, R, T, C, shmem, s);
  return band ? launch_r<false, true>(a, B, R, T, C, shmem, s)
              : launch_r<false, false>(a, B, R, T, C, shmem, s);
}

// A cluster of blocks a pair on `stream`, planned by pairwise_plan.
// lower / upper may be null (unbanded); moves null skips the moves, and is
// otherwise (B, n_pad, moves_stride(m_pad)), 16-byte aligned;
// scratch ((B, 2, 2, m4) int32) is needed when n_pad > MAX_STRIPE_ROWS and
// ignored otherwise; caps is (B, caps_width(n_pad, m_pad)) int32, 16-byte
// aligned. Returns a cudaError_t.
extern "C" int pairwise_launch(const int8_t* q, const int8_t* r, const int* n_acts,
                               const int* m_acts, const int* lower, const int* upper,
                               uint8_t* moves, int* score, int* end_i, int* end_j,
                               int* scratch, int* caps, int B, int n_pad, int m_pad, int match_s,
                               int mismatch, int open_, int ext, int fs1, int fs2, int fe1,
                               int fe2, void* stream) {
  int R, T, C;
  pairwise_plan(n_pad, &R, &T, &C);
  return pairwise_launch_plan(q, r, n_acts, m_acts, lower, upper, moves, score, end_i, end_j,
                              scratch, caps, B, n_pad, m_pad, match_s, mismatch, open_, ext,
                              fs1, fs2, fe1, fe2, R, T, C, stream);
}

#ifdef PAIRWISE_PROF
// the profile's cycles (2 warps x 8 marks) into host memory
extern "C" int pairwise_prof_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
#endif
