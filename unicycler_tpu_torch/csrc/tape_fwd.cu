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
// group, left by the group's advance `adv` (at most 128 lanes), with NEG
// in the vacated tail; a task's first group swaps in the row-0 boundary.
//
// What bounds it on an H100: latency of the row chain. Row i needs row
// i - 1, and E (the horizontal gap) is a prefix maximum across the row;
// bytes (one 4-bit move per cell) and operations are far below the card's
// rates. With one task a track (ops/tape.build_row_launches) a call has
// only as many tracks as tasks, often 10-30, so one block a track leaves
// most SMs idle and each row costs one SM's latency.
//
// Design: a thread block cluster of C = 1, 2, 4 or 8 blocks per track (on
// neighbouring SMs), block `rank` owning the BL = GWp / C contiguous lanes
// [rank * BL, (rank + 1) * BL); each thread owns PER contiguous lanes whose
// H and F carries and reference bases stay in registers. A row:
//   (A) F, the diagonal, G = max(diag, F) and the E candidates per lane, a
//       serial max over the thread's lanes and a warp scan by shuffles;
//       the warp's total goes to shared memory. The diagonal of the first
//       lane of every warp (and of the block) needs the previous row's H
//       of the lane to its left, which another warp (block) owns: that
//       lane's candidate is deferred, and its substitution score
//       published instead; one block barrier;
//   (B) every warp scans the warp totals (a second shuffle scan, with the
//       deferred candidates of the warps' first lanes rebuilt from the
//       previous row's edge H), and the block pushes its total to every
//       higher rank, and its total without its last lane to rank + 1;
//   (C) each warp takes the lower ranks' totals (one rank a lane) into the
//       block's exclusive prefix, and each thread computes E, H, the
//       extension bits and the move nibble of its lanes in one pass. E's
//       extension bit at a thread's first lane needs E of the lane to its
//       left: inside a warp a shuffle of that thread's last E (computed
//       from its prefix in closed form), at a warp or block edge the same
//       closed form from the totals without the last lane. The block's
//       last H goes to rank + 1 for its next row.
// Blocks exchange a row through mailboxes in shared memory: a producer
// writes one 8-byte (row, value) word into the consumer's shared memory
// (distributed shared memory), and the consumer polls its own copy until
// the row it wants has arrived. Row values flow only from lower ranks to
// higher ones, so the blocks of a cluster run as a pipeline, each a little
// behind the rank below it, and no row waits at a cluster barrier (a
// cluster.sync() loop costs ~750 ns an iteration on an H100, against
// ~165 ns for a relaxed cluster barrier and ~113 ns for __syncthreads:
// tools/sync_bench.cu). Per-warp values are double-buffered by row parity, so a
// row holds one block barrier. A group's realignment pulls the first
// `adv` lanes of the right neighbour block's carries, which that block
// pushes as words into a halo mailbox at the end of each group, so a block
// waits only for its right neighbour there. Mailboxes hold a ring of two
// groups of rows; before a block writes a row of group g, every higher rank
// has told it that it finished group g - 2. Each block keeps its own
// running best last column; the wrapper merges the C of them. A cluster
// barrier runs only at the start and the end. Each group's 32 rowinfo
// words, its plane row (two groups ahead) and the block's region bytes are
// copied into shared memory one group ahead by cp.async. A cluster stops
// after its track's last real group (ngt): padding is not executed; moves
// and best past it stay unwritten.
//
// Exactness: the Pallas kernel's windowed prefix max (max_dist = W - 1) is
// a full prefix max here: lanes left of the window are outside the band,
// so their candidates sit near NEG and E clamps them back to NEG below
// NEG/2 either way. Ties keep the TPU order (h == diag, then h == e); the
// extension bits need their predecessor above NEG/2. The running best
// last column (one lane a row) is kept per thread and merged at each
// group's end (per block here, over the cluster in the wrapper), largest
// value first, then earliest row, which is the single-lane running
// update's result.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NEG = -(1 << 30);
constexpr int NEG_HALF = -(1 << 29);
constexpr int G = 32;
constexpr unsigned FULL = 0xffffffffu;
// threads a block at most: 128 registers a thread, so a thread's lanes and
// the row's scalars stay in registers
constexpr int MAXT = 512;
constexpr int MAXW = MAXT / 32;
constexpr int RING = 2 * G;   // rows a mailbox ring holds

// per-(track, group) scalars, in ops/tape_kernels.GP_* order
enum { GP_JR, GP_M, GP_LB, GP_ADV, GP_RST, GP_C0, GP_RSTART, GP_N = 8 };

struct Params {
  const int* rowinfo;    // (B, L): d | cap << 8 | active << 9 | q << 16
  const int* gplane;     // (B, L/32, GP_N)
  const int8_t* r_flat;  // (B, M)
  const int* ngt;        // (B,): real groups of each track
  int* moves;            // (B, L/8, GWp) or null
  int* hatn;             // (L/32, B, GWp), zeroed; written at capture rows
  int* best;             // (L/32, B, C, 2): each block's running best last
                         // column and its row (merged over C by the wrapper)
  int B, L, M, W, GWp, BL, RB;
  int match_s, mismatch, open_, ext;
  int fs1, fs2;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int boundary(int j, int m_g, int c0, const Params& p) {
  int h0;
  if (p.fs2)
    h0 = j >= 0 ? 0 : NEG;
  else
    h0 = j > 0 ? p.open_ + (j - 1) * p.ext : (j == 0 ? 0 : NEG);
  return (j <= m_g && j >= c0 && j < c0 + p.W) ? h0 : NEG;
}

// bytes of one staged region buffer: BL bytes from a start aligned down to
// 16 bytes
__host__ __device__ __forceinline__ int region_bytes(int BL) { return (BL + 30) / 16 * 16; }

__host__ __device__ __forceinline__ size_t dyn_smem(int BL) {
  return 8 * (size_t)BL + 2 * (size_t)region_bytes(BL);
}

// copy group g's rowinfo words and this block's region bytes (from the
// group's plane row gq) into one buffer of each
__device__ __forceinline__ void stage_group(const Params& p, int b, int g, const int* gq,
                                            int* rows_buf, uint8_t* reg_buf, int kb, int tid,
                                            int nthr) {
  if (tid < 8) cp_async16(rows_buf + 4 * tid, p.rowinfo + (size_t)b * p.L + (size_t)g * G + 4 * tid);
  const int8_t* rf = p.r_flat + (size_t)b * p.M;
  const int s = gq[GP_RSTART] + kb;
  const int first = s & ~15;
  const int nch = (s + p.BL - first + 15) >> 4;
  for (int c = tid; c < nch; c += nthr) cp_async16(reg_buf + 16 * c, rf + first + 16 * c);
}

// x[i] for a runtime i without indexing the register array
template <int PER>
__device__ __forceinline__ int pick(const int (&x)[PER], int i) {
  int v = x[0];
#pragma unroll
  for (int k = 1; k < PER; ++k)
    if (k == i) v = x[k];
  return v;
}

// (value, row) merge of running bests: the larger value, then the earlier row
__device__ __forceinline__ void best_merge(int& v, int& ix, int ov, int oi) {
  if (ov > v || (ov == v && oi < ix)) {
    v = ov;
    ix = oi;
  }
}

// a (row, value) word of a mailbox: the row tags the value, so a reader
// polls its own shared memory until the row it wants has arrived, and one
// 8-byte store carries both
__device__ __forceinline__ void push(unsigned long long* dst, int row, int v) {
  *reinterpret_cast<volatile unsigned long long*>(dst) =
      ((unsigned long long)(unsigned)row << 32) | (unsigned)v;
}

// a waiting thread sleeps between reads: many warps spinning on shared
// memory hold off the other blocks' stores into it
__device__ __forceinline__ int poll(const unsigned long long* src, int row) {
  unsigned long long w = *reinterpret_cast<const volatile unsigned long long*>(src);
  while ((unsigned)(w >> 32) != (unsigned)row) {
    __nanosleep(32);
    w = *reinterpret_cast<const volatile unsigned long long*>(src);
  }
  return (int)(unsigned)w;
}

// wait until a word's tag is at least `row` (tags only grow)
__device__ __forceinline__ void poll_ge(const unsigned long long* src, int row) {
  while ((int)(unsigned)(*reinterpret_cast<const volatile unsigned long long*>(src) >> 32) < row)
    __nanosleep(32);
}

template <int PER>
__global__ void __launch_bounds__(MAXT, 1) tape_fwd_kernel(Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int NGR = p.L / G;
  const int ng = min(p.ngt[b], NGR);
  if (ng <= 0) return;  // uniform over the cluster

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) int rows_s[2][G];
  __shared__ __align__(16) int gp_s[3][GP_N];
  // per-warp values of a row, double-buffered by row parity
  __shared__ int wtot[2][MAXW], wxl[2][MAXW], wfa[2][MAXW], wfb[2][MAXW], hedge[2][MAXW];
  __shared__ int wbv[MAXW], wbi[MAXW];
  // mailboxes, a ring of one word a row over two groups, from rank - 1:
  // the exclusive prefix of this block's first lane, E's prefix at rank
  // - 1's last lane, and the previous row's H of that lane; from rank + 1:
  // its first 128 lanes' H and F at the end of a group (the realignment's
  // halo) and the last group it finished
  __shared__ unsigned long long mb_p[RING], mb_x[RING], mb_h[RING];
  __shared__ unsigned long long hal_h[G * 4], hal_f[G * 4], mb_e;
  __shared__ int xo_s[2];  // the block's last lane's thread: its part of X

  const int BL = p.BL, RB = p.RB;
  int* shb = reinterpret_cast<int*>(smem);  // 2 * BL: h, f for the realignment
  uint8_t* regb = smem + 8 * (size_t)BL;     // 2 buffers of RB region bytes
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
  const int kb = rank * BL;        // the block's first region lane
  const int kl0 = tid * PER;       // the thread's first block lane
  const int k0 = kb + kl0;         // ... and region lane
  const int last_t = (BL - 1) / PER, last_i = (BL - 1) % PER;  // owner of the block's last lane
  // the first lane of every warp but the cluster's first defers its diagonal
  const bool defer = lane == 0 && (warp > 0 || rank > 0);
  const int W = p.W, GWp = p.GWp, open_ = p.open_, ext = p.ext;
  int* mv_out = p.moves ? p.moves + (size_t)b * (p.L / 8) * GWp : nullptr;
  const int* gpl = p.gplane + (size_t)b * NGR * GP_N;
  // where this block's words go: rank + 1's and rank - 1's mailboxes
  unsigned long long* nx_p = rank + 1 < C ? cluster.map_shared_rank(&mb_p[0], rank + 1) : nullptr;
  unsigned long long* nx_x = rank + 1 < C ? cluster.map_shared_rank(&mb_x[0], rank + 1) : nullptr;
  unsigned long long* pv_e = rank > 0 ? cluster.map_shared_rank(&mb_e, rank - 1) : nullptr;
  unsigned long long* nx_h = rank + 1 < C ? cluster.map_shared_rank(&mb_h[0], rank + 1) : nullptr;
  unsigned long long* pv_h = rank > 0 ? cluster.map_shared_rank(&hal_h[0], rank - 1) : nullptr;
  unsigned long long* pv_f = rank > 0 ? cluster.map_shared_rank(&hal_f[0], rank - 1) : nullptr;

  int h[PER], f[PER];
  unsigned mv[PER];
  unsigned regp[(PER + 3) / 4];  // the lanes' reference bases, four a word
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    h[i] = NEG;
    f[i] = NEG;
    mv[i] = 0u;
  }
  int bv = NEG, bi = 0;  // this thread's running best last column, its row
  // nothing has arrived (tag -1); no block pushes before all have done this
  for (int x = tid; x < RING * 3 + G * 8; x += nthr) {
    if (x < RING) mb_p[x] = ~0ull;
    else if (x < RING * 2) mb_x[x - RING] = ~0ull;
    else if (x < RING * 3) mb_h[x - RING * 2] = ~0ull;
    else if (x < RING * 3 + G * 4) hal_h[x - RING * 3] = ~0ull;
    else hal_f[x - RING * 3 - G * 4] = ~0ull;
  }
  if (tid == 0) mb_e = ~0ull;
  cluster.sync();

  // prologue: plane rows 0 and 1, then group 0's rows and region bytes
  if (tid < 2) cp_async16(gp_s[0] + 4 * tid, gpl + 4 * tid);
  if (tid >= 2 && tid < 4 && ng > 1) cp_async16(gp_s[1] + 4 * (tid - 2), gpl + GP_N + 4 * (tid - 2));
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  stage_group(p, b, 0, gp_s[0], rows_s[0], regb, kb, tid, nthr);
  cp_async_commit();

  for (int g = 0; g < ng; ++g) {
    // group g's copies have landed and the block has finished group g - 1
    // (its carries are in shb, its per-warp running bests in wbv / wbi);
    // start the copies of group g + 1 (plane row g + 2). Before this block
    // pushes a row of group g into a ring slot of group g - 2, rank + 1
    // has finished group g - 2.
    cp_async_wait_all();
    __syncthreads();
    if (g > 0 && warp == 0) {
      int v = lane < nwarps ? wbv[lane] : INT_MIN, ix = lane < nwarps ? wbi[lane] : INT_MAX;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        best_merge(v, ix, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, ix, o));
      if (lane == 0) {
        int* o = p.best + (((size_t)(g - 1) * p.B + b) * C + rank) * 2;
        o[0] = v;
        o[1] = ix;
      }
    }
    if (g > 0 && tid == 0 && pv_e) push(pv_e, g - 1, 0);  // read all of group g - 1
    if (g >= 2 && (tid == 0 || tid == last_t) && nx_p) poll_ge(&mb_e, g - 2);
    if (g + 2 < ng && tid < 2)
      cp_async16(gp_s[(g + 2) % 3] + 4 * tid, gpl + (size_t)(g + 2) * GP_N + 4 * tid);
    if (g + 1 < ng)
      stage_group(p, b, g + 1, gp_s[(g + 1) % 3], rows_s[(g + 1) & 1], regb + ((g + 1) & 1) * RB, kb,
                  tid, nthr);
    cp_async_commit();

    const int* gq = gp_s[g % 3];
    const int jr = gq[GP_JR], m_g = gq[GP_M], lb = gq[GP_LB];
    const int adv = gq[GP_ADV], rst = gq[GP_RST], c0 = gq[GP_C0];
    const int rstart = gq[GP_RSTART];
    if (!rst && adv > 0) {  // uniform over the cluster
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int kl = kl0 + i;
        if (kl >= BL) continue;
        const int src = kl + adv;  // adv <= 128 <= BL: at most the right neighbour
        if (src < BL) {
          h[i] = shb[src];
          f[i] = shb[BL + src];
        } else if (rank + 1 < C) {  // its halo, pushed at the end of group g - 1
          h[i] = poll(&hal_h[src - BL], g);
          f[i] = poll(&hal_f[src - BL], g);
        } else {
          h[i] = NEG;
          f[i] = NEG;
        }
      }
    }
    if (rst) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        h[i] = kl0 + i < BL ? boundary(jr + k0 + i, m_g, c0, p) : NEG;
        f[i] = NEG;
      }
      bv = NEG;
      bi = 0;
    }
    const int h0m1 = boundary(jr - 1, m_g, c0, p);
    const uint8_t* rb = regb + (g & 1) * RB + ((rstart + kb) & 15);
#pragma unroll
    for (int i = 0; i < (PER + 3) / 4; ++i) regp[i] = 0u;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      regp[i >> 2] |= (unsigned)(kl0 + i < BL ? rb[kl0 + i] : 0xFFu) << (8 * (i & 3));
    // the edges the first row's deferred diagonals read (row g * G is even)
    if (lane == 31) hedge[0][warp] = h[PER - 1];
    if (tid == last_t && nx_h) push(&nx_h[(g * G) % RING], g * G, pick(h, last_i));

    const int* rws = rows_s[g & 1];
    for (int r = 0; r < G; ++r) {
      const int t = g * G + r;
      const int pb = t & 1;
      const int rowv = rws[r];
      const int d = rowv & 255;
      const bool cap = (rowv >> 8) & 1;
      const bool act = (rowv >> 9) & 1;
      const int qv = (rowv >> 16) & 255;
      const int local_i = lb + r;
      const int m_col = act ? m_g : -1;

      // (A) F, diagonal, G and the E candidates; warp scan
      const int hleft = __shfl_up_sync(FULL, h[PER - 1], 1);
      int prev = lane > 0 ? hleft : ((warp == 0 && rank == 0 && r == 0 && rst) ? h0m1 : NEG);
      // per-lane bits of the row, for the second pass: F's extension, E/F
      // valid, H valid, column 0, base match
      unsigned fext = 0u, bef = 0u, bh = 0u, bc0 = 0u, bmt = 0u;
      int run = NEG, runx = NEG, runl = NEG;
      int fa = 0, fb = 0;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int k = k0 + i;
        const int j = jr + k;
        const bool own = kl0 + i < BL;
        const bool vb = own && k >= d && k < d + W;
        const bool vef = vb && j >= 1 && j <= m_col;
        const bool c0l = vb && j == 0 && m_col >= 0;
        const bool mt = (int)((regp[i >> 2] >> (8 * (i & 3))) & 0xFFu) == qv;
        bef |= (unsigned)vef << i;
        bh |= (unsigned)(vb && j >= 0 && j <= m_col) << i;
        bc0 |= (unsigned)c0l << i;
        bmt |= (unsigned)mt << i;
        const int fe = f[i] + ext;
        const int fnew = max(h[i] + open_, fe);
        if (fnew == fe && f[i] > NEG_HALF) fext |= 1u << i;
        f[i] = fnew;
        const int sub = mt ? p.match_s : p.mismatch;
        int dgv = vef ? prev + sub : NEG;
        if (c0l) dgv = p.fs1 ? 0 : open_ + (local_i - 1) * ext;
        if (i == 0 && defer) {
          fa = vef;
          fb = sub;
          if (vef) dgv = NEG;
        }
        prev = h[i];
        const int cand = own ? max(dgv, vef ? fnew : NEG) + open_ - (k + 1) * ext : NEG;
        run = max(run, cand);
        if (i < PER - 1) runx = max(runx, cand);
        if (i < last_i) runl = max(runl, cand);
      }
      int incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl = max(incl, v);
      }
      int excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) {
        excl = NEG;
        wfa[pb][warp] = fa;
        wfb[pb][warp] = fb;
      }
      if (tid == last_t) xo_s[pb] = max(excl, runl);
      if (lane == 31) {
        wtot[pb][warp] = incl;
        wxl[pb][warp] = max(excl, runx);
      }
      __syncthreads();

      // (B) scan over the warps, each warp's deferred first lane included
      // (the block's first lane's from rank - 1's last H)
      int hb = NEG;  // the previous row's H left of the block's first lane
      const int ring = t % RING;
      if (lane == 0 && rank > 0 && wfa[pb][0]) hb = poll(&mb_h[ring], t);
      int Tw = NEG, Xw = NEG, Dw = NEG;
      if (lane < nwarps) {
        Tw = wtot[pb][lane];
        Xw = wxl[pb][lane];
        if (wfa[pb][lane])
          Dw = (lane > 0 ? hedge[pb][lane - 1] : hb) + wfb[pb][lane] + open_ -
               (kb + lane * 32 * PER + 1) * ext;
      }
      int wi = max(Tw, Dw);
      for (int off = 1; off < nwarps; off <<= 1) {
        const int v = __shfl_up_sync(FULL, wi, off);
        if (lane >= off) wi = max(wi, v);
      }
      int wex = __shfl_up_sync(FULL, wi, 1);
      if (lane == 0) wex = NEG;
      const int offw = __shfl_sync(FULL, wex, warp);
      const int Dme = __shfl_sync(FULL, Dw, warp);
      const int Mb = __shfl_sync(FULL, wi, nwarps - 1);
      const int wm = warp > 0 ? warp - 1 : 0;
      const int offp = __shfl_sync(FULL, wex, wm);
      const int Dp = __shfl_sync(FULL, Dw, wm);
      const int Xp = __shfl_sync(FULL, Xw, wm);
      const int hw = (defer && warp > 0) ? hedge[pb][warp - 1] : hb;
      // the block's candidates but its last lane's (X), for E at rank +
      // 1's first lane
      const int ow = last_t >> 5;
      const int Xb = max(max(__shfl_sync(FULL, wex, ow),
                             ((last_t & 31) == 0 && last_i == 0) ? NEG : __shfl_sync(FULL, Dw, ow)),
                         xo_s[pb]);

      // (C) the prefix of all lower ranks, from rank - 1; rank + 1's, and
      // E's prefix at this block's last lane, to rank + 1
      int P = NEG;
      if (rank > 0) {
        if (lane == 0) P = poll(&mb_p[ring], t);
        P = __shfl_sync(FULL, P, 0);
      }
      if (tid == 0 && nx_p) {
        push(&nx_p[ring], t, max(P, Mb));
        push(&nx_x[ring], t, max(P, Xb));
      }

      // the exclusive prefix at this thread's first lane
      int pre = max(P, max(offw, excl));
      if (lane > 0) pre = max(pre, Dme);
      // E of this thread's last lane, in closed form, for the thread to its
      // right; E of the lane left of this thread's first lane
      {
        int lpre = max(pre, runx);
        if (PER > 1 && defer) lpre = max(lpre, Dme);
        const int eL = lpre + (k0 + PER - 1) * ext;
        lpre = (((bef >> (PER - 1)) & 1u) && eL > NEG_HALF) ? eL : NEG;
        prev = __shfl_up_sync(FULL, lpre, 1);
      }
      int ep = prev;
      if (lane == 0) {
        ep = NEG;
        if (warp > 0 || rank > 0) {
          const int px = warp > 0 ? max(max(P, offp), max(Dp, Xp)) : poll(&mb_x[ring], t);
          const int kp = k0 - 1;
          const int jp = jr + kp;
          const bool vefp = kp >= d && kp < d + W && jp >= 1 && jp <= m_col;
          const int e = px + kp * ext;
          ep = (vefp && e > NEG_HALF) ? e : NEG;
        }
      }

      // the diagonal again (phase A's values are not kept, to spare
      // registers), the deferred one now whole
      int hp = defer ? hw : (lane > 0 ? hleft
                                      : ((warp == 0 && rank == 0 && r == 0 && rst) ? h0m1 : NEG));
      const int sh = 4 * (t & 7);
      const int col0 = p.fs1 ? 0 : open_ + (local_i - 1) * ext;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int k = k0 + i;
        const bool own = kl0 + i < BL;
        const bool vef = (bef >> i) & 1u;
        const bool vh = (bh >> i) & 1u;
        int dgv = vef ? hp + (((bmt >> i) & 1u) ? p.match_s : p.mismatch) : NEG;
        if ((bc0 >> i) & 1u) dgv = col0;
        hp = h[i];
        const int gg = max(dgv, vef ? f[i] : NEG);
        int ev = pre + k * ext;
        ev = (vef && ev > NEG_HALF) ? ev : NEG;
        if (own) pre = max(pre, gg + open_ - (k + 1) * ext);
        const int hn = vh ? max(gg, ev) : NEG;
        if (mv_out) {
          const bool eext = ev == ep + ext && ep > NEG_HALF;
          const unsigned hsrc = hn == dgv ? 0u : (hn == ev ? 1u : 2u);
          const unsigned m4 = hsrc | (eext ? 4u : 0u) | (((fext >> i) & 1u) ? 8u : 0u);
          mv[i] = sh == 0 ? m4 : (mv[i] | (m4 << sh));
          if ((t & 7) == 7 && own) mv_out[(size_t)(t >> 3) * GWp + k] = (int)mv[i];
        }
        ep = ev;
        if (vh && jr + k == m_col && hn > bv) {  // one lane per row
          bv = hn;
          bi = local_i;
        }
        if (cap && own) p.hatn[((size_t)g * p.B + b) * GWp + k] = hn;
        h[i] = hn;
      }
      // this row's edge H for the next row's deferred diagonals (the next
      // group's first row takes its edges after the realignment)
      if (r < G - 1) {
        if (lane == 31) hedge[pb ^ 1][warp] = h[PER - 1];
        if (tid == last_t && nx_h) push(&nx_h[(t + 1) % RING], t + 1, pick(h, last_i));
      }
    }

    // the group's running best: per warp here, merged over the cluster by
    // rank 0 after the next cluster barrier; the carries for the next
    // group's realignment
    int v = bv, ix = bi;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      best_merge(v, ix, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, ix, o));
    if (lane == 0) {
      wbv[warp] = v;
      wbi[warp] = ix;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int kl = kl0 + i;
      if (kl < BL) {
        shb[kl] = h[i];
        shb[BL + kl] = f[i];
        if (pv_h && kl < G * 4 && g + 1 < ng) {  // rank - 1's halo
          push(&pv_h[kl], g + 1, h[i]);
          push(&pv_f[kl], g + 1, f[i]);
        }
      }
    }
  }
  __syncthreads();
  if (warp == 0) {
    int v = lane < nwarps ? wbv[lane] : INT_MIN, ix = lane < nwarps ? wbi[lane] : INT_MAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      best_merge(v, ix, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, ix, o));
    if (lane == 0) {
      int* o = p.best + (((size_t)(ng - 1) * p.B + b) * C + rank) * 2;
      o[0] = v;
      o[1] = ix;
    }
  }
  cluster.sync();  // no block leaves while another may still write to it
}

// The tiled kernel, for a track whose region is wider than the widest
// template's block (GWp > 17 * 512 lanes at C = 1; W >= 131,072 in
// practice): one block of TT threads a track, the carries and the row's G,
// diagonal, E prefixes, F extension bits and move words in a global
// scratch (TILED_SCRATCH ints a lane); elementwise passes with
// neighbouring threads on neighbouring lanes (coalesced), and E by a scan
// of each warp's segment of lanes; five block barriers a row. Simple, and
// exact: the same lane arithmetic as tape_fwd_kernel (and the plain
// version) over every lane of the region.
constexpr int TT = 1024;
constexpr int TILED_SCRATCH = 8;

// warp w scans the candidates cand(k) of lanes [w S, (w + 1) S), 32 a step,
// writing each lane's exclusive prefix inside the segment to ex[k] (NEG at
// the segment's start); returns the segment's total
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

__global__ void __launch_bounds__(TT) tape_fwd_tiled(Params p, int* scratch) {
  __shared__ int segtot[TT / 32], segoff[TT / 32], rv[TT / 32], ri[TT / 32];
  const int b = blockIdx.x;
  const int NGR = p.L / G;
  const int ng = min(p.ngt[b], NGR);
  if (ng <= 0) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GWp = p.GWp, W = p.W, open_ = p.open_, ext = p.ext;
  int* Hb = scratch + (size_t)b * TILED_SCRATCH * GWp;  // [2][GWp]
  int* Fv = Hb + 2 * GWp;
  int* Gv = Fv + GWp;   // G = max(diag, F); the realignment's F
  int* Dv = Gv + GWp;   // the diagonal term
  int* Ev = Dv + GWp;   // E's prefix in its segment
  int* Xv = Ev + GWp;   // F's extension bit
  int* Mv = Xv + GWp;   // the lane's move word over 8 rows
  const int S = (GWp / (TT / 32) + 31) / 32 * 32;
  const int* gpl = p.gplane + (size_t)b * NGR * GP_N;
  const int* rowp = p.rowinfo + (size_t)b * p.L;
  const int8_t* rf = p.r_flat + (size_t)b * p.M;
  int* mv_out = p.moves ? p.moves + (size_t)b * (p.L / 8) * GWp : nullptr;
  for (int k = tid; k < GWp; k += TT) {
    Hb[k] = NEG;
    Fv[k] = NEG;
  }
  int cur = 0;
  int tbv = NEG, tbi = 0;  // the thread's running best last column
  for (int g = 0; g < ng; g++) {
    const int* gq = gpl + (size_t)g * GP_N;
    const int jr = gq[GP_JR], m_g = gq[GP_M], lb = gq[GP_LB];
    const int adv = gq[GP_ADV], rst = gq[GP_RST], c0 = gq[GP_C0], rstart = gq[GP_RSTART];
    __syncthreads();
    if (!rst && adv > 0) {  // realign the carries left by adv lanes
      const int* Hc = Hb + cur * GWp;
      int* Hn = Hb + (1 - cur) * GWp;
      for (int k = tid; k < GWp; k += TT) {
        const int src = k + adv;
        Hn[k] = src < GWp ? Hc[src] : NEG;
        Gv[k] = src < GWp ? Fv[src] : NEG;
      }
      __syncthreads();
      for (int k = tid; k < GWp; k += TT) Fv[k] = Gv[k];
      cur ^= 1;
    }
    if (rst) {
      int* Hc = Hb + cur * GWp;
      for (int k = tid; k < GWp; k += TT) {
        Hc[k] = boundary(jr + k, m_g, c0, p);
        Fv[k] = NEG;
      }
      tbv = NEG;
      tbi = 0;
    }
    const int h0m1 = boundary(jr - 1, m_g, c0, p);
    __syncthreads();
    for (int r = 0; r < G; ++r) {
      const int t = g * G + r;
      const int rowv = rowp[t];
      const int d = rowv & 255;
      const bool cap = (rowv >> 8) & 1;
      const bool act = (rowv >> 9) & 1;
      const int qv = (rowv >> 16) & 255;
      const int local_i = lb + r;
      const int m_col = act ? m_g : -1;
      const int col0 = p.fs1 ? 0 : open_ + (local_i - 1) * ext;
      const int* Hc = Hb + cur * GWp;
      int* Hn = Hb + (1 - cur) * GWp;
      for (int k = tid; k < GWp; k += TT) {
        const int j = jr + k;
        const bool vb = k >= d && k < d + W;
        const bool vef = vb && j >= 1 && j <= m_col;
        const int fo = Fv[k];
        const int fe = fo + ext;
        const int fnew = max(Hc[k] + open_, fe);
        Xv[k] = (fnew == fe && fo > NEG_HALF) ? 8 : 0;
        Fv[k] = fnew;
        const int hd = k > 0 ? Hc[k - 1] : ((r == 0 && rst) ? h0m1 : NEG);
        const int sub = (int)(uint8_t)rf[rstart + k] == qv ? p.match_s : p.mismatch;
        int dg = vef ? hd + sub : NEG;
        if (vb && j == 0 && m_col >= 0) dg = col0;
        Dv[k] = dg;
        Gv[k] = max(dg, vef ? fnew : NEG);
      }
      __syncthreads();
      const int tot =
          segment_scan(GWp, S, Ev, [&](int k) { return Gv[k] + open_ - (k + 1) * ext; });
      if (lane == 0) segtot[warp] = tot;
      __syncthreads();
      if (tid < 32) {
        int v = segtot[lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int x = __shfl_up_sync(FULL, v, o);
          if (lane >= o) v = max(v, x);
        }
        const int ex = __shfl_up_sync(FULL, v, 1);
        segoff[lane] = lane == 0 ? NEG : ex;
      }
      __syncthreads();
      const int sh = 4 * (t & 7);
      for (int k = tid; k < GWp; k += TT) {
        // E of lane k and of lane k - 1, from the prefix of their segments
        const int j = jr + k;
        const bool vb = k >= d && k < d + W;
        const bool vh = vb && j >= 0 && j <= m_col;
        int e = max(segoff[k / S], Ev[k]) + k * ext;
        e = (vb && j >= 1 && j <= m_col && e > NEG_HALF) ? e : NEG;
        int ep = NEG;
        if (k > 0) {
          const int kp = k - 1;
          ep = max(segoff[kp / S], Ev[kp]) + kp * ext;
          ep = (kp >= d && kp < d + W && j - 1 >= 1 && j - 1 <= m_col && ep > NEG_HALF) ? ep : NEG;
        }
        const int gg = Gv[k];
        const int hn = vh ? max(gg, e) : NEG;
        if (mv_out) {
          const bool eext = e == ep + ext && ep > NEG_HALF;
          const unsigned m4 = (hn == Dv[k] ? 0u : (hn == e ? 1u : 2u)) | (eext ? 4u : 0u) |
                              (unsigned)Xv[k];
          const unsigned w = sh == 0 ? m4 : ((unsigned)Mv[k] | (m4 << sh));
          Mv[k] = (int)w;
          if ((t & 7) == 7) mv_out[(size_t)(t >> 3) * GWp + k] = (int)w;
        }
        if (vh && j == m_col && hn > tbv) {
          tbv = hn;
          tbi = local_i;
        }
        if (cap) p.hatn[((size_t)g * p.B + b) * GWp + k] = hn;
        Hn[k] = hn;
      }
      __syncthreads();
      cur ^= 1;
    }
    // the group's running best, merged over the block: the larger value,
    // then the earlier row
    int v = tbv, ix = tbi;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      best_merge(v, ix, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, ix, o));
    if (lane == 0) {
      rv[warp] = v;
      ri[warp] = ix;
    }
    __syncthreads();
    if (warp == 0) {
      v = rv[lane];
      ix = ri[lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        best_merge(v, ix, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, ix, o));
      if (lane == 0) {
        int* o = p.best + ((size_t)g * p.B + b) * 2;
        o[0] = v;
        o[1] = ix;
      }
    }
  }
}

// lanes a thread for a block of BL lanes (0: too wide for a template;
// at C = 1 the tiled kernel takes it)
int lanes_per_thread(int BL) {
  for (int per : {2, 3, 5, 9, 17})
    if (BL <= per * MAXT) return per;
  return 0;
}

template <int PER>
void make_config(const Params& p, int C, int grid, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                 cudaLaunchAttribute* attr) {
  const int threads = ((p.BL + PER - 1) / PER + 31) / 32 * 32;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = dyn_smem(p.BL);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

template <int PER>
int launch(const Params& p, int C, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(tape_fwd_kernel<PER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dyn_smem(p.BL));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  make_config<PER>(p, C, p.B * C, stream, cfg, attr);
  err = cudaLaunchKernelEx(&cfg, tape_fwd_kernel<PER>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int PER>
int clusters(const Params& p, int C, int* n) {
  cudaError_t err = cudaFuncSetAttribute(tape_fwd_kernel<PER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dyn_smem(p.BL));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  make_config<PER>(p, C, C, 0, cfg, attr);
  return (int)cudaOccupancyMaxActiveClusters(n, tape_fwd_kernel<PER>, &cfg);
}

bool valid_shape(int GWp, int C) {
  return (C == 1 || C == 2 || C == 4 || C == 8) && GWp % 128 == 0 && GWp % C == 0 &&
         GWp / C >= G * 4 && lanes_per_thread(GWp / C) > 0;
}

// a track of GWp lanes at C = 1 too wide for every template
bool tiled_shape(int GWp, int C) {
  return C == 1 && GWp % 128 == 0 && lanes_per_thread(GWp) == 0;
}

}  // namespace

#define TAPE_FWD_DISPATCH(CALL)                          \
  switch (lanes_per_thread(p.BL)) {                      \
    case 2: return CALL(2);                              \
    case 3: return CALL(3);                              \
    case 5: return CALL(5);                              \
    case 9: return CALL(9);                              \
    case 17: return CALL(17);                            \
    default: return (int)cudaErrorInvalidValue;          \
  }

// C blocks a track (1, 2, 4 or 8), each owning GWp / C >= 128 region lanes;
// a region too wide for every template runs the tiled kernel at C = 1,
// with `scratch` ((B, 8 GWp) int32).
extern "C" int tape_fwd_launch(const int* rowinfo, const int* gplane,
                               const int8_t* r_flat, int M, const int* ngt,
                               int* moves, int* hatn, int* best, int* scratch,
                               int B, int L, int W, int GWp, int C,
                               int match_s, int mismatch, int open_, int ext,
                               int fs1, int fs2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tiled = tiled_shape(GWp, C);
  if (B <= 0 || L % G != 0 || W < 128 || GWp < W || M % 16 != 0 || M < GWp ||
      !(valid_shape(GWp, C) || tiled) || (tiled && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const int BL = GWp / C;
  Params p{rowinfo, gplane, r_flat, ngt, moves, hatn, best, B, L, M, W, GWp, BL,
           region_bytes(BL), match_s, mismatch, open_, ext, fs1, fs2};
  if (tiled) {
    tape_fwd_tiled<<<B, TT, 0, st>>>(p, scratch);
    return (int)cudaGetLastError();
  }
#define FWD_CALL(PER) launch<PER>(p, C, st)
  TAPE_FWD_DISPATCH(FWD_CALL)
#undef FWD_CALL
}

// Clusters of C blocks the card holds at once at region width GWp
// (cudaOccupancyMaxActiveClusters at tape_fwd_launch's block shape).
extern "C" int tape_fwd_clusters(int C, int GWp, int* n) {
  if (!valid_shape(GWp, C)) return (int)cudaErrorInvalidValue;
  Params p{};
  p.BL = GWp / C;
#define OCC_CALL(PER) clusters<PER>(p, C, n)
  TAPE_FWD_DISPATCH(OCC_CALL)
#undef OCC_CALL
}
