// Per-task anti-diagonal banded Gotoh forward, score only.
//
// Replaces: unicycler_tpu/ops/pallas_wavefront.py:_make_wavefront_kernel
// (entry _wavefront_call, via wavefront_batch_corridor). Lanes are
// diagonals: within a group of G = 32 wavefronts a = i + j the window
// [dbase_g, dbase_g + W) is fixed and lane k holds diagonal dbase_g + k. At
// group entry the carries realign by the group's advance adv: new lane k
// takes old lane k + adv, NEG where that leaves the window. The row-n and
// column-m captures land in the task's absolute-frame outputs hatn, lcv,
// lci (lane = diagonal - dmin, Wcap wide): hatn takes a captured value
// above NEG, lcv one above NEG with its row in lci. The host
// (ops/wavefront.py) stages the per-group windows, advances, capture flags
// and base planes and selects the ends, as the JAX package does around
// its kernel.
//
// What bounds it on an H100: latency and integer issue. A task is a serial
// chain of wavefronts, each a handful of dependent integer operations a
// cell; the bound (the cells' operations over the card's int32 rate) is
// two orders of magnitude below what one SM per task can issue.
//
// Design (ops/wavefront.py: wavefront_forward_pairs is this algorithm in
// plain PyTorch, launch_plan the launch shape):
// - Real lanes only. At wavefront a only the lanes with a - dbase_g - k
//   even hold cells, and those read only each other (E from k - 1 and F
//   from k + 1 at a - 1, the diagonal from k at a - 2; the realign keeps a
//   lane's diagonal). So a thread computes one cell per lane PAIR
//   (2p, 2p + 1) and wavefront; the pair's active lane alternates, and the
//   TPU kernel's odd-parity shadow DP is never computed.
// - Temporal blocking. A warp computes a window of WN = 128 pairs (4 a
//   thread, neighbours across threads by one shuffle a step) and owns the
//   S = 96 in the middle: a step moves values one pair, so the 16 halo
//   pairs on each side absorb a group's 32 steps. Warps exchange their
//   carries once a group, at the realign that exists anyway: each writes
//   its owned lanes' last (H, E, F) into a per-lane buffer, one barrier
//   (the cluster's or the block's), and each reads its next window from
//   it, shifted by the advance. No barrier inside a group. (Flags to the
//   neighbouring blocks alone, with cluster-scope fences, were slower than
//   the cluster barrier: PERF.md.)
// - Many SMs a task. A task runs on a cluster of C blocks of NW warps
//   (launch_plan: C aims at <= 4 warps a block, one a scheduler, and
//   stays 1 when the tasks alone fill the card); a block keeps the buffer
//   of its own segments in
//   shared memory and reads its neighbours' edges through distributed
//   shared memory. A band too wide for that (the buffers past the block's
//   shared memory) keeps them in a global scratch instead; a warp loops
//   over L segments where the warps of a cluster are too few.
// - Two step paths. A window whose band cells all lie inside the matrix
//   (rows 1..n-1, columns 1..m-1) for the whole group runs the bare
//   recurrence; one that meets the matrix's edges or a capture runs the
//   masks, as an exact case split of the TPU kernel's.
// - Staging and stop. Each warp copies the base bytes of its next window
//   (next segment or next group) into shared memory by cp.async while it
//   computes the current one. A task stops after the group holding
//   wavefront n + m: every capture with a value is a cell (n, j <= m) or
//   (i <= n, m), so later groups change nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NEG = -(1 << 30);
constexpr int NEG_HALF = -(1 << 29);
constexpr int G = 32;            // wavefronts per group
constexpr int PAR = 128;         // par / db row width
constexpr int P = 4;             // pairs a thread
constexpr int WN = 32 * P;       // pairs a warp's window
constexpr int HALO = G / 2;      // halo pairs each side
constexpr int S = WN - 2 * HALO; // pairs a warp owns (a segment)
constexpr int STG = 2 * WN + G;  // staged bytes a plane and window
constexpr int MAX_WARPS = 16;
constexpr int SMEM_LIMIT = 232448;

struct Params {
  const int* par;
  const int* db;
  const int8_t* zq;
  const int8_t* zr;
  int* hatn;
  int* lcv;
  int* lci;
  int* scratch;  // (B, 2, 3, W) int32 carries when they do not fit on chip
  int B, W, Wcap, GWp, n_groups, a_lo;
  int match_s, mismatch, open_, ext, fs1, fs2;
  int NW, L;  // warps a block, segments a warp
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the carries of one task: H, E, F of each lane's last active wavefront,
// two buffers (read this group, written for the next)
struct Carries {
  int* local;     // this block's shared buffers: [2][3][BL]
  int* glob;      // or the task's scratch: [2][3][W]
  int BL, W;
  unsigned inv;   // ceil(2^32 / BL): k / BL = umulhi(k, inv), exact for the
                  // k < 8 BL, BL < 23,170 lanes of a shared-memory launch
  int rank;
  cg::cluster_group* cluster;

  // lane k's H slot in buffer buf, in this block's buffer or its owner's
  // (E and F at + stride(), + 2 stride())
  template <bool GLOBAL>
  __device__ __forceinline__ const int* at(int buf, int k) const {
    if (GLOBAL) return glob + (size_t)buf * 3 * W + k;
    const int owner = (int)__umulhi((unsigned)k, inv);
    int* base = local + buf * 3 * BL + (k - owner * BL);
    return owner == rank ? base : cluster->map_shared_rank(base, owner);
  }
  // lane k's H slot in buffer buf, for a lane this block owns (E and F at
  // + stride(), + 2 stride())
  template <bool GLOBAL>
  __device__ __forceinline__ int* own(int buf, int k) const {
    if (GLOBAL) return glob + (size_t)buf * 3 * W + k;
    return local + buf * 3 * BL + (k - rank * BL);
  }
  template <bool GLOBAL>
  __device__ __forceinline__ int stride() const { return GLOBAL ? W : BL; }
};

struct Group {
  int a0, c0, sh, n, m, hit;
};

// the scoring, held in registers across the steps
struct Score {
  int match_s, mismatch, open_, ext;
  bool fs1, fs2;
};

// one wavefront: pair q of this thread's P has lane 2 (p0 + q) + PARITY
template <int PARITY, bool HIT>
__device__ __forceinline__ void step(int t, const Group& gr, const Score& p, int p0, int lane,
                                     const int8_t* zqs, const int8_t* zrs, unsigned valid,
                                     unsigned owned, int* hp, int* ep, int* fp, int* h2,
                                     int* ho, int* lo, int* io) {
  const int a = gr.a0 + t;
  const int u = a - gr.c0;
  const int jv = a + gr.c0;
  const int ib = ((u - PARITY) >> 1) - p0;  // row of pair q: ib - q
  const int jb = ((jv + PARITY) >> 1) + p0; // column of pair q: jb + q
  const int8_t* zqt = zqs + (G - 1 - t + PARITY + 2 * p0);
  const int8_t* zrt = zrs + (t + PARITY + 2 * p0);
  // the boundary values of wavefront a, branch-free: row 0 (cell (0, a))
  // and column 0
  const int lin = p.open_ + (a - 1) * p.ext;
  int h0v = a > 0 ? (p.fs2 ? 0 : lin) : (a == 0 ? 0 : NEG);
  h0v = a > gr.m ? NEG : h0v;
  const int col0m = max(p.fs1 ? 0 : lin, NEG);
  // the bases first, off the step's dependent chain
  int sub[P];
#pragma unroll
  for (int q = 0; q < P; ++q) sub[q] = zqt[2 * q] == zrt[2 * q] ? p.match_s : p.mismatch;

  // the neighbour pair across the thread edge: the left one's last pair
  // (H, E) at an even step, the right one's first pair (H, F) at an odd one
  int xh, xv;
  if (PARITY == 0) {
    xh = __shfl_up_sync(0xffffffffu, hp[P - 1], 1);
    xv = __shfl_up_sync(0xffffffffu, ep[P - 1], 1);
    xh = lane == 0 ? NEG : xh;
    xv = lane == 0 ? NEG : xv;
  } else {
    xh = __shfl_down_sync(0xffffffffu, hp[0], 1);
    xv = __shfl_down_sync(0xffffffffu, fp[0], 1);
    xh = lane == 31 ? NEG : xh;
    xv = lane == 31 ? NEG : xv;
  }
  int nh[P], ne[P], nf[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    int hl, el, hr, fr;
    if (PARITY == 0) {
      hl = q > 0 ? hp[q - 1] : xh;
      el = q > 0 ? ep[q - 1] : xv;
      hr = hp[q];
      fr = fp[q];
    } else {
      hl = hp[q];
      el = ep[q];
      hr = q < P - 1 ? hp[q + 1] : xh;
      fr = q < P - 1 ? fp[q + 1] : xv;
    }
    const int f_new = max(hr + p.open_, fr + p.ext);
    int e_new = max(hl + p.open_, el + p.ext);
    e_new = e_new > NEG_HALF ? e_new : NEG;
    const int i = ib - q;
    const int j = jb + q;
    // a cell of rows 1..n and columns 1..m is the bare recurrence; else H
    // is the row-0 boundary h0v, column 0's col0 (rows 1..n), or NEG --
    // the TPU kernel's masks, case by case
    const bool i1n = (unsigned)(i - 1) < (unsigned)gr.n;
    const bool cell = i1n && (unsigned)(j - 1) < (unsigned)gr.m;
    const int edge = i == 0 ? h0v : (i1n && j == 0 ? col0m : NEG);
    const int h = cell ? max(h2[q] + sub[q], max(f_new, e_new)) : edge;
    const bool ok = (valid >> q) & 1u;
    nh[q] = ok ? h : NEG;
    ne[q] = ok ? e_new : NEG;
    nf[q] = ok ? f_new : NEG;
    if (HIT) {
      // captures: row n, and column m at rows 0..n
      const bool cap = ((owned >> q) & 1u) && h > NEG;
      const int xa = 2 * (p0 + q) + PARITY + gr.sh;
      if (cap && i == gr.n) ho[xa] = h;
      if (cap && j == gr.m && (unsigned)i <= (unsigned)gr.n) {
        lo[xa] = h;
        io[xa] = i;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < P; ++q) {
    h2[q] = hp[q];
    hp[q] = nh[q];
    ep[q] = ne[q];
    fp[q] = nf[q];
  }
}

// one wavefront of a window whose band cells are all inside the matrix
// (rows 1..n-1, columns 1..m-1): every mask of step() holds and no capture
// can happen, so a cell is the bare recurrence; EDGE: the window reaches
// past the band, whose pairs stay NEG
template <int PARITY, bool EDGE>
__device__ __forceinline__ void step_inner(int t, const Score& p, int p0, unsigned valid,
                                           const int8_t* zqs, const int8_t* zrs, int* hp,
                                           int* ep, int* fp, int* h2) {
  const int8_t* zqt = zqs + (G - 1 - t + PARITY + 2 * p0);
  const int8_t* zrt = zrs + (t + PARITY + 2 * p0);
  int xh, xv;
  if (PARITY == 0) {
    xh = __shfl_up_sync(0xffffffffu, hp[P - 1], 1);
    xv = __shfl_up_sync(0xffffffffu, ep[P - 1], 1);
  } else {
    xh = __shfl_down_sync(0xffffffffu, hp[0], 1);
    xv = __shfl_down_sync(0xffffffffu, fp[0], 1);
  }
  int nh[P], ne[P], nf[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    int hl, el, hr, fr;
    if (PARITY == 0) {
      hl = q > 0 ? hp[q - 1] : xh;
      el = q > 0 ? ep[q - 1] : xv;
      hr = hp[q];
      fr = fp[q];
    } else {
      hl = hp[q];
      el = ep[q];
      hr = q < P - 1 ? hp[q + 1] : xh;
      fr = q < P - 1 ? fp[q + 1] : xv;
    }
    const int f_new = max(hr + p.open_, fr + p.ext);
    int e_new = max(hl + p.open_, el + p.ext);
    e_new = e_new > NEG_HALF ? e_new : NEG;
    const int sub = zqt[2 * q] == zrt[2 * q] ? p.match_s : p.mismatch;
    const int h = max(h2[q] + sub, max(f_new, e_new));
    const bool ok = !EDGE || ((valid >> q) & 1u);
    nh[q] = ok ? h : NEG;
    ne[q] = ok ? e_new : NEG;
    nf[q] = ok ? f_new : NEG;
  }
  // the window's edge pairs read garbage across the warp's edge; the halo
  // absorbs it, as in step()
#pragma unroll
  for (int q = 0; q < P; ++q) {
    h2[q] = hp[q];
    hp[q] = nh[q];
    ep[q] = ne[q];
    fp[q] = nf[q];
  }
}

template <int PAR0, bool EDGE>
__device__ __forceinline__ void inner_steps(const Score& p, int p0, unsigned valid,
                                            const int8_t* zqs, const int8_t* zrs, int* hp,
                                            int* ep, int* fp, int* h2) {
#pragma unroll 1
  for (int t = 0; t < G; t += 2) {
    step_inner<PAR0, EDGE>(t, p, p0, valid, zqs, zrs, hp, ep, fp, h2);
    step_inner<1 - PAR0, EDGE>(t + 1, p, p0, valid, zqs, zrs, hp, ep, fp, h2);
  }
}

template <int PAR0, bool HIT>
__device__ __forceinline__ void group_steps(const Group& gr, const Score& p, int p0, int lane,
                                            const int8_t* zqs, const int8_t* zrs, unsigned valid,
                                            unsigned owned, int* hp, int* ep, int* fp, int* h2,
                                            int* ho, int* lo, int* io) {
#pragma unroll 1
  for (int t = 0; t < G; t += 2) {
    step<PAR0, HIT>(t, gr, p, p0, lane, zqs, zrs, valid, owned, hp, ep, fp, h2, ho, lo, io);
    step<1 - PAR0, HIT>(t + 1, gr, p, p0, lane, zqs, zrs, valid, owned, hp, ep, fp, h2, ho, lo,
                        io);
  }
}

// copy the base bytes of segment s's window at group g into a staging slot
__device__ __forceinline__ void stage(const Params& p, int b, int g, int s, int lane, int8_t* dst) {
  const int x0 = 2 * (s * S - HALO);
  const int8_t* srcq = p.zq + ((size_t)g * p.B + b) * p.GWp;
  const int8_t* srcr = p.zr + ((size_t)g * p.B + b) * p.GWp;
  for (int c = lane; c < 2 * (STG / 16); c += 32) {
    const int plane = c / (STG / 16);
    const int off = (c % (STG / 16)) * 16;
    if (x0 + off >= 0 && x0 + off + 16 <= p.GWp)
      cp_async16(dst + plane * STG + off, (plane ? srcr : srcq) + x0 + off);
  }
}

template <bool GLOBAL>
__global__ void __launch_bounds__(MAX_WARPS * 32) wavefront_fwd_kernel(Params p) {
  extern __shared__ int4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nt = blockDim.x;
  const int Wh = p.W >> 1;
  const int nseg = (Wh + S - 1) / S;
  const int slots = p.NW * p.L;  // segments a block
  const int BL = slots * 2 * S;  // lanes a block's buffer holds
  int* smem = reinterpret_cast<int*>(smem4);
  int8_t* stg = reinterpret_cast<int8_t*>(smem + (GLOBAL ? 0 : 6 * BL)) + warp * 4 * STG;

  const int nn = p.par[b * PAR], mm = p.par[b * PAR + 1], dmin = p.par[b * PAR + 2];
  const Score sc{p.match_s, p.mismatch, p.open_, p.ext, p.fs1 != 0, p.fs2 != 0};
  const long long last = (long long)nn + mm - p.a_lo;
  const int ngt = last < 0 ? 0 : (int)min((long long)p.n_groups, last / G + 1);
  int* ho = p.hatn + (size_t)b * p.Wcap;
  int* lo = p.lcv + (size_t)b * p.Wcap;
  int* io = p.lci + (size_t)b * p.Wcap;

  Carries cs{smem, p.scratch + (size_t)b * 6 * p.W, BL, p.W,
             (unsigned)((0x100000000ull + BL - 1) / BL), rank, &cluster};
  for (int x = rank * nt + threadIdx.x; x < p.Wcap; x += C * nt) {
    ho[x] = NEG;
    lo[x] = NEG;
    io[x] = 0;
  }
  if (GLOBAL) {
    for (int x = rank * nt + threadIdx.x; x < 3 * p.W; x += C * nt) cs.glob[x] = NEG;
  } else {
    for (int x = threadIdx.x; x < 3 * BL; x += nt) smem[x] = NEG;
  }
  // the segments of this warp: s0, s0 + 1, ..., s0 + nw - 1
  const int s0 = rank * slots + warp * p.L;
  const int nw = max(0, min(p.L, nseg - s0));
  if (nw > 0 && ngt > 0) {
    stage(p, b, 0, s0, lane, stg);
    cp_async_commit();
  }
  cluster.sync();

  // this group's window base, advance and capture flag (the launch's, task
  // 0's row, as in the plain version), loaded one group ahead
  int4 d{0, 0, 0, 0};
  int hit = 0;
  if (ngt > 0) {
    d = *reinterpret_cast<const int4*>(p.db + (size_t)b * PAR);
    hit = p.db[2];
  }
  for (int g = 0; g < ngt; ++g) {
    const Group gr{p.a_lo + g * G, d.x, d.x - dmin, nn, mm, hit};
    const int adv = d.y;
    if (g + 1 < ngt) {
      d = *reinterpret_cast<const int4*>(p.db + ((size_t)(g + 1) * p.B + b) * PAR);
      hit = p.db[(size_t)(g + 1) * p.B * PAR + 2];
    }
    const int u0 = gr.a0 - gr.c0;
    const int rd = g & 1;
    for (int l = 0; l < nw; ++l) {
      const int it = g * nw + l;  // this warp's item, staged in slot it & 1
      const int s = s0 + l;
      __syncwarp();
      if (l + 1 < nw) stage(p, b, g, s + 1, lane, stg + ((it + 1) & 1) * 2 * STG);
      else if (g + 1 < ngt) stage(p, b, g + 1, s0, lane, stg + ((it + 1) & 1) * 2 * STG);
      cp_async_commit();
      cp_async_wait_1();
      __syncwarp();
      const int x0 = 2 * (s * S - HALO);  // the window's first lane
      const int8_t* zqs = stg + (it & 1) * 2 * STG - x0;
      const int8_t* zrs = zqs + STG;

      const int p0 = s * S - HALO + lane * P;
      unsigned valid = 0, owned = 0;
      int hp[P], ep[P], fp[P], h2[P];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int pp = p0 + q;
        const int w = lane * P + q;
        const bool ok = pp >= 0 && pp < Wh;
        valid |= (unsigned)ok << q;
        owned |= (unsigned)(ok && w >= HALO && w < HALO + S) << q;
        const int ka = 2 * pp + ((u0 - 1) & 1) + adv;  // active at a0 - 1
        const int kb = 2 * pp + (u0 & 1) + adv;        // active at a0 - 2
        hp[q] = ep[q] = fp[q] = h2[q] = NEG;
        if (ok && ka >= 0 && ka < p.W) {
          const int* c = cs.at<GLOBAL>(rd, ka);
          hp[q] = c[0];
          ep[q] = c[cs.stride<GLOBAL>()];
          fp[q] = c[2 * cs.stride<GLOBAL>()];
        }
        if (ok && kb >= 0 && kb < p.W) h2[q] = *cs.at<GLOBAL>(rd, kb);
      }

      // cells of the window's band pairs [pl, ph] over the group: rows
      // ((u0 + t) >> 1) - pair, columns ((jv0 + t + 1) >> 1) + pair, t in
      // [0, G)
      const int pl = max(x0 >> 1, 0), ph = min((x0 >> 1) + WN, Wh) - 1;
      const int jv0 = gr.a0 + gr.c0;
      const bool inner = (u0 >> 1) - ph >= 1 && ((u0 + G - 1) >> 1) - pl < nn &&
                         ((jv0 + 1) >> 1) + pl >= 1 && ((jv0 + G) >> 1) + ph < mm;
      const bool edge = ph - pl + 1 < WN;
      if (inner && edge) {
        if (u0 & 1) inner_steps<1, true>(sc, p0, valid, zqs, zrs, hp, ep, fp, h2);
        else inner_steps<0, true>(sc, p0, valid, zqs, zrs, hp, ep, fp, h2);
      } else if (inner) {
        if (u0 & 1) inner_steps<1, false>(sc, p0, valid, zqs, zrs, hp, ep, fp, h2);
        else inner_steps<0, false>(sc, p0, valid, zqs, zrs, hp, ep, fp, h2);
      } else if (u0 & 1) {
        if (gr.hit) group_steps<1, true>(gr, sc, p0, lane, zqs, zrs, valid, owned, hp, ep, fp, h2, ho, lo, io);
        else group_steps<1, false>(gr, sc, p0, lane, zqs, zrs, valid, owned, hp, ep, fp, h2, ho, lo, io);
      } else {
        if (gr.hit) group_steps<0, true>(gr, sc, p0, lane, zqs, zrs, valid, owned, hp, ep, fp, h2, ho, lo, io);
        else group_steps<0, false>(gr, sc, p0, lane, zqs, zrs, valid, owned, hp, ep, fp, h2, ho, lo, io);
      }

      // the owned lanes' carries for the next group: the lane active at
      // a0 + G - 1 keeps (H, E, F), the one active at a0 + G - 2 its H
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (!((owned >> q) & 1u)) continue;
        const int pp = p0 + q;
        int* ca = cs.own<GLOBAL>(rd ^ 1, 2 * pp + ((u0 + 1) & 1));
        ca[0] = hp[q];
        ca[cs.stride<GLOBAL>()] = ep[q];
        ca[2 * cs.stride<GLOBAL>()] = fp[q];
        *cs.own<GLOBAL>(rd ^ 1, 2 * pp + (u0 & 1)) = h2[q];
      }
    }
    // the carries written; no block leaves while another may still read
    // its shared memory
    if (C == 1) __syncthreads();
    else cluster.sync();
  }
}

template <bool GLOBAL>
int launch(const Params& p, int C, cudaStream_t stream) {
  const size_t smem = (size_t)p.NW * 4 * STG + (GLOBAL ? 0 : (size_t)24 * p.NW * p.L * 2 * S);
  cudaError_t err = cudaFuncSetAttribute(wavefront_fwd_kernel<GLOBAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(p.B * C);
  cfg.blockDim = dim3(p.NW * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, wavefront_fwd_kernel<GLOBAL>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// B tasks on clusters of C blocks of NW warps, each warp L segments of S
// pairs (ops/wavefront.launch_plan); the carries in shared memory unless
// global_state, then in `scratch` ((B, 2, 3, W) int32).
extern "C" int wavefront_fwd_launch(const int* par, const int* db, const int8_t* zq,
                                    const int8_t* zr, int* hatn, int* lcv, int* lci,
                                    int* scratch, int B, int W, int Wcap, int GWp, int n_groups,
                                    int a_lo, int C, int NW, int L, int global_state,
                                    int match_s, int mismatch, int open_, int ext, int fs1,
                                    int fs2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nseg = (W / 2 + S - 1) / S;
  const size_t smem = (size_t)NW * 4 * STG + (global_state ? 0 : (size_t)24 * NW * L * 2 * S);
  if (W % 128 != 0 || W < 128 || B <= 0 || n_groups <= 0 || Wcap < W || GWp < W + G ||
      GWp % 16 != 0 || !(C == 1 || C == 2 || C == 4 || C == 8) || NW < 1 ||
      NW > MAX_WARPS || L < 1 || (long long)C * NW * L < nseg || smem > SMEM_LIMIT ||
      (global_state && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{par, db, zq, zr, hatn, lcv, lci, scratch, B, W, Wcap, GWp, n_groups, a_lo,
           match_s, mismatch, open_, ext, fs1, fs2, NW, L};
  return global_state ? launch<true>(p, C, st) : launch<false>(p, C, st);
}
