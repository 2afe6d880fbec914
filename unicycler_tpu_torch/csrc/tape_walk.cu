// Traceback walker over the row tape's 4-bit moves.
//
// Replaces: unicycler_tpu/ops/pallas_tape.py:_make_tape_traceback_kernel
// (entry tape_traceback). It walks each track's tasks from the last to the
// first, in descending tape rows, and writes the same outputs: one record
// per visited row, (number of D steps << 3) + 1 for an M step or + 2 for an
// I step (nothing on a stop iteration), and fin = (final local i, final j,
// stop) per task, stop 0 = row 0, 1 = column 0 in H, 2 = band escape. The
// TPU kernel walks the tape in chunks of T rows, highest chunk first,
// continuing a task while its row lies above the chunk's first row
// (i_abs > chunk_lo). Here the walk is one loop over the whole tape, which
// visits the same cells in the same order, and the chunk rule becomes
// "continue while i_abs > 0".
//
// What bounds it on an H100: latency. Each step's cell depends on the step
// before, so a walk costs (path length) x (one step), and a launch costs
// its longest walk. The work is tiny (a few bytes a step); what matters is
// that a step reads shared memory and registers, not device memory.
//
// Design: one warp per track (one task in ops/tape.build_row_launches'
// layout), four warps a block, blocks spread over the SMs, no cap on the
// tracks. All 32 lanes of a warp run the same walk in lockstep (same
// values, so every shared read is a broadcast), and lane 0 writes. The walk
// goes down the tape in chunks of one row group (32 tape rows, 4 moves
// rows, one region base jr). Before a chunk, the warp has copied into
// shared memory the chunk's band offsets c_rel and region bases, and for
// each of its moves rows the words of the 128 columns [top - 127, top]
// (indexed by column, so the region base needs no room; j never grows
// along a walk). While it walks a chunk, cp.async copies the chunk below,
// at the column where this chunk was entered. Where the path leaves the
// staged columns (a long deletion) or the walk reaches a row the staged
// chunks do not hold (a new task), the warp restages there synchronously,
// so the walk reads the same words as a walk from device memory. A path is
// mostly diagonal (M) steps, one a row: in H state the 32 lanes check the
// next 32 steps of a diagonal run at once (lane k step k, from the staged
// chunk), and the warp takes every step before the first that is not an M
// step in H state, which then takes the one-step path. A row's
// record is summed in a register and stored when the walk leaves the row
// (rows are visited once, in descending order, and tasks own disjoint
// rows); the records array arrives zeroed, so only visited rows are
// written.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;       // tracks a block, one warp each
constexpr int TROWS = 32;      // tape rows a chunk (one row group)
constexpr int ROWS = TROWS / 8;  // moves rows a chunk
constexpr int SPAN = 128;      // columns staged a moves row
constexpr int NO_CHUNK = INT_MIN / 2;

struct Chunk {
  int mv[ROWS][SPAN];   // moves word of column top - SPAN + 1 + x
  int crow[TROWS];      // c_rel of the chunk's tape rows
  int jrow[TROWS];      // region base of the chunk's tape rows
  int jrn;              // region base of the chunk below
};

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

// copy chunk c (region base jr) at columns [top - SPAN + 1, top], its band
// offsets and region bases, and the region base of the chunk below;
// columns whose lane leaves [0, GWp) are left unset: a walk there escapes
// its band without reading the cell
__device__ __forceinline__ void copy_chunk(Chunk& ch, const int* mv, const int* crow,
                                           const int* jrow, int c, int jr, int top, int GWp,
                                           int ln) {
  const int lane0 = top - SPAN + 1 - jr;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int* src = mv + (size_t)(c * ROWS + r) * GWp;
#pragma unroll
    for (int x = ln; x < SPAN; x += 32) {
      const int lane = lane0 + x;
      if (lane >= 0 && lane < GWp) cp_async4(&ch.mv[r][x], src + lane);
    }
  }
  cp_async4(&ch.crow[ln], crow + c * TROWS + ln);
  cp_async4(&ch.jrow[ln], jrow + c * TROWS + ln);
  if (ln == 0 && c > 0) cp_async4(&ch.jrn, jrow + (c - 1) * TROWS);
}

__global__ void __launch_bounds__(WARPS * 32) tape_walk_kernel(
    const int* __restrict__ moves, const int* __restrict__ c_rel,
    const int* __restrict__ jr_rows, const int* __restrict__ n_tasks,
    const int* __restrict__ end_abs, const int* __restrict__ end_j,
    const int* __restrict__ seg_start, int* __restrict__ rec, int* __restrict__ fin, int B,
    int L, int GWp, int W, int TT) {
  __shared__ Chunk chunks[WARPS][2];
  const int warp = threadIdx.x >> 5;
  const int ln = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;
  const int* mv = moves + (size_t)b * (L / 8) * GWp;
  const int* crow = c_rel + (size_t)b * L;
  const int* jrow = jr_rows + (size_t)b * L;
  int* rb = rec + (size_t)b * L;
  const int* ea = end_abs + (size_t)b * TT;
  const int* ej = end_j + (size_t)b * TT;
  const int* ss = seg_start + (size_t)b * TT;
  int* fo = fin + (size_t)b * TT * 3;
  Chunk* ch = chunks[warp];

  int cb = 0;                              // buffer of the current chunk
  int lo_c = NO_CHUNK, top_c = 0;          // its chunk index and top column
  int lo_n = NO_CHUNK, top_n = 0;          // the next chunk's (other buffer)

  // start copying the chunk below the current one into the other buffer,
  // topped at column top; nothing is in flight when this is called
  auto prefetch = [&](int top) {
    const int nc = lo_c - 1;
    lo_n = NO_CHUNK;
    if (nc < 0) return;
    copy_chunk(ch[cb ^ 1], mv, crow, jrow, nc, ch[cb].jrn, top, GWp, ln);
    cp_async_commit();
    lo_n = nc;
    top_n = top;
  };
  // stage chunk c topped at column top into the current buffer and wait
  // for it, then prefetch the chunk below
  auto restage = [&](int c, int top) {
    cp_async_wait_all();
    __syncwarp();
    copy_chunk(ch[cb], mv, crow, jrow, c, jrow[c * TROWS], top, GWp, ln);
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    lo_c = c;
    top_c = top;
    prefetch(top);
  };

  int task_k = n_tasks[b] - 1;
  int kc = min(max(task_k, 0), TT - 1);
  int i_abs = task_k >= 0 ? ea[kc] : 0;
  int j = task_k >= 0 ? ej[kc] : 0;
  int s = 0;  // 0 = H, 1 = E (D run), 2 = F (I run)
  int seg0 = task_k >= 0 ? ss[kc] : 0;
  int rt = -1, racc = 0;  // the row whose record is being summed, its sum

  while (task_k >= 0) {
    const int i_rel = i_abs - seg0;
    if (s == 0) {
      // a diagonal run: lane k checks step k, (i_abs - k, j - k), in the
      // staged chunk; the steps before the first lane that is not an M
      // step in H state (a stop, a band escape, another move, or a cell
      // outside the chunk) are taken at once
      const int ia = i_abs - ln, jk = j - ln, tk = ia - 1;
      bool ok = ia - seg0 > 0 && jk != 0 && tk >= 0 && tk / TROWS == lo_c && jk <= top_c &&
                jk > top_c - SPAN;
      if (ok) {
        const Chunk& cc = ch[cb];
        const int band = jk - cc.crow[tk % TROWS];
        ok = band >= 0 && band < W &&
             ((cc.mv[(tk >> 3) % ROWS][jk - (top_c - SPAN + 1)] >> (4 * (tk & 7))) & 3u) == 0u;
      }
      const unsigned bad = __ballot_sync(0xffffffffu, !ok);
      const int run = bad ? __ffs(bad) - 1 : 32;
      if (run > 0) {
        // every M step leaves its row: rows t .. t - run + 1 are done
        if (ln == 0 && rt >= 0 && rt != tk) rb[rt] = racc;
        if (ln < run) rb[tk] = (ln == 0 && rt == tk ? racc : 0) + 1;
        rt = -1;
        racc = 0;
        i_abs -= run;
        j -= run;
        continue;
      }
    }
    if (!(i_abs > 0 || i_rel == 0 || (j == 0 && s == 0))) break;
    const bool row0_stop = i_rel == 0;
    const bool col0_stop = !row0_stop && s == 0 && j == 0;
    const int t = min(max(i_abs - 1, 0), L - 1);
    bool escape = false;
    int cell = 0;
    if (!row0_stop && !col0_stop) {      // else the cell is never read
      const int c = t / TROWS;
      if (!(c == lo_c && j <= top_c && j > top_c - SPAN)) {
        if (c == lo_n && j <= top_n && j > top_n - SPAN) {
          cp_async_wait_all();
          __syncwarp();
          cb ^= 1;
          lo_c = lo_n;
          top_c = top_n;
          prefetch(j);
        } else {
          restage(c, j);
        }
      }
      const Chunk& cc = ch[cb];
      const int band = j - cc.crow[t % TROWS];
      escape = band < 0 || band >= W;
      if (!escape)
        cell = (int)(((unsigned)cc.mv[(t >> 3) % ROWS][j - (top_c - SPAN + 1)] >> (4 * (t & 7))) &
                     0xFu);
    }
    const bool stopping = row0_stop || col0_stop || escape;
    if (stopping) {
      if (ln == 0) {
        fo[3 * kc] = i_rel;
        fo[3 * kc + 1] = j;
        fo[3 * kc + 2] = row0_stop ? 0 : (col0_stop ? 1 : 2);
      }
      --task_k;
      kc = min(max(task_k, 0), TT - 1);
      i_abs = ea[kc];
      j = ej[kc];
      s = 0;
      seg0 = ss[kc];
      continue;
    }
    const int act = s == 1 ? 1 : (s == 2 ? 2 : (cell & 3));
    const bool is_m = act == 0, is_d = act == 1, is_i = act == 2;
    if (t != rt) {
      if (ln == 0 && rt >= 0) rb[rt] = racc;
      rt = t;
      racc = 0;
    }
    racc += is_m ? 1 : (is_i ? 2 : 8);
    const bool e_ext = (cell >> 2) & 1;
    const bool f_ext = (cell >> 3) & 1;
    const int ni = (is_m || is_i) ? i_abs - 1 : i_abs;
    const int nj = (is_m || is_d) ? j - 1 : j;
    s = (is_d && e_ext && nj > 0) ? 1 : ((is_i && f_ext && ni - seg0 > 0) ? 2 : 0);
    i_abs = ni;
    j = nj;
  }
  if (ln == 0 && rt >= 0) rb[rt] = racc;
  cp_async_wait_all();          // a prefetch may still be in flight
}

}  // namespace

extern "C" int tape_walk_launch(const int* moves, const int* c_rel,
                                const int* jr_rows, const int* n_tasks,
                                const int* end_abs, const int* end_j,
                                const int* seg_start, int* records, int* fin,
                                int B, int L, int GWp, int W, int TT,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L % TROWS != 0 || TT <= 0) return (int)cudaErrorInvalidValue;
  tape_walk_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0, st>>>(
      moves, c_rel, jr_rows, n_tasks, end_abs, end_j, seg_start, records, fin, B, L, GWp, W, TT);
  return (int)cudaGetLastError();
}
