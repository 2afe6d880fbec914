// Traceback walker over the wavefront tape's 4-bit moves.
//
// Replaces: unicycler_tpu/ops/pallas_wavetape.py:_make_wavetape_walker
// (entry wavetape_traceback). It walks each track's tasks from the last to
// the first, in (wavefront address a = abase + i + j, lane = (j - i) -
// dbase[a]) space, and writes the same records and final states: 1 = M at
// the visited address; one record op | (len << 2) per extension-chained
// indel run (op 2 = D, 3 = I) at the run's lowest address, split every 63
// steps; fin = (i, j, stop) per task, stop 0 = row 0, 1 = column 0 in H,
// 2 = band escape. The TPU kernel walks the tape in chunks of T wavefronts,
// highest chunk first, continuing a task while its address is at or above
// the chunk's first address (addr >= chunk_lo). Here the walk is one loop
// over the whole tape, which visits the same cells in the same order, and
// the chunk rule becomes "continue while addr >= 0" for the lowest chunk.
//
// What bounds it on an H100: latency. Each step's cell depends on the step
// before, so a walk costs (path length) x (one step), and a launch costs
// its longest walk. The work is tiny (bytes of moves read a step); what
// matters is that a step reads shared memory, not device memory.
//
// Design: one warp per track (one task in ops/wavetape.build_wave_launches'
// layout), four warps a block, blocks spread over the SMs. All 32 lanes of
// a warp run the same walk in lockstep (same values, so every shared read
// is a broadcast), and lane 0 writes the records. The walk goes down the
// tape in chunks of 8 moves rows (64 wavefronts). Before a chunk, the warp
// has copied into shared memory, for each of its rows, the window base and
// the moves words of 128 diagonals around the path's diagonal d = j - i
// (indexing by diagonal, the advances between groups need no room). While
// it walks a chunk, cp.async copies the next chunk's rows, centred on the
// diagonal at this chunk's entry. Within a chunk the path's diagonal moves
// by at most one a step; where it leaves the staged window (a long indel),
// or the walk reaches a row the staged chunks do not hold (a new task),
// the warp restages there. So the walk reads the same words as a walk from
// device memory, whatever the path does. The records array arrives zeroed,
// so only the written entries are touched.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int WARPS = 4;      // tracks a block, one warp each
constexpr int ROWS = 8;       // moves rows (8 wavefronts each) a chunk
constexpr int SPAN = 128;     // diagonals staged a row
constexpr int HALF = 64;      // a chunk holds diagonals [centre - HALF, centre + HALF)
constexpr int NO_CHUNK = INT_MIN / 2;

struct Chunk {
  int mv[ROWS][SPAN];         // moves word of diagonal centre - HALF + x
  int dbs[ROWS];              // window base of each row
  int dbn[ROWS];              // window bases of the next chunk's rows
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

// copy the window of rows [lo, lo + ROWS) at `centre` (dbs already set);
// diagonals whose lane leaves [0, W) are left unset: a walk there stops
// as a band escape without reading its cell
__device__ __forceinline__ void copy_window(Chunk& c, const int* mv, int lo, int centre,
                                            int W, int ln) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = lo + r;
    if (row < 0) continue;
    const int* src = mv + (size_t)row * W;
    const int lane0 = centre - HALF - c.dbs[r];
#pragma unroll
    for (int x = ln; x < SPAN; x += 32) {
      const int lane = lane0 + x;
      if (lane >= 0 && lane < W) cp_async4(&c.mv[r][x], src + lane);
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32) wavetape_walk_kernel(
    const int* __restrict__ moves, const int* __restrict__ db_rows,
    const int* __restrict__ n_tasks, const int* __restrict__ end_i,
    const int* __restrict__ end_j, const int* __restrict__ abase,
    int* __restrict__ records, int* __restrict__ fin, int B, int LA, int W, int TT) {
  __shared__ Chunk chunks[WARPS][2];
  const int warp = threadIdx.x >> 5;
  const int ln = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;
  const int* mv = moves + (size_t)b * (LA / 8) * W;
  const int* db = db_rows + (size_t)b * LA;
  const int* ei = end_i + (size_t)b * TT;
  const int* ej = end_j + (size_t)b * TT;
  const int* ab_t = abase + (size_t)b * TT;
  int* rec = records + (size_t)b * LA;
  int* fo = fin + (size_t)b * TT * 3;
  Chunk* ch = chunks[warp];

  int cb = 0;                              // buffer of the current chunk
  int lo_c = NO_CHUNK, ce_c = 0;           // its rows [lo_c, lo_c + ROWS), centre
  int lo_n = NO_CHUNK, ce_n = 0;           // the next chunk's (other buffer)

  // start copying the chunk below the current one into the other buffer,
  // centred at diagonal d; nothing is in flight when this is called
  auto prefetch = [&](int d) {
    const int nlo = lo_c - ROWS;
    lo_n = NO_CHUNK;
    if (nlo + ROWS <= 0) return;
    Chunk& c = ch[cb];
    Chunk& o = ch[cb ^ 1];
    if (ln < ROWS) {
      o.dbs[ln] = c.dbn[ln];
      const int row = nlo - ROWS + ln;
      if (row >= 0) cp_async4(&o.dbn[ln], db + (size_t)row * 8);
    }
    __syncwarp();
    copy_window(o, mv, nlo, d, W, ln);
    cp_async_commit();
    lo_n = nlo;
    ce_n = d;
  };
  // stage rows [row - ROWS + 1, row] at diagonal d into the current buffer
  // and wait for them, then prefetch the chunk below
  auto restage = [&](int row, int d) {
    cp_async_wait_all();
    __syncwarp();
    Chunk& c = ch[cb];
    const int lo = row - (ROWS - 1);
    if (ln < 2 * ROWS) {
      const int rr = ln < ROWS ? lo + ln : lo - 2 * ROWS + ln;
      const int v = rr >= 0 ? db[(size_t)rr * 8] : 0;
      if (ln < ROWS) c.dbs[ln] = v; else c.dbn[ln - ROWS] = v;
    }
    __syncwarp();
    copy_window(c, mv, lo, d, W, ln);
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    lo_c = lo;
    ce_c = d;
    prefetch(d);
  };

  int task_k = n_tasks[b] - 1;
  int kc = min(max(task_k, 0), TT - 1);
  int i = task_k >= 0 ? ei[kc] : 0;
  int j = task_k >= 0 ? ej[kc] : 0;
  int s = 0;
  int ab = task_k >= 0 ? ab_t[kc] : 0;
  int cnt = 0;
  while (task_k >= 0) {
    const int addr = ab + i + j;
    if (!(addr >= 0 || i == 0 || (j == 0 && s == 0))) break;
    const bool row0_stop = i == 0;
    const bool col0_stop = !row0_stop && s == 0 && j == 0;
    const int t = min(max(addr, 0), LA - 1);
    bool escape = false;
    int cell = 0;
    if (!row0_stop && !col0_stop) {      // else the cell is never read
      const int row = t >> 3;
      const int d = j - i;
      if (!(row >= lo_c && row < lo_c + ROWS && d - ce_c >= -HALF && d - ce_c < HALF)) {
        if (row >= lo_n && row < lo_n + ROWS && d - ce_n >= -HALF && d - ce_n < HALF) {
          cp_async_wait_all();
          __syncwarp();
          cb ^= 1;
          lo_c = lo_n;
          ce_c = ce_n;
          prefetch(d);
        } else {
          restage(row, d);
        }
      }
      const Chunk& c = ch[cb];
      const int lane = d - c.dbs[row - lo_c];
      escape = lane < 0 || lane >= W;
      if (!escape)
        cell = (int)(((unsigned)c.mv[row - lo_c][d - ce_c + HALF] >> (4 * (t & 7))) & 0xFu);
    }
    const bool stopping = row0_stop || col0_stop || escape;
    const int code = row0_stop ? 0 : (col0_stop ? 1 : 2);

    const int hsrc = cell & 3;
    const int act = s == 1 ? 1 : (s == 2 ? 2 : hsrc);
    const bool is_m = act == 0, is_d = act == 1, is_i = act == 2;
    const bool e_ext = ((cell >> 2) & 1) == 1;
    const bool f_ext = ((cell >> 3) & 1) == 1;
    const int ni = (is_m || is_i) ? i - 1 : i;
    const int nj = (is_m || is_d) ? j - 1 : j;
    const int ns = (is_d && e_ext && nj > 0) ? 1 : ((is_i && f_ext && ni > 0) ? 2 : 0);
    const bool gap = is_d || is_i;
    const bool chain_end = gap && (ns == 0 || cnt >= 62);
    if (ln == 0) {
      if (!(stopping || (gap && !chain_end)))
        rec[t] = is_m ? 1 : ((is_d ? 2 : 3) | ((cnt + 1) << 2));
      if (stopping) {
        fo[3 * kc] = i;
        fo[3 * kc + 1] = j;
        fo[3 * kc + 2] = code;
      }
    }
    const int ncnt = (stopping || ns == 0 || cnt >= 62) ? 0 : (gap ? cnt + 1 : 0);
    if (stopping) {
      task_k -= 1;
      kc = min(max(task_k, 0), TT - 1);
      i = ei[kc];
      j = ej[kc];
      s = 0;
      ab = ab_t[kc];
    } else {
      i = ni;
      j = nj;
      s = ns;
    }
    cnt = ncnt;
  }
  cp_async_wait_all();          // a prefetch may still be in flight
}

}  // namespace

extern "C" int wavetape_walk_launch(const int* moves, const int* db_rows,
                                    const int* n_tasks, const int* end_i,
                                    const int* end_j, const int* abase,
                                    int* records, int* fin, int B, int LA,
                                    int W, int TT, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || LA % 8 != 0) return (int)cudaErrorInvalidValue;
  wavetape_walk_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0, st>>>(
      moves, db_rows, n_tasks, end_i, end_j, abase, records, fin, B, LA, W, TT);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the walker, and the tracks a block walks.
extern "C" int wavetape_walk_occupancy(int* blocks, int* tracks_per_block) {
  *tracks_per_block = WARPS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, wavetape_walk_kernel,
                                                           WARPS * 32, 0);
}
