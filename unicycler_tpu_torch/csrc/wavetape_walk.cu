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
// the chunk's first address (addr >= chunk_lo). Chunks are a VMEM device
// there; here the walk is one loop over the whole tape, which visits the
// same cells in the same order, and the chunk rule becomes "continue while
// addr >= 0" for the lowest chunk.
//
// What bounds it on an H100: latency. Each step's load address depends on
// the step before, so a track costs (path length) x (one dependent global
// load of dbase and one of the moves word, a few hundred ns from L2). There
// are only 8-32 tracks, so almost all of the card is idle. This PR keeps it
// serial on purpose; a parallel walker is later work.
//
// Design: one thread per track, all tracks in one block. The records array
// arrives zeroed, so only the written entries are touched.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void wavetape_walk_kernel(const int* __restrict__ moves,
                                     const int* __restrict__ db_rows,
                                     const int* __restrict__ n_tasks,
                                     const int* __restrict__ end_i,
                                     const int* __restrict__ end_j,
                                     const int* __restrict__ abase,
                                     int* __restrict__ records,
                                     int* __restrict__ fin,
                                     int B, int LA, int W, int TT) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int* mv = moves + (size_t)b * (LA / 8) * W;
  const int* db = db_rows + (size_t)b * LA;
  const int* ei = end_i + (size_t)b * TT;
  const int* ej = end_j + (size_t)b * TT;
  const int* ab_t = abase + (size_t)b * TT;
  int* rec = records + (size_t)b * LA;
  int* fo = fin + (size_t)b * TT * 3;

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
    const int lane = (j - i) - db[t];
    const int lc = min(max(lane, 0), W - 1);
    const int cell = (int)(((unsigned)mv[(size_t)(t >> 3) * W + lc] >> (4 * (t & 7))) & 0xFu);
    const bool escape = !row0_stop && !col0_stop && (lane < 0 || lane >= W);
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
    if (!(stopping || (gap && !chain_end)))
      rec[t] = is_m ? 1 : ((is_d ? 2 : 3) | ((cnt + 1) << 2));
    if (stopping) {
      fo[3 * kc] = i;
      fo[3 * kc + 1] = j;
      fo[3 * kc + 2] = code;
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
}

}  // namespace

extern "C" int wavetape_walk_launch(const int* moves, const int* db_rows,
                                    const int* n_tasks, const int* end_i,
                                    const int* end_j, const int* abase,
                                    int* records, int* fin, int B, int LA,
                                    int W, int TT, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 1024 || LA % 8 != 0) return (int)cudaErrorInvalidValue;
  const int threads = ((B + 31) / 32) * 32;
  wavetape_walk_kernel<<<1, threads, 0, st>>>(moves, db_rows, n_tasks, end_i,
                                               end_j, abase, records, fin, B,
                                               LA, W, TT);
  return (int)cudaGetLastError();
}
