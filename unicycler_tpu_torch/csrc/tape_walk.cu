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
// (i_abs > chunk_lo). Chunks are an SMEM device there; here the walk is one
// loop over the whole tape, which visits the same cells in the same order,
// and the chunk rule becomes "continue while i_abs > 0".
//
// What bounds it on an H100: latency. Each step's load address depends on
// the step before, so a track costs (path length) x (dependent global loads
// of the row's band offset, region base and moves word). Only 8-32 tracks
// run, so almost all of the card is idle; a parallel walker is later work.
//
// Design: one thread per track, all tracks in one block. The records array
// arrives zeroed, so only the visited rows are touched.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void tape_walk_kernel(const int* __restrict__ moves,
                                 const int* __restrict__ c_rel,
                                 const int* __restrict__ jr_rows,
                                 const int* __restrict__ n_tasks,
                                 const int* __restrict__ end_abs,
                                 const int* __restrict__ end_j,
                                 const int* __restrict__ seg_start,
                                 int* __restrict__ rec, int* __restrict__ fin,
                                 int B, int L, int GWp, int W, int TT) {
  const int b = threadIdx.x;
  if (b >= B) return;
  const int* mv = moves + (size_t)b * (L / 8) * GWp;
  const int* crow = c_rel + (size_t)b * L;
  const int* jrow = jr_rows + (size_t)b * L;
  int* rb = rec + (size_t)b * L;
  const int* ea = end_abs + (size_t)b * TT;
  const int* ej = end_j + (size_t)b * TT;
  const int* ss = seg_start + (size_t)b * TT;

  int task_k = n_tasks[b] - 1;
  int kc = min(max(task_k, 0), TT - 1);
  int i_abs = task_k >= 0 ? ea[kc] : 0;
  int j = task_k >= 0 ? ej[kc] : 0;
  int s = 0;  // 0 = H, 1 = E (D run), 2 = F (I run)
  int seg0 = task_k >= 0 ? ss[kc] : 0;

  while (task_k >= 0) {
    const int i_rel = i_abs - seg0;
    if (!(i_abs > 0 || i_rel == 0 || (j == 0 && s == 0))) break;
    const bool row0_stop = i_rel == 0;
    const bool col0_stop = !row0_stop && s == 0 && j == 0;
    const int t = min(max(i_abs - 1, 0), L - 1);
    const int band = j - crow[t];
    const int lane_r = min(max(j - jrow[t], 0), GWp - 1);
    const int cell = (mv[(size_t)(t >> 3) * GWp + lane_r] >> (4 * (t & 7))) & 0xF;
    const bool escape = !row0_stop && !col0_stop && (band < 0 || band >= W);
    const bool stopping = row0_stop || col0_stop || escape;

    const int act = s == 1 ? 1 : (s == 2 ? 2 : (cell & 3));
    const bool is_m = act == 0, is_d = act == 1, is_i = act == 2;
    if (stopping) {
      kc = min(max(task_k, 0), TT - 1);
      int* fo = fin + ((size_t)b * TT + kc) * 3;
      fo[0] = i_rel;
      fo[1] = j;
      fo[2] = row0_stop ? 0 : (col0_stop ? 1 : 2);
      --task_k;
      const int nkc = min(max(task_k, 0), TT - 1);
      i_abs = ea[nkc];
      j = ej[nkc];
      s = 0;
      seg0 = ss[nkc];
      continue;
    }
    rb[t] += is_m ? 1 : (is_i ? 2 : 8);
    const bool e_ext = (cell >> 2) & 1;
    const bool f_ext = (cell >> 3) & 1;
    const int ni = (is_m || is_i) ? i_abs - 1 : i_abs;
    const int nj = (is_m || is_d) ? j - 1 : j;
    s = (is_d && e_ext && nj > 0) ? 1 : ((is_i && f_ext && ni - seg0 > 0) ? 2 : 0);
    i_abs = ni;
    j = nj;
  }
}

}  // namespace

extern "C" int tape_walk_launch(const int* moves, const int* c_rel,
                                const int* jr_rows, const int* n_tasks,
                                const int* end_abs, const int* end_j,
                                const int* seg_start, int* records, int* fin,
                                int B, int L, int GWp, int W, int TT,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 1024 || L % 8 != 0 || TT <= 0) return (int)cudaErrorInvalidValue;
  const int threads = ((B + 31) / 32) * 32;
  tape_walk_kernel<<<1, threads, 0, st>>>(moves, c_rel, jr_rows, n_tasks,
                                           end_abs, end_j, seg_start, records,
                                           fin, B, L, GWp, W, TT);
  return (int)cudaGetLastError();
}
