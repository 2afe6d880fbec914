// Traceback walker over the bucketed banded kernel's nibble-plane moves.
//
// Replaces: unicycler_tpu/ops/pallas_traceback.py:_make_traceback_kernel
// (entry traceback_device). Each task walks its moves (B, n_pad, W/8) int32
// from (end_i, end_j) and writes one record per visited row,
// (d_count << 3) | move bits (1 = an M step left the row, 2 = an I step,
// + 8 per D step on the row), and its final (i, j, stop) with stop 0 =
// walked to row 0, 1 = column 0 in state H, 2 = band escape. The cell of
// (i, j) is lane = j - crow[i - 1], word lane mod (W/8), nibble
// clip(lane / (W/8), 0, 7), the layout csrc/banded.cu writes.
//
// The TPU kernel walks rows in chunks of T = min(n_pad, 512), highest chunk
// first, carrying the walk state across grid steps and continuing while
// i > chunk_lo. Chunks are a VMEM device there; here the walk is one loop
// while i > 0, which visits the same cells in the same order. Exactness
// points kept from the TPU kernel: a step's record is added before the
// stop test, on the stopping step too; a column-0 stop takes precedence
// over a band escape and keeps the position and state; E or F extension is
// entered only while new_j > 0 or new_i > 0; rows never visited stay 0.
//
// What bounds it on an H100: latency. Every step's load depends on the step
// before (band offset, then moves word), so a task costs (path length) x
// two dependent loads. Tasks are independent, one thread each; the band
// escape retries it serves are a few tasks a call, so the card is mostly
// idle. A faster walker is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void banded_walk_kernel(const int* __restrict__ moves,
                                   const int* __restrict__ crow,
                                   const int* __restrict__ end_i,
                                   const int* __restrict__ end_j,
                                   int* __restrict__ records,
                                   int* __restrict__ fin, int B, int n_pad,
                                   int W) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int w8 = W / 8;
  const int* mv = moves + (size_t)b * n_pad * w8;
  const int* cr = crow + (size_t)b * n_pad;
  int* rec = records + (size_t)b * n_pad;

  int i = end_i[b];
  int j = end_j[b];
  int s = 0;          // 0 = H, 1 = E, 2 = F
  int done = -1;      // -1 = walking
  while (done == -1 && i > 0) {
    const bool col0_stop = s == 0 && j == 0;
    const int t = i - 1;
    const int lane = j - cr[t];
    int widx = lane % w8;
    if (widx < 0) widx += w8;
    const int nib = lane < 0 ? 0 : min(lane / w8, 7);
    const int cell = (mv[(size_t)t * w8 + widx] >> (4 * nib)) & 0xF;
    const bool band_escape = lane < 0 || lane >= W;

    const int act = s == 1 ? 1 : (s == 2 ? 2 : (cell & 3));
    const bool is_m = act == 0, is_d = act == 1, is_i = act == 2;
    rec[t] += is_m ? 1 : (is_i ? 2 : 8);

    const int ni = (is_m || is_i) ? i - 1 : i;
    const int nj = (is_m || is_d) ? j - 1 : j;
    const bool e_ext = ((cell >> 2) & 1) == 1;
    const bool f_ext = ((cell >> 3) & 1) == 1;
    const int ns = (is_d && e_ext && nj > 0) ? 1
                   : ((is_i && f_ext && ni > 0) ? 2 : 0);
    done = col0_stop ? 1 : (band_escape ? 2 : -1);
    if (done == -1) {
      i = ni;
      j = nj;
      s = ns;
    }
  }
  fin[3 * b] = i;
  fin[3 * b + 1] = j;
  fin[3 * b + 2] = done == -1 ? 0 : done;
}

}  // namespace

extern "C" int banded_walk_launch(const int* moves, const int* crow,
                                  const int* end_i, const int* end_j,
                                  int* records, int* fin, int B, int n_pad,
                                  int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || n_pad <= 0 || W < 8 || W % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  banded_walk_kernel<<<blocks, threads, 0, st>>>(moves, crow, end_i, end_j,
                                                  records, fin, B, n_pad, W);
  return (int)cudaGetLastError();
}
