// Traceback walker over the bucketed banded kernel's nibble-plane moves.
//
// Replaces: unicycler_tpu/ops/pallas_traceback.py:_make_traceback_kernel
// (entry traceback_device). Each task walks its moves (B, n_pad, W/8) int32
// from (end_i, end_j) and writes one record per visited row,
// (d_count << 3) | move bits (1 = an M step left the row, 2 = an I step,
// + 8 per D step on the row), and its final (i, j, stop) with stop 0 =
// walked to row 0, 1 = column 0 in state H, 2 = band escape. The cell of
// (i, j) is lane = j - crow[i - 1], word lane mod (W/8), nibble
// clip(lane / (W/8), 0, 7), the layout csrc/banded.cu writes. Walks start
// at end_i <= n_act, so they read only the moves rows csrc/banded.cu
// defines (rows below n_act).
//
// The TPU kernel walks rows in chunks of T = min(n_pad, 512), highest chunk
// first, carrying the walk state across grid steps and continuing while
// i > chunk_lo. Here the walk is one loop while i > 0, which visits the
// same cells in the same order. Exactness points kept from the TPU kernel:
// a step's record is added before the stop test, on the stopping step too
// (its cell read at the clipped word and nibble even outside the band); a
// column-0 stop takes precedence over a band escape and keeps the position
// and state; E or F extension is entered only while new_j > 0 or
// new_i > 0; rows never visited stay 0.
//
// What bounds it on an H100: latency. Each step's cell depends on the step
// before, so a walk costs (path length) x (one step), and a launch costs
// its longest walk. The work is a few bytes a step; what matters is that a
// step reads shared memory and registers, not device memory.
//
// Design (as csrc/tape_walk.cu): one warp per task, four warps a block, no
// cap on tasks. The 32 lanes of a warp run the same walk in lockstep, and
// lane 0 writes. The walk goes down the rows in chunks of 32; before a
// chunk the warp has copied into shared memory the chunk's band offsets
// and, for each row, a window of 36 moves words (whole 16-byte groups)
// around the lanes of the path's diagonal, the band lanes within 16 of it
// (all of a row's words when it has fewer). While it walks a chunk,
// cp.async copies the chunk below, its windows centred on the diagonal
// through the point where this chunk was entered, and the band offsets of
// the chunk below that are loaded into registers, so no copy waits on a
// dependent load. Where the path leaves a row's window (an indel run
// longer than 16) or reaches a row the staged chunks do not hold, the warp
// restages there synchronously, so it reads the same words as a walk from
// device memory. (Copies of 4 bytes a lane, 2,048 a chunk, held the walk
// to ~0.4 us a row: the copy queue, not the walk, set the pace.) A path is
// mostly diagonal (M) steps, one a row: in H state the 32 lanes check the
// next 32 steps of a diagonal run at once (lane k step k, from the staged
// chunk), and the warp takes every step before the first that is not an
// in-band M step in H state, which then takes the one-step path. A row's
// record is summed in a register and stored once, when the walk leaves the
// row (rows are visited once, in descending order); the records array
// arrives zeroed.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;   // tasks a block, one warp each
constexpr int TROWS = 32;  // moves rows a chunk
constexpr int HALF = 16;   // lanes staged each side of the path's diagonal
constexpr int NW = 2 * HALF + 4;  // words staged a row (16-byte aligned)
constexpr int NO_CHUNK = INT_MIN / 2;

struct Chunk {
  int mv[TROWS][NW];  // words ws[r] .. ws[r] + nw - 1 (mod W/8) of row r
  int crow[TROWS];    // band offsets of the chunk's rows
  int ws[TROWS];      // first staged word of each row
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

// words staged a row: NW, or the whole row when it is shorter
__device__ __forceinline__ int staged_words(int w8) { return min(NW, w8); }

// a band lane 0 <= lane < 8 w8 as (word, nibble) = (lane mod w8, lane / w8),
// by three compares instead of a division
__device__ __forceinline__ int split_lane(int lane, int w8, int& nib) {
  nib = 0;
  if (lane >= 4 * w8) {
    lane -= 4 * w8;
    nib = 4;
  }
  if (lane >= 2 * w8) {
    lane -= 2 * w8;
    nib += 2;
  }
  if (lane >= w8) {
    lane -= w8;
    nib += 1;
  }
  return lane;
}

// copy chunk c with each row's window centred on the diagonal through
// column j of row t0 (column j - (t0 - t) in row t); crl is this lane's
// row's band offset (row c * TROWS + lane). A window is whole 16-byte
// groups of words (w8 is a multiple of 16, so a group never wraps).
__device__ __forceinline__ void copy_chunk(Chunk& ch, const int* mv, int crl, int c, int t0,
                                           int j, int n_pad, int W, int ln) {
  const int w8 = W / 8, nw = staged_words(w8);
  const int t_ln = c * TROWS + ln;
  int ws = 0;
  if (nw < w8) {
    int x = (j - (t0 - t_ln) - crl - HALF) % w8;
    if (x < 0) x += w8;
    ws = x & ~3;
  }
  ch.crow[ln] = crl;
  ch.ws[ln] = ws;
  // lane ln copies group g of row rr for x = ln + 32 k = rr * groups + g;
  // unrolled, so the shuffles and copies of all steps issue back to back
  const int groups = nw / 4;
  int rr = ln / groups, g = ln - rr * groups;
  const int drr = 32 / groups, dg = 32 - drr * groups;
#pragma unroll
  for (int k = 0; k < NW / 4; ++k) {
    if (k < groups) {  // uniform: TROWS * groups copies, 32 a step
      const int t = c * TROWS + rr;
      const int wsr = __shfl_sync(0xffffffffu, ws, rr);
      int w = wsr + 4 * g;  // < 2 w8
      if (w >= w8) w -= w8;
      if (t < n_pad) cp_async16(&ch.mv[rr][4 * g], mv + (size_t)t * w8 + w);
      rr += drr;
      g += dg;
      if (g >= groups) {
        g -= groups;
        ++rr;
      }
    }
  }
}

// the staged word of row r (of chunk ch) holding band lane `lane`, or -1
// when it is not staged
__device__ __forceinline__ int staged_idx(const Chunk& ch, int r, int word, int w8) {
  int x = word - ch.ws[r];
  if (x < 0) x += w8;
  return x < staged_words(w8) ? x : -1;
}

__global__ void __launch_bounds__(WARPS * 32) banded_walk_kernel(
    const int* __restrict__ moves, const int* __restrict__ crow, const int* __restrict__ end_i,
    const int* __restrict__ end_j, int* __restrict__ records, int* __restrict__ fin, int B,
    int n_pad, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int ln = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;
  const int w8 = W / 8;
  const int* mv = moves + (size_t)b * n_pad * w8;
  const int* cr = crow + (size_t)b * n_pad;
  int* rec = records + (size_t)b * n_pad;
  Chunk* ch = reinterpret_cast<Chunk*>(smem) + 2 * warp;

  int cb = 0;                      // buffer of the current chunk
  int lo_c = NO_CHUNK;             // its chunk index
  int lo_n = NO_CHUNK;             // the next chunk's (other buffer)
  int cr_c = NO_CHUNK, cr_v = 0;   // a chunk whose band offsets are loaded
                                   // ahead (this lane's row), and the value
  auto band_offset = [&](int c) {
    if (cr_c == c) return cr_v;
    const int t = c * TROWS + ln;
    return t < n_pad ? cr[t] : 0;
  };
  auto load_ahead = [&](int c) {
    cr_c = c;
    const int t = c * TROWS + ln;
    cr_v = (c >= 0 && t < n_pad) ? cr[t] : 0;
  };
  // start copying the chunk below the current one into the other buffer,
  // centred on the diagonal through (t0, j); nothing is in flight when
  // this is called; then load the band offsets of the chunk below that
  auto prefetch = [&](int t0, int j) {
    lo_n = NO_CHUNK;
    if (lo_c <= 0) return;
    copy_chunk(ch[cb ^ 1], mv, band_offset(lo_c - 1), lo_c - 1, t0, j, n_pad, W, ln);
    cp_async_commit();
    lo_n = lo_c - 1;
    load_ahead(lo_c - 2);
  };
  auto restage = [&](int c, int t0, int j) {
    cp_async_wait_all();
    __syncwarp();
    copy_chunk(ch[cb], mv, band_offset(c), c, t0, j, n_pad, W, ln);
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    lo_c = c;
    prefetch(t0, j);
  };

  int i = end_i[b];
  int j = end_j[b];
  int s = 0;      // 0 = H, 1 = E, 2 = F
  int done = -1;  // -1 = walking
  int rt = -1, racc = 0;  // the row whose record is being summed, its sum

  while (i > 0) {
    if (s == 0) {
      // a diagonal run: lane k checks step k, (i - k, j - k)
      const int ia = i - ln, jk = j - ln, tk = ia - 1;
      bool ok = ia > 0 && jk != 0 && tk / TROWS == lo_c;
      if (ok) {
        const Chunk& cc = ch[cb];
        const int r = tk % TROWS;
        const int lane = jk - cc.crow[r];
        ok = lane >= 0 && lane < W;
        if (ok) {
          int nib;
          const int x = staged_idx(cc, r, split_lane(lane, w8, nib), w8);
          ok = x >= 0 && (((unsigned)cc.mv[r][x] >> (4 * nib)) & 3u) == 0u;
        }
      }
      const unsigned bad = __ballot_sync(0xffffffffu, !ok);
      const int run = bad ? __ffs(bad) - 1 : 32;
      if (run > 0) {
        // every M step leaves its row: rows t .. t - run + 1 are done
        const int t = i - 1;
        if (ln == 0 && rt >= 0 && rt != t) rec[rt] = racc;
        if (ln < run) rec[t - ln] = (ln == 0 && rt == t ? racc : 0) + 1;
        rt = -1;
        racc = 0;
        i -= run;
        j -= run;
        continue;
      }
    }
    const bool col0_stop = s == 0 && j == 0;
    const int t = i - 1;
    const int c = t / TROWS;
    if (c != lo_c) {
      if (c == lo_n) {
        cp_async_wait_all();
        __syncwarp();
        cb ^= 1;
        lo_c = lo_n;
        prefetch(t, j);
      } else {
        restage(c, t, j);
      }
    }
    const int lane = j - ch[cb].crow[t % TROWS];
    const bool escape = lane < 0 || lane >= W;
    int cell;
    if (escape) {  // the clipped word and nibble, from device memory
      int widx = lane % w8;
      if (widx < 0) widx += w8;
      const int nib = lane < 0 ? 0 : min(lane / w8, 7);
      cell = (mv[(size_t)t * w8 + widx] >> (4 * nib)) & 0xF;
    } else {
      int nib;
      const int word = split_lane(lane, w8, nib);
      int x = staged_idx(ch[cb], t % TROWS, word, w8);
      if (x < 0) {
        restage(c, t, j);
        x = staged_idx(ch[cb], t % TROWS, word, w8);
      }
      cell = (int)(((unsigned)ch[cb].mv[t % TROWS][x] >> (4 * nib)) & 0xFu);
    }
    const int act = s == 1 ? 1 : (s == 2 ? 2 : (cell & 3));
    const bool is_m = act == 0, is_d = act == 1, is_i = act == 2;
    if (t != rt) {
      if (ln == 0 && rt >= 0) rec[rt] = racc;
      rt = t;
      racc = 0;
    }
    racc += is_m ? 1 : (is_i ? 2 : 8);
    const int ni = (is_m || is_i) ? i - 1 : i;
    const int nj = (is_m || is_d) ? j - 1 : j;
    const bool e_ext = (cell >> 2) & 1;
    const bool f_ext = (cell >> 3) & 1;
    const int ns = (is_d && e_ext && nj > 0) ? 1 : ((is_i && f_ext && ni > 0) ? 2 : 0);
    done = col0_stop ? 1 : (escape ? 2 : -1);
    if (done != -1) break;
    i = ni;
    j = nj;
    s = ns;
  }
  if (ln == 0) {
    if (rt >= 0) rec[rt] = racc;
    fin[3 * b] = i;
    fin[3 * b + 1] = j;
    fin[3 * b + 2] = done == -1 ? 0 : done;
  }
  cp_async_wait_all();  // a prefetch may still be in flight
}

}  // namespace

extern "C" int banded_walk_launch(const int* moves, const int* crow,
                                  const int* end_i, const int* end_j,
                                  int* records, int* fin, int B, int n_pad,
                                  int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || n_pad <= 0 || W < 8 || W % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t shmem = sizeof(Chunk) * 2 * WARPS;
  cudaError_t err = cudaFuncSetAttribute(banded_walk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  banded_walk_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, shmem, st>>>(
      moves, crow, end_i, end_j, records, fin, B, n_pad, W);
  return (int)cudaGetLastError();
}
