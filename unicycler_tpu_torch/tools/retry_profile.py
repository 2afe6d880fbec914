"""Where the retry pair's time goes: kernel 3's cycles a row by phase, and
kernel 6's chunk stagings and steps.

Writes copies of csrc/banded.cu and csrc/banded_walk.cu with marks into the
build directory and builds them with the package's nvcc flags. Kernel 3's
copy keeps clock64() sums by phase of a row (row scalars, pass A, the
warp's maxima, the block barrier, phase B, the closed-form E edge, pass C,
the group entry) for thread 0 and for lane 0 of the last warp of block 0;
it runs on 32 drifting tasks at W = 128, 512, 1024 and 2048 for each
lanes-a-thread template. Kernel 6's copy counts diagonal runs and their
steps, one-step iterations, buffer swaps, synchronous restages and
prefetches, with clock64() sums of the prefetches, restages and swap
waits, over chip_smoke.py's phase 5 and phase 3 shapes. The marks slow
the kernels a little; the printed times are the marked copies'. The
anchors must match the sources, so update them with the kernels. Needs a
CUDA card:

    python -m unicycler_tpu_torch.tools.retry_profile
"""

import ctypes
import os
import subprocess

import numpy as np
import torch

from .. import synth
from ..ops import banded as bo
from ..ops import banded_kernel as bk
from ..ops import cuda_lib
from ..ops.pairwise import SEMI_GLOBAL, Scoring

BANDED_PHASES = ('scalars', 'pass A', 'maxima', 'barrier', 'B', 'closed',
                 'pass C', 'group')
WALK_COUNTS = ('runs', 'run steps', 'one-step', 'swaps', 'restages', None,
               'prefetches', None, 'restage cycles', 'prefetch cycles',
               'swap wait cycles', 'cycles')


def _patch(src, marks, name):
    for old, new in marks:
        if src.count(old) != 1:
            raise RuntimeError('%s changed: no single %r' % (name, old))
        src = src.replace(old, new)
    return src


def banded_source():
    """csrc/banded.cu with the phase marks and k3_prof()."""
    with open(os.path.join(cuda_lib.CSRC_DIR, 'banded.cu')) as f:
        s = f.read()
    end = ('      if (v > bv) {\n        bv = v;\n        bi = i;\n      }\n'
           '    }\n  }\n')
    marks = [
        ('namespace {\n',
         'namespace {\n__device__ long long g_prof[2][12];\n'
         '#define PROF_ON (blockIdx.x == 0 && (threadIdx.x == 0 || '
         'threadIdx.x == blockDim.x - 32))\n'
         '#define PSTART if (PROF_ON) pl = clock64();\n'
         '#define PROF(x) if (PROF_ON) { long long c_ = clock64(); '
         'pa[x] += c_ - pl; pl = c_; }\n'),
        ("  int bv = NEG, bi = 0;          // the thread's running best last "
         "column\n",
         '  int bv = NEG, bi = 0;\n  long long pa[12] = {0}, pl = 0;\n'),
        ('  for (int i = 1; i <= n_act; ++i) {\n'
         '    const int r = (i - 1) & (G - 1);\n',
         '  for (int i = 1; i <= n_act; ++i) {\n    PSTART\n'
         '    const int r = (i - 1) & (G - 1);\n'),
        ('    const int pb = i & 1, he = (i - 1) & 1;\n',
         '    PROF(7)\n    const int pb = i & 1, he = (i - 1) & 1;\n'),
        ("    // (A) F, diagonal, G and the E candidates; the warp's maxima\n",
         "    PROF(0)\n"
         "    // (A) F, diagonal, G and the E candidates; the warp's maxima\n"),
        ("    // the warp's total, and its total without its last lane\n",
         "    PROF(1)\n"
         "    // the warp's total, and its total without its last lane\n"),
        ('      wxl[pb][warp] = xtot;\n    }\n    __syncthreads();\n',
         '      wxl[pb][warp] = xtot;\n    }\n    PROF(2)\n'
         '    __syncthreads();\n    PROF(3)\n'),
        ("    // (C) the exclusive prefix at this thread's first lane; E of "
         "the lane\n",
         "    PROF(4)\n    // (C) the exclusive prefix at this thread's first "
         "lane; E of the lane\n"),
        ('    const int hdef = defer ? hedge[he][warp - 1] : NEG;\n',
         '    const int hdef = defer ? hedge[he][warp - 1] : NEG;\n'
         '    PROF(5)\n'),
        (end, end[:-4] + '    PROF(6)\n    if (PROF_ON) pa[8] += 1;\n  }\n'
         '  if (PROF_ON) for (int x = 0; x < 12; ++x) '
         'g_prof[threadIdx.x == 0 ? 0 : 1][x] = pa[x];\n'),
    ]
    return _patch(s, marks, 'banded.cu') + (
        '\nextern "C" int k3_prof(long long* out) {\n'
        '  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n'
        '}\n')


def walk_source():
    """csrc/banded_walk.cu with the counters and bw_stats()."""
    with open(os.path.join(cuda_lib.CSRC_DIR, 'banded_walk.cu')) as f:
        s = f.read()
    marks = [
        ('namespace {\n',
         'namespace {\n__device__ unsigned long long g_st[16];\n'
         '#define ST(i, v) if (ln == 0) atomicAdd(&g_st[i], '
         '(unsigned long long)(v));\n'),
        ('  auto prefetch = [&](int t0, int j) {\n',
         '  auto prefetch = [&](int t0, int j) {\n'
         '    long long c0_ = clock64(); ST(6, 1)\n'),
        ('    lo_n = lo_c - 1;\n    load_ahead(lo_c - 2);\n  };',
         '    lo_n = lo_c - 1;\n    load_ahead(lo_c - 2);\n'
         '    ST(9, clock64() - c0_)\n  };'),
        ('  auto restage = [&](int c, int t0, int j) {\n',
         '  auto restage = [&](int c, int t0, int j) {\n'
         '    long long c1_ = clock64(); ST(4, 1)\n'),
        ('    lo_c = c;\n    prefetch(t0, j);\n  };',
         '    lo_c = c;\n    ST(8, clock64() - c1_)\n'
         '    prefetch(t0, j);\n  };'),
        ('      if (run > 0) {\n', '      if (run > 0) {\n'
         '        ST(0, 1) ST(1, run)\n'),
        ('    const bool col0_stop = s == 0 && j == 0;\n',
         '    ST(2, 1)\n    const bool col0_stop = s == 0 && j == 0;\n'),
        ('        cp_async_wait_all();\n        __syncwarp();\n'
         '        cb ^= 1;',
         '        long long c2_ = clock64(); ST(3, 1)\n'
         '        cp_async_wait_all();\n        __syncwarp();\n'
         '        ST(10, clock64() - c2_)\n        cb ^= 1;'),
        ('  int i = end_i[b];\n',
         '  long long c3_ = clock64();\n  int i = end_i[b];\n'),
        ('  if (ln == 0) {\n    if (rt >= 0) rec[rt] = racc;',
         '  ST(11, clock64() - c3_)\n'
         '  if (ln == 0) {\n    if (rt >= 0) rec[rt] = racc;'),
    ]
    return _patch(s, marks, 'banded_walk.cu') + (
        '\nextern "C" int bw_stats(unsigned long long* out, int reset) {\n'
        '  if (reset) {\n    unsigned long long z[16] = {0};\n'
        '    return (int)cudaMemcpyToSymbol(g_st, z, sizeof(z));\n  }\n'
        '  return (int)cudaMemcpyFromSymbol(out, g_st, sizeof(g_st));\n}\n')


def build(name, source):
    out = os.path.join(cuda_lib.BUILD_ROOT, 'retry_profile')
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, name + '.cu')
    with open(src, 'w') as f:
        f.write(source)
    so = os.path.join(out, 'lib%s.so' % name)
    subprocess.run([cuda_lib._nvcc()] + cuda_lib.NVCC_FLAGS
                   + ['-shared', '-o', so, src], check=True,
                   capture_output=True)
    return ctypes.CDLL(so)


def packed(rng, sizes, W, dev):
    tasks = [bo.BandedTask(*t) for t in
             synth.banded_tasks(rng, sizes, drift=True)]
    n_pad = bo.bucket_length(max(len(t.q) for t in tasks))
    m_pad = bo.bucket_length(max(len(t.r) for t in tasks))
    host = bo._pack_bucket(tasks, list(range(len(tasks))), n_pad, m_pad, W,
                           bk.BT)
    return [torch.from_numpy(x).to(dev) for x in host], n_pad


def main():
    dev = torch.device('cuda', 0)
    scoring = Scoring(3, -6, -5, -2)
    cuda_lib.lib()
    k3 = build('banded_prof', banded_source())
    k3.banded_launch.argtypes = cuda_lib._SIGNATURES['banded_launch']
    k3.banded_launch.restype = ctypes.c_int
    k3.k3_prof.argtypes = [ctypes.c_void_p]
    walk = build('banded_walk_prof', walk_source())
    walk.banded_walk_launch.argtypes = \
        cuda_lib._SIGNATURES['banded_walk_launch']
    walk.bw_stats.argtypes = [ctypes.c_void_p, ctypes.c_int]
    real = cuda_lib._LIB
    for W, size in ((128, 1500), (512, 1500), (1024, 1200), (2048, 1200)):
        up, _ = packed(np.random.default_rng(3), [size] * bk.BT, W, dev)
        for lanes in (2, 4, 8):
            if (W + 128) // lanes > 576:
                continue
            cuda_lib._LIB = k3
            try:
                bk.banded_batch_cuda(*up, scoring, SEMI_GLOBAL, W, True,
                                     lanes=lanes)
                ev = [torch.cuda.Event(enable_timing=True) for _ in (0, 1)]
                ev[0].record()
                bk.banded_batch_cuda(*up, scoring, SEMI_GLOBAL, W, True,
                                     lanes=lanes)
                ev[1].record()
                torch.cuda.synchronize()
            finally:
                cuda_lib._LIB = real
            out = (ctypes.c_longlong * 24)()
            cuda_lib.check(k3.k3_prof(out), 'k3_prof')
            rows = max(out[8], 1)
            print('banded W %d, %d lanes a thread: %.3f ms, %d rows; cycles '
                  'a row, thread 0 %s; last warp %s'
                  % (W, lanes, ev[0].elapsed_time(ev[1]), out[8],
                     {n: round(out[x] / rows)
                      for x, n in enumerate(BANDED_PHASES)},
                     {n: round(out[12 + x] / rows)
                      for x, n in enumerate(BANDED_PHASES)}), flush=True)
    for label, W, sizes, seed in (
            ('phase 5', 2048, [3000, 2600, 3400, 1800, 2200, 3100, 900,
                               2900], 1),
            ('phase 3', 1024, [1200] * 32, 12)):
        up, n_pad = packed(np.random.default_rng(seed), sizes, W, dev)
        _, ei, ej, moves = bk.banded_batch_cuda(*up, scoring, SEMI_GLOBAL,
                                                W, True)
        crow = up[2][:, 1:].contiguous()
        B = moves.shape[0]
        rec = torch.zeros((B, n_pad), dtype=torch.int32, device=dev)
        fin = torch.empty((B, 3), dtype=torch.int32, device=dev)
        st = (ctypes.c_ulonglong * 16)()
        cuda_lib.check(walk.bw_stats(st, 1), 'bw_stats')
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in (0, 1)]
        ev[0].record()
        cuda_lib.check(walk.banded_walk_launch(
            moves.data_ptr(), crow.data_ptr(), ei.data_ptr(), ej.data_ptr(),
            rec.data_ptr(), fin.data_ptr(), B, n_pad, W,
            cuda_lib.stream_ptr(dev)), 'banded_walk_launch')
        ev[1].record()
        torch.cuda.synchronize()
        cuda_lib.check(walk.bw_stats(st, 0), 'bw_stats')
        print('banded_walk %s (W %d, %d tasks): %.3f ms; %s'
              % (label, W, len(sizes), ev[0].elapsed_time(ev[1]),
                 {n: st[x] for x, n in enumerate(WALK_COUNTS) if n}),
              flush=True)


if __name__ == '__main__':
    main()
