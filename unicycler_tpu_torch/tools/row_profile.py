"""Where a row of the row forward kernel goes: cycles a tape row by phase.

Writes a copy of csrc/tape_fwd.cu with clock64() marks around each phase
of a row (A and the warp scan, the block barrier, B and the pushes, the
mailbox polls of C, the closed-form E edge, the second pass, the group
entry), kept by thread 0 of rank 0 and of the last rank, builds it with
the package's nvcc flags into the build directory, and runs it on 12
one-task tracks of 600-1,300 rows at W = 4096 and 8192 for each cluster
size, with the launch's time per tape row (CUDA events). --min-lanes N
builds the copy with at least N lanes a thread (fewer, wider threads a
block) to compare block shapes; --sleep-ns T makes a mailbox poller sleep
T ns between reads (0: spin). Needs a CUDA card:

    python -m unicycler_tpu_torch.tools.row_profile [--min-lanes N] [--sleep-ns T]
"""

import argparse

import ctypes
import os
import subprocess

import numpy as np
import torch

from .. import synth
from ..ops import banded as bo
from ..ops import cuda_lib
from ..ops import tape_kernels as tk
from ..ops.pairwise import FULLY_GLOBAL, Scoring
from ..ops.tape import build_row_launches, forward_inputs

PHASES = ('A+scan', 'S1', 'B+push', 'C poll', 'closed', 'pass',
          'group entry')


def instrumented_source(min_lanes=2, sleep_ns=None):
    """csrc/tape_fwd.cu with the phase marks and tape_fwd_prof(), its
    blocks shaped with at least min_lanes lanes a thread, and its pollers
    sleeping sleep_ns between reads (None: as the source has it)."""
    with open(os.path.join(cuda_lib.CSRC_DIR, 'tape_fwd.cu')) as f:
        s = f.read()
    if sleep_ns is not None:
        if s.count('__nanosleep(32);') != 2:
            raise RuntimeError('tape_fwd.cu changed: its pollers')
        s = s.replace('__nanosleep(32);', '__nanosleep(%d);' % sleep_ns
                      if sleep_ns else ';')
    marks = [
        ('    if (BL <= per * MAXT) return per;',
         '    if (per >= %d && BL <= per * MAXT) return per;' % min_lanes),
        ('namespace cg = cooperative_groups;\n',
         'namespace cg = cooperative_groups;\n'
         '__device__ long long g_prof[2][10];\n'
         '#define PROF_ON (tid == 0 && (blockIdx.x == 0 || '
         'blockIdx.x == C - 1))\n'
         '#define PSTART if (PROF_ON) pl = clock64();\n'
         '#define PROF(i) if (PROF_ON) { long long c_ = clock64(); '
         'pa[i] += c_ - pl; pl = c_; }\n'),
        ('  int bv = NEG, bi = 0;',
         '  long long pa[10] = {0}, pl = 0;\n  int bv = NEG, bi = 0;'),
        ('  for (int g = 0; g < ng; ++g) {\n',
         '  for (int g = 0; g < ng; ++g) {\n    PSTART\n'),
        ('    const int* rws = rows_s[g & 1];',
         '    PROF(7)\n    const int* rws = rows_s[g & 1];'),
        ('      const int rowv = rws[r];',
         '      PSTART\n      const int rowv = rws[r];'),
        ('        wxl[pb][warp] = max(excl, runx);\n      }\n'
         '      __syncthreads();',
         '        wxl[pb][warp] = max(excl, runx);\n      }\n'
         '      PROF(1)\n      __syncthreads();\n      PROF(2)'),
        ("      // (C) the prefix of all lower ranks",
         "      PROF(3)\n      // (C) the prefix of all lower ranks"),
        ('        P = __shfl_sync(FULL, P, 0);\n      }',
         '        P = __shfl_sync(FULL, P, 0);\n      }\n      PROF(4)'),
        ('      // the diagonal again', '      PROF(5)\n      // the diagonal again'),
        ("      // this row's edge H for the next row",
         "      PROF(6)\n      // this row's edge H for the next row"),
        ('  cluster.sync();  // no block leaves',
         '  if (PROF_ON) {\n    pa[8] = ng;\n    for (int i = 0; i < 10; ++i)'
         ' g_prof[blockIdx.x == 0 ? 0 : 1][i] = pa[i];\n  }\n'
         '  cluster.sync();  // no block leaves'),
    ]
    for old, new in marks:
        if s.count(old) != 1:
            raise RuntimeError('tape_fwd.cu changed: no single %r' % old)
        s = s.replace(old, new)
    return s + ('\nextern "C" int tape_fwd_prof(long long* out) {\n'
                '  return (int)cudaMemcpyFromSymbol(out, g_prof, '
                'sizeof(g_prof));\n}\n')


def build(min_lanes=2, sleep_ns=None):
    """Build the instrumented kernel; returns the loaded library."""
    out = os.path.join(cuda_lib.BUILD_ROOT, 'row_profile')
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, 'tape_fwd_prof.cu')
    with open(src, 'w') as f:
        f.write(instrumented_source(min_lanes, sleep_ns))
    so = os.path.join(out, 'libtape_fwd_prof.so')
    subprocess.run([cuda_lib._nvcc()] + cuda_lib.NVCC_FLAGS
                   + ['-shared', '-o', so, src], check=True,
                   capture_output=True)
    handle = ctypes.CDLL(so)
    for name in ('tape_fwd_launch', 'tape_fwd_clusters'):
        fn = getattr(handle, name)
        fn.argtypes = cuda_lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    handle.tape_fwd_prof.argtypes = [ctypes.c_void_p]
    return handle


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--min-lanes', type=int, default=2)
    ap.add_argument('--sleep-ns', type=int, default=None)
    args = ap.parse_args()
    dev = torch.device('cuda', 0)
    handle = build(args.min_lanes, args.sleep_ns)
    cuda_lib.lib()
    cuda_lib._LIB = handle       # tape_forward_cuda launches the copy
    rng = np.random.default_rng(7)
    scoring = Scoring(3, -6, -5, -2)
    for W in (4096, 8192):
        sizes = [int(x) for x in rng.integers(600, 1300, 12)]
        tasks = [bo.BandedTask(*t)
                 for t in synth.banded_tasks(rng, sizes, drift=True)]
        tp = build_row_launches(tasks, W, bo.build_corridor)[0]
        up = [torch.from_numpy(x).to(dev) for x in forward_inputs(tp)]
        rowinfo, gplane, _, _ = tk.tape_prolog(up[0], up[1], up[2], up[3],
                                               up[5], up[7], up[8], W)
        ngt = tk.track_groups(up[11])
        for C in tk.CLUSTER_SIZES[::-1]:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            tk.tape_forward_cuda(rowinfo, gplane, up[1], ngt, scoring,
                                 FULLY_GLOBAL, W, True, cluster=C)
            ev[0].record()
            tk.tape_forward_cuda(rowinfo, gplane, up[1], ngt, scoring,
                                 FULLY_GLOBAL, W, True, cluster=C)
            ev[1].record()
            torch.cuda.synchronize()
            print('W %d C %d, at least %d lanes a thread, sleep %s: %.3f us '
                  'a tape row' % (W, C, args.min_lanes, args.sleep_ns,
                                  1e3 * ev[0].elapsed_time(ev[1])
                                  / (32 * int(ngt.max()))))
            buf = (ctypes.c_longlong * 20)()
            cuda_lib.check(handle.tape_fwd_prof(ctypes.addressof(buf)),
                           'tape_fwd_prof')
            for which, name in ((0, 'rank 0'), (1, 'last rank')):
                v = list(buf[10 * which:10 * which + 10])
                rows = max(v[8] * 32, 1)
                print('W %d C %d %s: %s cycles/row' % (
                    W, C, name, '  '.join('%s %.0f' % (n, v[i + 1] / rows)
                                          for i, n in enumerate(PHASES))))


if __name__ == '__main__':
    main()
