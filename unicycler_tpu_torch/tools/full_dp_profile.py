"""Where a step of the full-matrix DP kernel goes: cycles a step by phase.

Builds csrc/pairwise.cu alone with -DPAIRWISE_PROF (its PROF marks then
add up clock64() cycles for lane 0 of warps 0 and 1 of pair 0's first
block: warp 0 takes row 0 or the stripe's scratch, warp 1 a ring) into
the build directory, runs it at chip_smoke.py phase 6's consensus, mixed
and wide shapes under a few plans, and prints for each the launch's time
(CUDA events) and each warp's cycles a step: its input (window or ring),
the cells, the captures, the moves, the hand-off out of the warp and the
shuffles to the next lane. Needs a CUDA card:

    python -m unicycler_tpu_torch.tools.full_dp_profile
"""

import ctypes
import os
import subprocess

import numpy as np
import torch

from .. import synth
from ..ops import cuda_lib
from ..ops import pairwise as pw
from ..ops.encode import pack_pairs

PHASES = ('input', 'cells', 'captures', 'moves', 'hand-off', 'shuffles')


def build():
    out_dir = os.path.join(cuda_lib.BUILD_ROOT, 'full_dp_profile',
                           cuda_lib.source_hash())
    so = os.path.join(out_dir, 'libprof.so')
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        cmd = [cuda_lib._nvcc()] + cuda_lib.NVCC_FLAGS + [
            '-DPAIRWISE_PROF', '-shared', '-o', so,
            os.path.join(cuda_lib.CSRC_DIR, 'pairwise.cu')]
        subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(so)
    lib.pairwise_launch_plan.argtypes = \
        cuda_lib._SIGNATURES['pairwise_launch_plan']
    lib.pairwise_launch_plan.restype = ctypes.c_int
    lib.pairwise_prof_read.argtypes = [ctypes.c_void_p]
    lib.pairwise_prof_read.restype = ctypes.c_int
    return lib


def main():
    lib = build()
    dev = torch.device('cuda', 0)
    rng = np.random.default_rng(0)
    pairs = synth.banded_tasks(rng, [1300] * 12)
    shapes = {
        'consensus': ([p[0] for p in pairs], [p[1] for p in pairs]),
        'mixed': synth.sized_pairs(rng, [(int(x), int(x * 1.05)) for x in
                                         rng.integers(100, 2000, 12)]),
        'wide': synth.sized_pairs(rng, [(128, 131072), (120, 131000)])}
    plans = {'consensus': [(1, 192, 8), (2, 96, 8), (4, 64, 8)],
             'mixed': [(1, 256, 8), (2, 128, 8)],
             'wide': [(1, 128, 1), (4, 32, 1)]}
    scoring = pw.Scoring(3, -6, -5, -2)
    for name, (qs, rs) in shapes.items():
        host = pack_pairs(qs, rs, max(len(q) for q in qs),
                          max(len(r) for r in rs))
        up = [torch.from_numpy(x).to(dev) for x in host]
        B, n_pad = host[0].shape
        m_pad = host[2].shape[1]
        for need_moves in (True, False):
            for plan in plans[name]:
                moves = torch.empty((B, n_pad, pw.moves_stride(m_pad)),
                                    dtype=torch.uint8,
                                    device=dev) if need_moves else None
                outs = [torch.empty(B, dtype=torch.int32, device=dev)
                        for _ in range(3)]
                caps = torch.empty((B, pw.caps_width(n_pad, m_pad)),
                                   dtype=torch.int32, device=dev)
                args = [up[0].data_ptr(), up[2].data_ptr(), up[1].data_ptr(),
                        up[3].data_ptr(), None, None,
                        moves.data_ptr() if need_moves else None] + \
                    [o.data_ptr() for o in outs] + [None, caps.data_ptr(), B,
                                                    n_pad, m_pad, 3,
                                                    -6, -5, -2, 1, 1, 1, 1,
                                                    *plan, cuda_lib.stream_ptr(dev)]
                for _ in range(2):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    cuda_lib.check(lib.pairwise_launch_plan(*args), 'prof')
                    e1.record()
                    torch.cuda.synchronize()
                prof = np.zeros((2, 8), np.int64)
                cuda_lib.check(lib.pairwise_prof_read(prof.ctypes.data),
                               'prof read')
                steps = int(host[3][0]) // 4 + 1 + 31
                print('%s moves=%s plan %s: %.4f ms; cycles a step %s'
                      % (name, need_moves, plan, e0.elapsed_time(e1),
                         ' | '.join('warp %d: %s' % (w, ', '.join(
                             '%s %.0f' % (ph, prof[w, k] / steps)
                             for k, ph in enumerate(PHASES)))
                                    for w in range(2))), flush=True)


if __name__ == '__main__':
    main()
