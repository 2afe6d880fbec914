"""Where kernel 7's time goes: cycles a group by phase.

Writes a copy of csrc/wavefront_fwd.cu with clock64() marks into the build
directory and builds it with the package's nvcc flags. For lane 0 of each
warp of block 0 (task 0, cluster rank 0) the copy sums, over the groups:
the wait for the group's staged bases, the issue of the carry loads, the
32 steps (split by the interior fast path and the masked path, the
latter also over the groups that capture, carry-load latency included), the carry stores and the group's barrier. It runs
chip_smoke.py's phase 9 shapes at their launch plans and prints one line
`WAVEFRONT_PROFILE {json}`. The marks slow the kernel a little; the printed
times are the marked copy's. The anchors must match the source, so update
them with the kernel. Needs a CUDA card:

    python -m unicycler_tpu_torch.tools.wavefront_profile
"""

import ctypes
import json
import os
import subprocess

import torch

from ..ops import cuda_lib
from ..ops import wavefront as wf
from ..ops.pairwise import SEMI_GLOBAL, Scoring
from .wavefront_ab import device_ms, microbench_tasks

MAX_WARPS = 16

SHAPES = (('W512 d0', 512, 0, 2048, 8), ('W1024 d0', 1024, 0, 2048, 8),
          ('W2048 d4', 2048, 4, 2048, 8), ('W4096 d4 short', 4096, 4, 256, 8),
          ('W1024 d4 x160', 1024, 4, 1024, 160))


def _patch(src, marks):
    for old, new in marks:
        if src.count(old) != 1:
            raise RuntimeError('csrc/wavefront_fwd.cu changed: no single %r'
                               % old)
        src = src.replace(old, new)
    return src


def profile_source():
    with open(os.path.join(cuda_lib.CSRC_DIR, 'wavefront_fwd.cu')) as f:
        s = f.read()
    marks = [
        ('namespace {\n',
         'namespace {\n__device__ long long g_prof[%d][10];\n' % MAX_WARPS),
        ('  for (int g = 0; g < ngt; ++g) {\n',
         '  for (int g = 0; g < ngt; ++g) {\n'
         '    long long T0 = clock64(), T1 = 0, T2 = 0, T3 = 0, T4 = 0;\n'
         '    bool IN = false;\n'),
        ('      cp_async_wait_1();\n      __syncwarp();\n',
         '      cp_async_wait_1();\n      __syncwarp();\n'
         '      T1 = clock64();\n'),
        ("      // cells of the window's band pairs",
         "      T2 = clock64();\n      // cells of the window's band pairs"),
        ("      // the owned lanes' carries for the next group",
         "      T3 = clock64();\n      IN = inner;\n"
         "      // the owned lanes' carries for the next group"),
        ('    // the carries written; no block leaves',
         '    T4 = clock64();\n    // the carries written; no block leaves'),
        ('    else cluster.sync();\n  }\n}\n',
         '    else cluster.sync();\n'
         '    if (blockIdx.x == 0 && lane == 0) {\n'
         '      long long* r = g_prof[warp];\n'
         '      r[0] += 1; r[1] += T1 - T0; r[2] += T2 - T1;\n'
         '      r[IN ? 3 : 4] += T3 - T2; r[5] += IN; r[6] += T4 - T3;\n'
         '      r[7] += clock64() - T4;\n'
         '      if (!IN && gr.hit) { r[8] += T3 - T2; r[9] += 1; }\n'
         '    }\n  }\n}\n'),
        ('}  // namespace\n',
         '}  // namespace\n'
         'extern "C" int wf_prof(long long* out, int reset) {\n'
         '  if (reset) {\n'
         '    static long long z[%d][10] = {};\n'
         '    return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n'
         '  }\n'
         '  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n'
         '}\n' % MAX_WARPS),
    ]
    return _patch(s, marks)


def build():
    out = os.path.join(cuda_lib.BUILD_ROOT, 'wavefront_profile')
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, 'wavefront_prof.cu')
    with open(src, 'w') as f:
        f.write(profile_source())
    so = os.path.join(out, 'libwavefront_prof.so')
    subprocess.run([cuda_lib._nvcc()] + cuda_lib.NVCC_FLAGS
                   + ['-shared', '-o', so, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.wavefront_fwd_launch.argtypes = \
        cuda_lib._SIGNATURES['wavefront_fwd_launch']
    lib.wavefront_fwd_launch.restype = ctypes.c_int
    lib.wf_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.wf_prof.restype = ctypes.c_int
    return lib


def main():
    dev = torch.device('cuda', 0)
    scoring = Scoring(3, -6, -5, -2)
    cuda_lib.lib()
    prof = build()
    kept = cuda_lib._LIB
    cuda_lib._LIB = prof     # the wrapper launches the marked copy
    rows = []
    try:
        for label, W, drift, n, B in SHAPES:
            q, r, c_rows, n_acts, m_acts = microbench_tasks(n, W, drift, B)
            staged = wf._prepare(q, r, c_rows, n_acts, m_acts, W)
            up = [torch.from_numpy(x).to(dev) for x in staged[:4]]
            fwd = lambda: wf.wavefront_forward_cuda(
                *up, W=W, Wcap=staged[6], a_lo=staged[4], scoring=scoring,
                config=SEMI_GLOBAL)
            fwd()
            torch.cuda.synchronize()
            cuda_lib.check(prof.wf_prof(None, 1), 'wf_prof')
            ms, _ = device_ms(cuda_lib, fwd, reps=1)
            sums = torch.zeros((MAX_WARPS, 10), dtype=torch.int64)
            cuda_lib.check(prof.wf_prof(sums.data_ptr(), 0), 'wf_prof')
            warps = []
            for w in range(MAX_WARPS):
                s = sums[w].tolist()
                if not s[0]:
                    continue
                inner, masked = s[5], s[0] - s[5]
                warps.append({
                    'warp': w, 'groups': s[0], 'inner_groups': inner,
                    'stage_wait': s[1] / s[0], 'carry_issue': s[2] / s[0],
                    'steps_inner': s[3] / max(inner, 1),
                    'steps_masked': s[4] / max(masked, 1),
                    'masked_capture_groups': s[9],
                    'steps_masked_capture': s[8] / max(s[9], 1),
                    'stores': s[6] / s[0], 'barrier': s[7] / s[0]})
            rows.append({'shape': label, 'W': W, 'tasks': B,
                         'plan': wf.launch_plan(B, W), 'ms': ms,
                         'groups': staged[5], 'cycles_a_group': warps})
    finally:
        cuda_lib._LIB = kept
    print('WAVEFRONT_PROFILE ' + json.dumps({
        'device': torch.cuda.get_device_name(0), 'rows': rows}), flush=True)


if __name__ == '__main__':
    main()
