"""Build and load the hand-written CUDA kernels of csrc/*.cu.

Each source is compiled by its own nvcc process (all started together) for
sm_90a, and the objects link into ONE shared library with a plain C
interface, loaded with ctypes. The library is built at first use into
_build/<hash of sources and flags>/ inside the package (git-ignored), so a
fresh checkout builds everything it runs. Every launch function returns
cudaGetLastError(); `check` turns a nonzero code into an exception. There
is no fallback: a failed build or launch raises.

LAUNCHES holds one plain integer per kernel. A wrapper adds one where it
launches its kernel and nowhere else, so a caller can reset the counts,
run the main path, and see which kernels it went through. Setting
TIMINGS to a list makes every launch append (name, start event, end
event, outputs) with CUDA events around the launch, for measuring the
kernels' device time on a real run; it is None (off) by default. Moves
arrays enter TIMINGS as storage-free stand-ins (shape_only), so a timed
run holds no more device memory than an untimed one.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_ROOT = os.path.join(_PKG_DIR, '_build')
SOURCES = ('wavetape_fwd.cu', 'wavetape_walk.cu', 'banded.cu', 'tape_fwd.cu',
           'tape_walk.cu', 'banded_walk.cu', 'wavefront_fwd.cu',
           'pairwise.cu', 'pairwise_walk.cu')
ARCH_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a']
NVCC_FLAGS = ARCH_FLAGS + ['-std=c++17', '-O3', '-Xcompiler', '-fPIC',
                           '-Xptxas', '-v', '-lineinfo']

LAUNCHES = {'wavetape_fwd': 0, 'wavetape_walk': 0, 'banded': 0,
            'tape_fwd': 0, 'tape_walk': 0, 'banded_walk': 0,
            'wavefront_fwd': 0, 'pairwise': 0, 'pairwise_walk': 0}

TIMINGS = None

_LIB = None
_LOCK = threading.Lock()


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    for env in ('CUDA_HOME', 'CUDA_PATH'):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                       'toolkit (set CUDA_HOME)')


def source_hash():
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for s in SOURCES:
        with open(os.path.join(CSRC_DIR, s), 'rb') as f:
            h.update(s.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels if this source hash has no library yet; returns
    the library path. The compiler's output (-Xptxas -v: registers and
    shared memory per kernel) is kept beside it in ptxas.log. Raises on
    any compiler failure."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    so_path = os.path.join(out_dir, 'libkernels.so')
    if os.path.exists(so_path):
        return so_path
    nvcc = _nvcc()
    tmp = '%s.%d.tmp' % (out_dir, os.getpid())
    os.makedirs(tmp, exist_ok=True)
    procs = []
    for s in SOURCES:
        obj = os.path.join(tmp, s.replace('.cu', '.o'))
        cmd = [nvcc] + NVCC_FLAGS + ['-c', os.path.join(CSRC_DIR, s),
                                     '-o', obj]
        procs.append((s, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, objs, failed = [], [], []
    for s, obj, p in procs:
        out, _ = p.communicate()
        logs.append('== %s\n%s' % (s, out))
        objs.append(obj)
        if p.returncode != 0:
            failed.append(s)
    if failed:
        raise RuntimeError('nvcc failed on %s:\n%s'
                           % (', '.join(failed), '\n'.join(logs)))
    link_cmd = [nvcc] + ARCH_FLAGS + [
        '-shared', '-o', os.path.join(tmp, 'libkernels.so')] + objs
    link = subprocess.run(link_cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError('nvcc link failed:\n' + link.stdout)
    with open(os.path.join(tmp, 'ptxas.log'), 'w') as f:
        f.write('\n'.join(logs))
    try:
        os.rename(tmp, out_dir)
    except OSError:          # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return so_path


_P = ctypes.c_void_p
_I = ctypes.c_int

_SIGNATURES = {
    # q_tape, LR, r_flat, M, plane, ngt, B, NG, moves, best, W,
    # match, mismatch, open, ext, free_start_s1, free_start_s2, stream
    'wavetape_fwd_launch': [_P, _I, _P, _I, _P, _P, _I, _I, _P, _P, _I,
                            _I, _I, _I, _I, _I, _I, _P],
    # W, *blocks per SM, *threads per block
    'wavetape_fwd_occupancy': [_I, _P, _P],
    # moves, db_rows, n_tasks, end_i, end_j, abase, records, fin,
    # B, LA, W, TT, stream
    'wavetape_walk_launch': [_P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _P],
    # *blocks per SM, *tracks per block
    'wavetape_walk_occupancy': [_P, _P],
    # q, n_pad, r_ext, RL, c, n_acts, m_acts, moves, score, end_i, end_j,
    # scratch, B, W, match, mismatch, open, ext, fs1, fs2, fe1, fe2,
    # lanes a thread, stream
    'banded_launch': [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # rowinfo, gplane, r_flat, M, ngt, moves, hatn, best, scratch, B, L,
    # W, GWp, cluster size, match, mismatch, open, ext, free_start_s1,
    # free_start_s2, stream
    'tape_fwd_launch': [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # cluster size, GWp, *clusters resident at once
    'tape_fwd_clusters': [_I, _I, _P],
    # moves, c_rel, jr_rows, n_tasks, end_abs, end_j, seg_start, records,
    # fin, B, L, GWp, W, TT, stream
    'tape_walk_launch': [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _P],
    # moves, crow, end_i, end_j, records, fin, B, n_pad, W, stream
    'banded_walk_launch': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # par, db, zq, zr, hatn, lcv, lci, scratch, B, W, Wcap, GWp, n_groups,
    # a_lo, cluster size, warps a block, segments a warp, global carries,
    # match, mismatch, open, ext, free_start_s1, free_start_s2, stream
    'wavefront_fwd_launch': [_P] * 8 + [_I] * 16 + [_P],
    # q, r, n_acts, m_acts, lower, upper, moves, score, end_i, end_j,
    # scratch, caps, B, n_pad, m_pad, match, mismatch, open, ext,
    # free_start_s1, free_start_s2, free_end_s1, free_end_s2, stream
    'pairwise_launch': [_P] * 12 + [_I] * 11 + [_P],
    # pairwise_launch's arguments, then rows a thread, threads a block,
    # blocks a cluster, stream
    'pairwise_launch_plan': [_P] * 12 + [_I] * 14 + [_P],
    # moves, score, end_i, end_j, out, B, n_pad, m_pad, the moves' row
    # stride, free_start_s1, free_start_s2, stream
    'pairwise_walk_launch': [_P] * 5 + [_I] * 6 + [_P],
}


def lib():
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so_path = build()
            handle = ctypes.CDLL(so_path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = handle
    return _LIB


class timed(object):
    """Context manager around one launch. It makes `device` the CUDA
    runtime's current device for the launch (the launch functions,
    cudaFuncSetAttribute and the occupancy queries act on the current
    device, so a launch on a tensor of cuda:1 must run with cuda:1
    current), and records CUDA events into TIMINGS when timing is on;
    `outputs` is kept for work counts read later."""

    def __init__(self, name, device, outputs=()):
        self.name, self.device, self.outputs = name, device, outputs

    def __enter__(self):
        import torch
        self.guard = torch.cuda.device(self.device)
        self.guard.__enter__()
        if TIMINGS is not None:
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        try:
            if TIMINGS is not None and exc[0] is None:
                import torch
                self.ev[1].record(torch.cuda.current_stream(self.device))
                TIMINGS.append((self.name, self.ev[0], self.ev[1],
                                self.outputs))
        finally:
            self.guard.__exit__(*exc)
        return False


def shape_only(x):
    """A meta tensor with x's shape and dtype (None for None): what a cost
    count needs of an output that is only measured by its size."""
    import torch
    return None if x is None else torch.empty(x.shape, dtype=x.dtype,
                                              device='meta')


def occupancy():
    """Resident blocks per SM of the wave kernels, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor at their launch shapes:
    {'wavetape_fwd': {W: (blocks, threads a block)}, 'wavetape_walk':
    (blocks, tracks a block)}."""
    handle = lib()
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    fwd = {}
    for W in (128, 256, 384, 512, 1024, 2048):
        check(handle.wavetape_fwd_occupancy(W, ctypes.byref(blocks),
                                            ctypes.byref(threads)),
              'wavetape_fwd_occupancy')
        fwd[W] = (blocks.value, threads.value)
    check(handle.wavetape_walk_occupancy(ctypes.byref(blocks),
                                         ctypes.byref(threads)),
          'wavetape_walk_occupancy')
    return {'wavetape_fwd': fwd,
            'wavetape_walk': (blocks.value, threads.value)}


def check(err, name):
    if err != 0:
        raise RuntimeError('%s: CUDA launch failed with error %d' % (name, err))


def stream_ptr(device):
    import torch
    return torch.cuda.current_stream(device).cuda_stream
