"""Traceback walk over the banded kernel's moves: the CUDA kernel and its
plain PyTorch version.

Counterpart of unicycler_tpu/ops/pallas_traceback.py (traceback_device).
The walk starts at each task's selected end cell and follows the 4-bit
moves that ops/banded_kernel.py writes ((B, n_pad, W/8) int32 nibble
planes; row i covers columns [crow[i - 1], crow[i - 1] + W)), writing one
int32 record per visited row,

    record = (d_count << 3) | move_bits
      move_bits: 1 = an M step left the row, 2 = an I step left it
      d_count:   D steps taken on the row

and the walk's final (i, j, stop code): 0 = walked to row 0, 1 = stopped
at column 0 in state H, 2 = band escape (the caller decodes that task's
moves on the host). tape_kernels.records_to_cigar turns records into a
CIGAR. 4 bytes per row come back to the host instead of the W/2 bytes of
a moves row.

banded_traceback launches csrc/banded_walk.cu for tensors on a CUDA device
and runs banded_traceback_plain only for tensors on the CPU.
"""

import torch

from . import cuda_lib


def banded_traceback_plain(moves, crow, end_i, end_j, W: int):
    """Plain PyTorch version of the walk: every task steps at once, one
    loop iteration per path step. moves (B, n_pad, W/8) int32, crow
    (B, n_pad) int32 (c[:, 1:]), end_i / end_j (B,). Returns (records
    (B, n_pad) int32, final (B, 3) int32)."""
    B, n_pad, w8 = moves.shape
    dev = moves.device
    i64 = torch.int64
    mv = moves.to(i64)
    cr = crow.to(i64)
    bidx = torch.arange(B, device=dev)
    i = end_i.to(i64).clone()
    j = end_j.to(i64).clone()
    s = torch.zeros(B, dtype=i64, device=dev)
    done = torch.full((B,), -1, dtype=i64, device=dev)
    rec = torch.zeros((B, n_pad), dtype=i64, device=dev)
    while True:
        active = (done == -1) & (i > 0)
        if not bool(active.any()):
            break
        col0_stop = (s == 0) & (j == 0)
        t = (i - 1).clamp(0, n_pad - 1)
        lane = j - cr[bidx, t]
        word = mv[bidx, t, torch.remainder(lane, w8)]
        nib = torch.div(lane, w8, rounding_mode='floor').clamp(0, 7)
        cell = (word >> (4 * nib)) & 0xF
        band_escape = (lane < 0) | (lane >= W)
        act = torch.where(s == 1, 1, torch.where(s == 2, 2, cell & 3))
        is_m, is_d, is_i = act == 0, act == 1, act == 2
        inc = torch.where(is_m, 1, torch.where(is_i, 2, 8))
        rec[bidx[active], t[active]] += inc[active]
        ni = torch.where(is_m | is_i, i - 1, i)
        nj = torch.where(is_m | is_d, j - 1, j)
        e_ext = ((cell >> 2) & 1) == 1
        f_ext = ((cell >> 3) & 1) == 1
        ns = torch.where(is_d & e_ext & (nj > 0), 1,
                         torch.where(is_i & f_ext & (ni > 0), 2, 0))
        nd = torch.where(col0_stop, 1, torch.where(band_escape, 2, -1))
        step = active & (nd == -1)
        i = torch.where(step, ni, i)
        j = torch.where(step, nj, j)
        s = torch.where(step, ns, s)
        done = torch.where(active, nd, done)
    final = torch.stack([i, j, torch.where(done == -1, 0, done)], 1)
    return rec.to(torch.int32), final.to(torch.int32)


def banded_traceback_cuda(moves, crow, end_i, end_j, W: int):
    """Launch csrc/banded_walk.cu; same contract as the plain version."""
    B, n_pad, w8 = moves.shape
    dev = moves.device
    for name, x in (('moves', moves), ('crow', crow), ('end_i', end_i),
                    ('end_j', end_j)):
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError('%s must be a contiguous int32 tensor on %s'
                             % (name, dev))
    if w8 * 8 != W or crow.shape != (B, n_pad) or end_i.shape != (B,) \
            or end_j.shape != (B,):
        raise ValueError('banded walk shapes do not match moves %s at W %d'
                         % (tuple(moves.shape), W))
    records = torch.zeros((B, n_pad), dtype=torch.int32, device=dev)
    final = torch.empty((B, 3), dtype=torch.int32, device=dev)
    lib = cuda_lib.lib()
    with cuda_lib.timed('banded_walk', dev, (records, final)):
        err = lib.banded_walk_launch(
            moves.data_ptr(), crow.data_ptr(), end_i.data_ptr(),
            end_j.data_ptr(), records.data_ptr(), final.data_ptr(), B,
            n_pad, W, cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, 'banded_walk')
    cuda_lib.LAUNCHES['banded_walk'] += 1
    return records, final


def banded_traceback(moves, crow, end_i, end_j, W: int):
    """Walk the moves of a banded batch on the tensors' device. Returns
    (records (B, n_pad) int32, final (B, 3) int32 = i, j, stop code)."""
    args = [x.to(torch.int32).contiguous() for x in (moves, crow, end_i,
                                                     end_j)]
    if moves.device.type == 'cuda':
        return banded_traceback_cuda(*args, W)
    if moves.device.type == 'cpu':
        return banded_traceback_plain(*args, W)
    raise ValueError('unsupported device %s' % moves.device)
