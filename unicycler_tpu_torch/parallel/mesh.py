"""Multi-device scaling: read batches data-parallel over a device mesh
(counterpart of unicycler_tpu/parallel/mesh.py).

A mesh here is an ordered list of torch.devices, one entry a shard of
the batch axis. It may name one device more than once: the shards then
run one after another on that device, which is how a single card (or the
CPU, in the tests) exercises the multi-device code paths.

  * reference/contig index: replicated per process (megabytes);
  * read batches: split into equal slices along the batch axis, one a
    mesh entry, each computed on its entry's device (pure data parallel);
  * per-read summary statistics: partial (count, sum, max) on each
    device, reduced on the first.

Graph simplification stays on the host and replicated: it is sequential
and small.
"""

import numpy as np
import torch

from ..device import resolve_device


def get_mesh(devices=None):
    """A 1-D data-parallel mesh: the given devices (in order), or every
    CUDA device. Raises where there is no CUDA device to take."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device available for a mesh; pass '
                               'devices (e.g. ["cpu"] * 8) for the CPU')
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    mesh = [resolve_device(d) for d in devices]
    mesh = [torch.device('cuda', torch.cuda.current_device())
            if d.type == 'cuda' and d.index is None else d for d in mesh]
    if not mesh:
        raise ValueError('a mesh needs at least one device')
    if len({d.type for d in mesh}) != 1:
        raise ValueError('a mesh takes devices of one type, not %s' % mesh)
    return mesh


_DEFAULT_MESH = None


def set_default_mesh(mesh):
    """Install a mesh for the aligners: ops/banded.align_banded then
    partitions each call's tasks over its devices (align_banded_multi)."""
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


def get_default_mesh():
    return _DEFAULT_MESH


def _as_tensor(x, device):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def shard_batched_call(fn, mesh):
    """Wrap a batched function so its leading batch axis is split into
    len(mesh) equal slices, slice k computed by fn on mesh[k]'s device.
    The wrapped function takes numpy arrays or tensors and returns fn's
    outputs concatenated on mesh[0]'s device (None outputs stay None):
    equal to the unsharded call. Every slice is launched before any
    output is gathered, so CUDA devices run concurrently."""
    mesh = list(mesh)

    def sharded(*args):
        B = args[0].shape[0]
        if any(a.shape[0] != B for a in args) or B % len(mesh):
            raise ValueError('batch of %d does not split evenly over a '
                             'mesh of %d' % (B, len(mesh)))
        per = B // len(mesh)
        outs = []
        for k, dev in enumerate(mesh):
            outs.append(fn(*(_as_tensor(a[k * per:(k + 1) * per], dev)
                             for a in args)))
        first = mesh[0]
        gathered = []
        for parts in zip(*outs):
            gathered.append(None if parts[0] is None else
                            torch.cat([p.to(first) for p in parts]))
        return tuple(gathered)

    return sharded


def sharded_banded_align(mesh, q_batch, r_ext_batch, c_batch, n_acts, m_acts,
                         scoring, config, W, need_moves=False):
    """The banded DP with the batch dimension split over the mesh: kernel
    3 (ops/banded_kernel.banded_batch_cuda) on each device's slice of a
    CUDA mesh, its plain version on a CPU mesh. The batch size must be
    divisible by the mesh size. Returns (score, end_i, end_j, moves) on
    mesh[0]'s device (moves None without need_moves; rows at and past a
    task's n_act unspecified on CUDA, see banded_kernel)."""
    from ..ops.banded_kernel import banded_batch

    def kernel(q, r_ext, c, n, m):
        return banded_batch(q, r_ext, c, n, m, scoring, config, W,
                            need_moves)
    return shard_batched_call(kernel, mesh)(
        q_batch, r_ext_batch, c_batch, n_acts, m_acts)


def sharded_align_stats(mesh, scores):
    """Merge per-read alignment statistics over the mesh: aligned reads
    (score > 0), sum and max of the scores. Each device reduces its slice
    to a partial (count, sum, max); the partials reduce on mesh[0]. The
    batch size must be divisible by the mesh size."""
    mesh = list(mesh)
    if not isinstance(scores, torch.Tensor):
        scores = torch.from_numpy(np.asarray(scores, np.int32))
    if scores.shape[0] == 0 or scores.shape[0] % len(mesh):
        raise ValueError('%d scores do not split evenly over a mesh of %d'
                         % (scores.shape[0], len(mesh)))
    per = scores.shape[0] // len(mesh)
    partials = []
    for k, dev in enumerate(mesh):
        local = scores[k * per:(k + 1) * per].to(dev).to(torch.int64)
        partials.append(torch.stack([(local > 0).sum(), local.sum(),
                                     local.max()]))
    merged = torch.stack([p.to(mesh[0]) for p in partials])
    out = torch.stack([merged[:, 0].sum(), merged[:, 1].sum(),
                       merged[:, 2].max()]).cpu().tolist()
    return {'aligned': int(out[0]), 'score_sum': int(out[1]),
            'score_max': int(out[2])}
