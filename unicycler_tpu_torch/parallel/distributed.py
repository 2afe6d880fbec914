"""Multi-process scale-out on torch.distributed (counterpart of
unicycler_tpu/parallel/distributed.py).

One process a card (or a host) joins a process group; long reads are
sharded across the processes, each process aligns its shard with the
normal single-process aligner on its own card, and the per-read results
merge over the group so every process ends with the full map. Graph
stages run replicated: the graph is small and the pipeline is
deterministic, so every process computes the same result and only the
main process writes the log.

Initialisation is env-driven, so the same command line works in one
process (no variables: a no-op) and under any launcher that can export
three variables:

    UNICYCLER_TPU_COORDINATOR=host:port
    UNICYCLER_TPU_NUM_PROCESSES=N
    UNICYCLER_TPU_PROCESS_ID=i

The group uses the gloo backend over TCP (init_method tcp://host:port)
and carries only host bytes: the alignments themselves run on each
process's card, the caller's `device` as everywhere. Which card a process
sees is the launcher's choice (CUDA_VISIBLE_DEVICES). If a launcher has
already initialised a process group, its rank and size are read instead.
A failed rendezvous or collective raises; nothing falls back to one
process.

Trace: span `allgather` (both collectives of allgather_bytes) and counter
dist.allgather_bytes (the padded bytes each call gathers, all ranks').
"""

import os
import pickle

import numpy as np
import torch


class DistContext(object):
    """Process topology. count == 1 means a single process."""
    __slots__ = ('index', 'count')

    def __init__(self, index, count):
        self.index = index
        self.count = count

    @property
    def is_main(self):
        return self.index == 0

    @property
    def active(self):
        return self.count > 1


_CONTEXT = None


def maybe_initialize():
    """Join the process group named by the environment (a no-op and a
    single-process context when the variables are absent). Idempotent."""
    global _CONTEXT
    if _CONTEXT is not None:
        return _CONTEXT
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        _CONTEXT = DistContext(dist.get_rank(), dist.get_world_size())
        return _CONTEXT
    coord = os.environ.get('UNICYCLER_TPU_COORDINATOR')
    if not coord:
        _CONTEXT = DistContext(0, 1)
        return _CONTEXT
    n = int(os.environ['UNICYCLER_TPU_NUM_PROCESSES'])
    pid = int(os.environ['UNICYCLER_TPU_PROCESS_ID'])
    dist.init_process_group(backend='gloo', init_method='tcp://' + coord,
                            world_size=n, rank=pid)
    _CONTEXT = DistContext(dist.get_rank(), dist.get_world_size())
    return _CONTEXT


def get_context():
    """The current topology (initialising from env on first use)."""
    return _CONTEXT if _CONTEXT is not None else maybe_initialize()


def shard_for_host(items, ctx=None):
    """This process's strided shard of a work list. Strided (not blocked)
    so sorted-by-length inputs balance across processes."""
    ctx = ctx or get_context()
    if not ctx.active:
        return list(items)
    return list(items)[ctx.index::ctx.count]


def allgather_bytes(data: bytes, ctx=None):
    """All-to-all exchange of one byte string per process; returns every
    process's bytes in rank order. Two collectives on uint8 CPU tensors:
    sizes first, then zero-padded payloads (all_gather needs equal shapes
    per process)."""
    ctx = ctx or get_context()
    if not ctx.active:
        return [data]
    import torch.distributed as dist
    from ..utils import trace
    with trace.span('allgather'):
        arr = np.frombuffer(data, np.uint8)
        size = torch.tensor([len(arr)], dtype=torch.int64)
        sizes = [torch.zeros(1, dtype=torch.int64)
                 for _ in range(ctx.count)]
        dist.all_gather(sizes, size)
        sizes = [int(s.item()) for s in sizes]
        cap = max(max(sizes), 1)
        padded = torch.zeros(cap, dtype=torch.uint8)
        padded[:len(arr)] = torch.from_numpy(arr.copy())
        gathered = [torch.zeros(cap, dtype=torch.uint8)
                    for _ in range(ctx.count)]
        dist.all_gather(gathered, padded)
    trace.add('dist.allgather_bytes', cap * ctx.count)
    return [gathered[i][:sizes[i]].numpy().tobytes()
            for i in range(ctx.count)]


def allgather_object(obj, ctx=None):
    """All-to-all exchange of one picklable object per process."""
    return [pickle.loads(b)
            for b in allgather_bytes(pickle.dumps(obj, protocol=4), ctx)]


def distributed_align_long_reads(reads, references, scoring_scheme,
                                 ctx=None, device=None, **align_kwargs):
    """Shard `reads` across processes, align each shard with the normal
    single-process aligner on this process's `device`, and allgather the
    per-read alignment tuples so EVERY process ends with the full
    read->alignments mapping (the replicated graph stages need all of
    it). Returns the number of locally aligned reads."""
    from ..align.alignment import Alignment
    from ..align.semi_global import align_reads_to_refs
    ctx = ctx or get_context()
    local = shard_for_host(reads, ctx)
    align_reads_to_refs(local, references, scoring_scheme, device=device,
                        **align_kwargs)
    if not ctx.active:
        return len(local)
    # each local read's alignments, compactly: coordinates + CIGAR runs;
    # scores re-tally deterministically on the receiver
    payload = {}
    for read in local:
        payload[read.name] = [
            (a.ref.name, a.rev_comp, a.read_start_pos, a.read_end_pos,
             a.ref_start_pos, a.ref_end_pos,
             a._runs[0].tolist(), a._runs[1].tolist())
            for a in read.alignments]
    merged = {}
    for part in allgather_object(payload, ctx):
        merged.update(part)
    local_names = {r.name for r in local}
    refs_by_name = {ref.name: ref for ref in references}
    for read in reads:
        if read.name in local_names:   # locally computed: keep objects
            continue
        read.alignments = [
            Alignment.from_runs(read, refs_by_name[rn], scoring_scheme,
                                rev, rs, re_, fs, fe, counts, codes)
            for (rn, rev, rs, re_, fs, fe, counts, codes)
            in merged.get(read.name, [])]
    return len(local)
