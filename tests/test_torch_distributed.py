"""The port's multi-process layer (parallel/distributed.py) on
torch.distributed with the gloo backend, against the JAX package.

Two spawned ranks meet over gloo on localhost, shard
test_distributed.py's read set, align their shards on the CPU and
allgather the results: both must end with the same full read->alignments
map, equal to the JAX package's single-process align_reads_to_refs run
in this process (exact: coordinates, scores, CIGARs). The children import
torch and the port only (tests/torch_dist_workers.py).
"""

import pytest

import torch_dist_workers as w

from unicycler_tpu.align.scoring import AlignmentScoringScheme as JScheme
from unicycler_tpu.align.semi_global import align_reads_to_refs as jalign
from unicycler_tpu.io.fastx import Read as JRead
from unicycler_tpu.io.fastx import Reference as JReference

from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme
from unicycler_tpu_torch.io.fastx import Read, Reference
from unicycler_tpu_torch.parallel import distributed as dist


def _jax_map():
    ref_seq, read_data = w.alignment_workload()
    reads = [JRead(name, seq, '+' * len(seq)) for name, seq in read_data]
    jalign(reads, [JReference('ref', ref_seq)], JScheme('3,-6,-5,-2'),
           **w.ALIGN_KWARGS)
    return w.alignment_map(reads)


@pytest.fixture(scope='module')
def two_ranks():
    jax_map = []
    ranks = w.run_ranks(w.align_rank, 2,
                        meanwhile=lambda: jax_map.append(_jax_map()))
    return ranks, jax_map[0]


def test_two_ranks_match_jax_single_process(two_ranks):
    two_ranks, want = two_ranks
    assert any(want.values()), 'the reference run found no alignments'
    for rank, (index, count, n_local, _, amap) in enumerate(two_ranks):
        assert (index, count, n_local) == (rank, 2, 3)
        assert amap == want


def test_allgather_bytes_unequal_and_empty(two_ranks):
    for _, _, _, (unequal, empty, objs), _ in two_ranks[0]:
        assert unequal == [b'', b'rank1' * 3]
        assert empty == [b'', b'']
        assert objs == [{'rank': 0}, {'rank': 1}]


def test_single_process_is_a_no_op(monkeypatch):
    for name in ('UNICYCLER_TPU_COORDINATOR', 'UNICYCLER_TPU_NUM_PROCESSES',
                 'UNICYCLER_TPU_PROCESS_ID'):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(dist, '_CONTEXT', None)
    ctx = dist.maybe_initialize()
    assert (ctx.index, ctx.count, ctx.is_main, ctx.active) == (0, 1, True,
                                                              False)
    assert dist.maybe_initialize() is ctx and dist.get_context() is ctx
    assert dist.shard_for_host(range(5)) == list(range(5))
    assert dist.allgather_bytes(b'xyz') == [b'xyz']
    assert dist.allgather_object({'a': 1}) == [{'a': 1}]
    ref_seq, read_data = w.alignment_workload()
    reads = [Read(name, seq, '+' * len(seq)) for name, seq in read_data]
    n_local = dist.distributed_align_long_reads(
        reads, [Reference('ref', ref_seq)], AlignmentScoringScheme('3,-6,-5,-2'),
        device='cpu', **w.ALIGN_KWARGS)
    assert n_local == 6
    assert w.alignment_map(reads) == _jax_map()


def test_shard_for_host_is_strided():
    ctx = dist.DistContext(1, 3)
    assert dist.shard_for_host(list(range(8)), ctx) == [1, 4, 7]
    assert not dist.DistContext(1, 3).is_main
