"""(e) The whole slice: the port's align_jobs on the CPU equals the JAX
package's align_jobs on the CPU on a small two-replicon genome with long
reads at 8% error on both strands: per read, every alignment's reference,
strand, spans, raw score and CIGAR, exactly. (g) The state carried over
from the JAX package (scoring scheme and minimiser index) converts into
the port's with identical arrays."""

import random

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per process)

from unicycler_tpu_torch import synth


def _workload(seed):
    rng = np.random.default_rng(seed)
    reps = synth.random_replicons(rng, [24000, 6000])
    reads = synth.simulate_reads(rng, reps, 8, n50=2500, min_len=1000,
                                 max_len=4000)
    return reps, reads


def _run(pkg, reps, reads, sensitivity, **kw):
    fastx = __import__(pkg + '.io.fastx', fromlist=['x'])
    scoring = __import__(pkg + '.align.scoring', fromlist=['x'])
    sg = __import__(pkg + '.align.semi_global', fromlist=['x'])
    refs = [fastx.Reference(str(i + 1), s) for i, s in enumerate(reps)]
    rd = [fastx.Read(n, s, None) for n, s, _ in reads]
    random.seed(0)     # conflict-filter ties are broken with random()
    sg.align_jobs([sg.AlignJob(rd, refs,
                               scoring.AlignmentScoringScheme('3,-6,-5,-2'),
                               sensitivity_level=sensitivity)], **kw)
    return [[(a.ref.name, bool(a.rev_comp), a.read_start_pos,
              a.read_end_pos, a.ref_start_pos, a.ref_end_pos, a.raw_score,
              [(int(c), str(op)) for c, op in a._pair.cigar])
             for a in r.alignments] for r in rd]


@pytest.mark.parametrize('seed,sensitivity', [(1, 0), (2, 1)])
def test_align_jobs_cpu_matches_jax(seed, sensitivity):
    reps, reads = _workload(seed)
    want = _run('unicycler_tpu', reps, reads, sensitivity)
    got = _run('unicycler_tpu_torch', reps, reads, sensitivity,
               device='cpu')
    assert got == want
    # the workload is real: most reads land on their true origin
    placed = 0
    for alns, (_, _, truth) in zip(got, reads):
        if alns:
            best = max(alns, key=lambda a: a[6])
            placed += (best[0] == str(truth.replicon + 1)
                       and best[1] == truth.rev_comp
                       and abs(best[4] - truth.start) <= 100)
    assert placed >= len(reads) - 1


def test_port_state_from_jax_state():
    from unicycler_tpu.align.scoring import AlignmentScoringScheme
    from unicycler_tpu.ops.minimizer import MinimizerIndex as JIndex
    from unicycler_tpu_torch.ops.minimizer import MinimizerIndex as TIndex
    from unicycler_tpu_torch.ops.pairwise import Scoring
    from unicycler_tpu_torch.state import port_state

    reps, _ = _workload(3)
    codes = [np.frombuffer(s.encode(), np.uint8) for s in reps]
    lut = np.full(256, 4, np.int8)
    for i, b in enumerate(b'ACGT'):
        lut[b] = i
    codes = [lut[c] for c in codes]
    jax_scoring = AlignmentScoringScheme('3,-6,-5,-2').to_ops()
    jax_index = JIndex(codes, k=15, w=10)
    scoring, index = port_state(jax_scoring, jax_index)
    assert scoring == Scoring(3, -6, -5, -2)
    own = TIndex(codes, k=15, w=10)
    for name in ('ref_lengths', 'hashes', 'ref_ids', 'positions',
                 'strands'):
        np.testing.assert_array_equal(getattr(index, name),
                                      getattr(jax_index, name))
        np.testing.assert_array_equal(getattr(index, name),
                                      getattr(own, name))
        assert getattr(index, name).dtype == getattr(own, name).dtype
    assert (index.k, index.w) == (own.k, own.w)
    read = codes[0][5000:8000]
    assert [c.anchors_ref.tolist() for c in index.lookup(read)] == \
        [c.anchors_ref.tolist() for c in own.lookup(read)]
