"""The polish round's batched votes (native/votes.cpp through
ops/votes.add_batch) against the per-alignment numpy path they replace.

Random alignments from a seeded RNG over targets with homopolymers and
tandem repeats (so indels shift), with non-ACGT codes, reads cut short,
qualities absent, empty CIGARs, runs clipped at j < 0 and j >= n and
insertions at columns 0 and n. left_align_batch gives left_align_indels'
runs; add_batch leaves every accumulator and every insertion list as the
port's and the JAX package's add_alignment do; the consensus call is
byte-identical through both; and a polish round's _vote gives the same
through the batch and through its fallback without the native library.
"""

from collections import Counter

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per test process)

from unicycler_tpu.ops import votes as jvotes

from unicycler_tpu_torch import native, synth
from unicycler_tpu_torch.asm import polish as tpol
from unicycler_tpu_torch.ops import votes as tvotes
from unicycler_tpu_torch.utils import trace

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason='no C++ toolchain for the native '
                                       'library')


def _target(rng, n):
    """n codes of random stretches, homopolymers and tandem repeats, with
    a few N (code 4)."""
    parts, total = [], 0
    while total < n:
        kind = rng.integers(3)
        if kind == 0:
            part = rng.integers(0, 4, rng.integers(1, 20))
        elif kind == 1:
            part = np.full(rng.integers(2, 9), rng.integers(0, 4))
        else:
            part = np.tile(rng.integers(0, 4, rng.integers(2, 5)),
                           rng.integers(2, 5))
        parts.append(part)
        total += len(part)
    codes = np.concatenate(parts)[:n].astype(np.int8)
    codes[rng.random(n) < 0.005] = 4
    return codes


def _alignment(rng, r, j0, end, planted=None):
    """A read over r[j0:end) (columns below 0 get random bases) and its
    CIGAR as [(count, op)]: substitutions, deletions, insertions that
    repeat the bases before them or are random, the `planted` {column:
    texts} insertions (one text drawn a read), and same-op runs left
    unmerged now and then. Returns (cigar, i0, read codes)."""
    i0 = int(rng.integers(0, 6))
    read = list(rng.integers(0, 4, i0))
    ops = []

    def insert(text):
        read.extend(text)
        ops.extend([1] * len(text))

    for j in range(j0, end):
        if planted and j in planted and rng.random() < 0.85:
            texts = planted[j]
            insert(texts[rng.integers(len(texts))])
        elif rng.random() < 0.05:
            c = int(rng.integers(1, 5))
            if rng.random() < 0.6 and len(read) >= c:
                insert(list(read[-c:]))          # a tandem copy
            else:
                insert(list(rng.integers(0, 5, c)))
        u = rng.random()
        if u < 0.05:
            ops.append(2)
            continue
        base = int(r[j]) if 0 <= j < len(r) else int(rng.integers(0, 4))
        if u < 0.09:
            base = int(rng.integers(0, 5))
        read.append(base)
        ops.append(0)
    if planted and end in planted and rng.random() < 0.85:
        texts = planted[end]
        insert(texts[rng.integers(len(texts))])
    cigar = []
    for op in ops:
        if cigar and cigar[-1][1] == op and rng.random() > 0.05:
            cigar[-1][0] += 1
        else:
            cigar.append([1, op])
    cigar = [(c, 'MID'[op]) for c, op in cigar]
    return cigar, i0, np.array(read, np.int8)


def _round(seed, n_aln=40, clip=True, cut_reads=True, planted=False):
    """(targets {name: codes}, column counts {name: n}, alignments as
    add_batch takes them)."""
    rng = np.random.default_rng(seed)
    refs, cols, alignments = {}, {}, []
    for t in range(3):
        name = 'u%d' % t
        refs[name] = _target(rng, int(rng.integers(300, 900)))
        # votes may end before the target: runs past n are clipped
        cols[name] = len(refs[name]) - (int(rng.integers(0, 60))
                                        if clip else 0)
    plants = {}
    if planted:
        for name, r in refs.items():
            n = cols[name]
            at = [0, n] + rng.choice(np.arange(1, n), 12,
                                     replace=False).tolist()
            plants[name] = {
                int(p): [list(rng.integers(0, 4, rng.integers(1, 4)))
                         for _ in range(int(rng.integers(1, 4)))]
                for p in at}
    for k in range(n_aln):
        name = 'u%d' % rng.integers(3)
        r = refs[name]
        if k % 13 == 5:
            cigar, i0, j0 = [], 0, 0
            read = rng.integers(0, 4, 50).astype(np.int8)
        else:
            lo = -int(rng.integers(1, 80)) if clip and k % 5 == 0 else 0
            j0 = int(rng.integers(lo, len(r) // 2))
            end = int(rng.integers(j0 + 1, len(r) + 1))
            if k % 7 == 3:
                j0, end = 0, min(len(r), 200)
            elif k % 7 == 4:
                j0 = max(0, len(r) - 200)
                end = len(r)
            cigar, i0, read = _alignment(rng, r, j0, end,
                                         plants.get(name))
            if cut_reads and k % 6 == 1 and len(read) > 20:
                read = read[:len(read) - int(rng.integers(1, 20))]
        if k % 4 == 2:
            qual = np.zeros(len(read), np.uint8)       # qualities absent
        else:
            qual = rng.integers(0, 94, len(read)).astype(np.uint8)
        alignments.append((name, cigar, i0, j0, read, qual))
    return refs, cols, alignments


def _python_votes(module, refs, cols, alignments, left_align=True):
    votes = {name: module.ColumnVotes(n) for name, n in cols.items()}
    for name, cigar, i0, j0, codes, qual in alignments:
        runs = (module.left_align_indels(cigar, codes, refs[name], i0, j0)
                if left_align else cigar)
        votes[name].add_alignment(runs, i0, j0, codes,
                                  qual.astype(np.int64))
    return votes


def _state(v):
    return (v.base.tolist(), v.qual.tolist(), v.gap.tolist(),
            v.cover.tolist(), list(v.ins.items()))


def _left_align_raises(refs, alignments):
    for name, cigar, i0, j0, codes, _ in alignments:
        try:
            tvotes.left_align_indels(cigar, codes, refs[name], i0, j0)
        except IndexError:
            return True
    return False


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_left_align_batch_matches_left_align_indels(seed):
    refs, cols, alignments = _round(seed, n_aln=80, cut_reads=False)
    names = list(refs)
    cigars = [tvotes.cigar_arrays(a[1]) for a in alignments]
    counts, run_off = tvotes._concat([c for c, _ in cigars], np.int64)
    ops = tvotes._concat([o for _, o in cigars], np.int8)[0]
    codes, code_off = tvotes._concat([a[4] for a in alignments], np.int8)
    ref_codes, ref_off = tvotes._concat([refs[n] for n in names], np.int8)
    target = np.array([names.index(a[0]) for a in alignments], np.int64)
    i0 = np.array([a[2] for a in alignments], np.int64)
    j0 = np.array([a[3] for a in alignments], np.int64)
    out_counts, out_ops, out_off = tvotes.left_align_batch(
        native.get_lib(), counts, ops, run_off, codes, code_off, i0, j0,
        target, ref_codes, ref_off)
    shifted = 0
    for k, (name, cigar, a_i0, a_j0, read, _) in enumerate(alignments):
        want = tvotes.left_align_indels(cigar, read, refs[name], a_i0, a_j0)
        got = slice(out_off[k], out_off[k + 1])
        assert out_counts[got].tolist() == want.counts.tolist()
        assert out_ops[got].tolist() == want.op_codes.tolist()
        merged = []
        for c, op in cigar:
            if merged and merged[-1][1] == op:
                merged[-1][0] += c
            else:
                merged.append([c, op])
        shifted += len(want.counts) != len(merged) or any(
            c != m[0] for c, m in zip(want.counts.tolist(), merged))
    assert shifted >= 10          # the inputs made indels move


@pytest.mark.parametrize('seed,left_align', [(0, True), (1, True),
                                             (2, True), (3, True),
                                             (4, False), (5, False)])
def test_add_batch_matches_add_alignment(seed, left_align):
    refs, cols, alignments = _round(seed, cut_reads=not left_align)
    if left_align:
        assert not _left_align_raises(refs, alignments)
    want = _python_votes(tvotes, refs, cols, alignments, left_align)
    jax_want = _python_votes(jvotes, refs, cols, alignments, left_align)
    got = {name: tvotes.ColumnVotes(n) for name, n in cols.items()}
    assert tvotes.add_batch(got, alignments, refs if left_align else None)
    assert any(v._records is not None for v in got.values())
    for name in cols:
        # read through the records, before `ins` builds the lists
        at = np.nonzero(got[name].ins_counts())[0]
        assert got[name].ins_texts(at) == \
            [[s for s, _ in want[name].ins[p]] for p in at.tolist()]
        state = _state(want[name])
        assert _state(got[name]) == state
        assert _state(jax_want[name]) == state
    assert sum(len(v.ins) for v in got.values()) >= 10


@pytest.mark.parametrize('seed,min_agreement', [(0, 0.0), (1, 0.0),
                                                (2, 0.9), (3, 0.9)])
def test_consensus_identical_through_both_paths(seed, min_agreement):
    refs, cols, alignments = _round(seed, n_aln=60, clip=False,
                                    cut_reads=False, planted=True)
    from unicycler_tpu_torch.io.fastx import decode_sequence
    graph = _Graph({name: _Segment(decode_sequence(r))
                    for name, r in refs.items()})
    want = _python_votes(tvotes, refs, cols, alignments)
    got = {name: tvotes.ColumnVotes(n) for name, n in cols.items()}
    assert tvotes.add_batch(got, alignments, refs)
    candidates = sum(int(np.count_nonzero(
        2 * got[n].ins_counts()[1:] > np.maximum(1, got[n].cover)))
        for n in refs)
    assert candidates >= 10
    polished = tpol._consensus(graph, got, min_agreement)
    assert polished == tpol._consensus(graph, want, min_agreement)
    if min_agreement == 0.0:      # planted insertions were accepted
        assert sum(map(len, polished.values())) > \
            sum(map(len, refs.values()))


def test_shift_past_a_read_end_raises_in_both():
    r = np.array([0, 1, 2, 2, 2, 3], np.int8)
    read = np.array([0, 1, 2, 2], np.int8)      # cut before its insertion
    cigar = [(4, 'M'), (2, 'I'), (2, 'M')]
    with pytest.raises(IndexError):
        tvotes.left_align_indels(cigar, read, r, 0, 0)
    votes = {'u': tvotes.ColumnVotes(len(r))}
    with pytest.raises(IndexError):
        tvotes.add_batch(votes, [('u', cigar, 0, 0, read,
                                  np.zeros(4, np.uint8))], {'u': r})


def test_insertions_keep_vote_order_across_both_paths():
    """add_alignment after add_batch, then a second batch: `ins` lists the
    votes in the order they were given."""
    refs, cols, alignments = _round(7, n_aln=45, cut_reads=False)
    want = _python_votes(tvotes, refs, cols, alignments)
    got = {name: tvotes.ColumnVotes(n) for name, n in cols.items()}
    assert tvotes.add_batch(got, alignments[:15], refs)
    for name, cigar, i0, j0, codes, qual in alignments[15:30]:
        got[name].add_alignment(
            tvotes.left_align_indels(cigar, codes, refs[name], i0, j0),
            i0, j0, codes, qual.astype(np.int64))
    assert tvotes.add_batch(got, alignments[30:], refs)
    for name in cols:
        assert _state(got[name]) == _state(want[name])
        counts = got[name].ins_counts()
        assert counts.tolist() == [len(got[name].ins.get(p, ()))
                                   for p in range(cols[name] + 1)]


class _Segment(object):
    def __init__(self, seq):
        self.forward_sequence = seq

    def get_length(self):
        return len(self.forward_sequence)


class _Graph(object):
    def __init__(self, segments):
        self.segments = segments


@pytest.fixture(scope='module')
def polish_inputs():
    """Each polish_round's (task_meta, results, ref_by_name) on a 6 kbp
    draft with errors: reads of both strands, a third without
    qualities."""
    from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme
    from unicycler_tpu_torch.io.fastx import Read, encode_sequence
    rng = np.random.default_rng(11)
    truth = synth.random_replicons(rng, [6000])[0]
    draft = synth._to_str(synth._mutate(rng, encode_sequence(truth),
                                        0.01, 0.01, 0.02))
    reads = []
    for k, (name, seq, _) in enumerate(synth.simulate_read_set(
            rng, [truth], 8, n50=1500, min_len=800, max_len=2500)):
        read = Read(name, seq, '5' * len(seq))
        if k % 3 == 0:
            read.qualities = ''
        reads.append(read)
    scoring = AlignmentScoringScheme('3,-6,-5,-2').to_ops()
    seen = {}
    real_vote = tpol._vote

    def spy(graph, task_meta, results, ref_by_name, *rest):
        seen.setdefault('calls', []).append((task_meta, results,
                                             ref_by_name))
        return real_vote(graph, task_meta, results, ref_by_name, *rest)

    tpol._vote = spy
    try:
        graph = _Graph({'1': _Segment(draft)})
        for multi in (False, True):
            tpol.polish_round(graph, reads, scoring, multi_place=multi,
                              min_agreement=0.9 if multi else 0.0,
                              device='cpu')
    finally:
        tpol._vote = real_vote
    return graph, seen['calls']


@pytest.mark.parametrize('call,min_agreement', [(0, 0.0), (0, 0.9),
                                                (1, 0.9)])
def test_vote_fallback_equals_batch(polish_inputs, monkeypatch, call,
                                    min_agreement):
    graph, calls = polish_inputs
    task_meta, results, ref_by_name = calls[call]
    strands = Counter(a.read_strand for _, _, _, a in task_meta)
    assert strands['+'] and strands['-']

    def vote():
        trace.reset()
        trace.enable()
        try:
            out = tpol._vote(graph, task_meta, results, ref_by_name,
                             min_agreement, True, 0.0, {})
            return out, trace.as_dict()
        finally:
            trace.disable()
            trace.reset()

    (batch, _, _, bvotes), bt = vote()
    monkeypatch.setattr(native, 'get_lib', lambda: None)
    (python, _, _, pvotes), pt = vote()
    assert batch == python
    assert batch['1'] != graph.segments['1'].forward_sequence
    assert _state(bvotes['1']) == _state(pvotes['1'])
    voted = pt['spans']['left_align']['calls']
    assert bt['counters'] == {'votes.native_alignments': voted}
    assert pt['counters'] == {'votes.python_alignments': voted}
