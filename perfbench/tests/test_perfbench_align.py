"""The align stage at a tiny size on the CPU route against the
reference, the run with its timed path broken underneath (correct comes
out false), and the control at a size a test can hold. A run's fault
between chips cannot happen in this one-chip cell."""

import functools

import numpy as np
import pytest
import torch

import cells
import faults


def _run(tmp_path, seed=2 ** 33 + 5, depth=0.4, sample=10, **tiny):
    import run
    root = cells.tree(tmp_path)
    b = cells.add_cell(root, cells.bench(), 'tiny', *cells.tiny_align(depth=depth, sample=sample, **tiny))
    code, res = run.main(['--workload', 'tiny', '--seed', str(seed),
                          '--seconds', '0', '--trace', '0'],
                         device='cpu', bench=b, root=root)
    assert code == 0
    return res


def test_stage_on_the_cpu_route_is_correct(tmp_path):
    res = _run(tmp_path)
    assert res['correct'], res['checks']
    assert res['checks']['reads_off']['value'] == 0
    assert res['checks']['cigar_off']['value'] == 0
    assert res['info']['alignments'] >= 8
    assert res['info']['sampled_reads'] == 10
    assert res['metrics']['read_kbp_per_s']['value'] > 0


def _unchanged(fn):
    @functools.wraps(fn)
    def wrapped(reads, *args, **kwargs):
        for read in reads:
            read.alignments = []
    return wrapped


def _altered(what):
    """The best-scoring alignment with a CIGAR of each traceback call (one
    that the program keeps), altered where the DP produces it: its score,
    or its last match turned into an insertion."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapped(tasks, *args, **kwargs):
            out = fn(tasks, *args, **kwargs)
            found = [(pa.score, k) for k, pa in enumerate(out)
                     if pa is not None and pa.cigar
                     and (what == 'score' or (pa.cigar[-1][1] == 'M'
                                              and pa.cigar[-1][0] > 1))]
            if not found:
                return out
            k = max(found)[1]
            pa = out[k]
            if what == 'score':
                out[k] = pa._replace(score=pa.score + 3)
            else:
                cig = list(pa.cigar)
                cig[-1] = (cig[-1][0] - 1, 'M')
                cig.append((1, 'I'))
                out[k] = pa._replace(cigar=cig)
            return out
        return wrapped
    return wrap


@pytest.mark.parametrize('fault', ['unchanged', 'half', 'altered_score',
                                   'altered_cigar'])
def test_broken_path_is_not_correct(tmp_path, monkeypatch, fault):
    from unicycler_tpu_torch.align import semi_global
    from unicycler_tpu_torch.ops import banded
    if fault.startswith('altered'):
        monkeypatch.setattr(banded, 'align_banded', _altered(
            fault.split('_')[1])(banded.align_banded))
    else:
        # half: the entry aligns the first half of the reads (faults.py)
        wrap = _unchanged if fault == 'unchanged' else \
            faults.FAULTS['semi_global_align']['half_reads'][2]
        monkeypatch.setattr(semi_global, 'align_reads_to_refs',
                            wrap(semi_global.align_reads_to_refs))
    res = _run(tmp_path)
    assert not res['correct']
    bad = {k for k, v in res['checks'].items() if v['value'] > v['limit']}
    if fault == 'altered_score':
        assert bad == {'cigar_off'}
    elif fault != 'altered_cigar':
        assert bad == {'reads_off'}


def test_control_fails_the_limit():
    """The reference at int16 (the control) on reads long enough that a
    score passes 32,767: it reads far above the limit that sound runs
    keep."""
    from harness import spec
    cell = spec.Cell('align.bact5m')
    config, traffic = cells.tiny_align(depth=1.5, replicons=(70000, 1000),
                                       sample=9)
    # error-free reads of 12 kb score 36,000
    traffic['reads'].update({'min_len': 12000, 'max_len': 12000, 'sub': 0,
                             'ins': 0, 'del': 0})
    traffic['check']['block_cells'] = 9 * 13000
    stage = cell.stage().Stage({'config': config, 'traffic': traffic,
                                'seed': 11, 'device': torch.device('cpu')})
    stage.make_data()
    read = stage.control(1)
    limit = traffic['check']['limits']['reads_off']
    assert read['reads_off'] > 3 * limit


@pytest.mark.parametrize('free', [True, False])
def test_reference_dp_against_a_cell_by_cell_dp(free):
    """reference/dp.py against the textbook three-matrix recurrence, with
    the query's ends free or not."""
    from reference import dp
    neg = -10 ** 9

    def naive(q, r, sc):
        ma, mi, go, ge = sc
        n, m = len(q), len(r)
        H = [[0] * (m + 1) for _ in range(n + 1)]
        if not free:
            for i in range(1, n + 1):
                H[i][0] = go + (i - 1) * ge
        E = [[neg] * (m + 1) for _ in range(n + 1)]
        F = [[neg] * (m + 1) for _ in range(n + 1)]
        for i in range(1, n + 1):
            for j in range(1, m + 1):
                E[i][j] = max(H[i][j - 1] + go, E[i][j - 1] + ge)
                F[i][j] = max(H[i - 1][j] + go, F[i - 1][j] + ge)
                s = ma if q[i - 1] == r[j - 1] and q[i - 1] < 4 else mi
                H[i][j] = max(H[i - 1][j - 1] + s, E[i][j], F[i][j])
        if not free:
            return max(H[n])
        return max(max(H[n]), max(row[m] for row in H))

    rng = np.random.default_rng(3)
    qs, rs = [], []
    for _ in range(30):
        r = rng.integers(0, 4, int(rng.integers(1, 30))).astype(np.int8)
        q = r[int(rng.integers(0, len(r))):].copy()
        flip = rng.random(len(q)) < 0.2
        q[flip] = rng.integers(0, 5, int(flip.sum()))
        qs.append(q if rng.random() < 0.8 else q[:0])
        rs.append(r)
    for sc in ((3, -6, -5, -2), (0, -1, -1, -1)):
        assert dp.semiglobal_best(qs, rs, sc, 'cpu',
                                  free_query_ends=free) == \
            [naive(q, r, sc) for q, r in zip(qs, rs)]


def test_cigar_check():
    from reference import cigar
    ref = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int8)
    read = np.array([3, 1, 2, 0, 3, 0, 3], np.int8)
    sc = (3, -6, -5, -2)
    # read[1:6] = 1 2 (0) 3 0 against ref[1:5] = 1 2 3 0: an insertion
    parts = ['1S', '2M', '1I', '2M', '1S']
    assert cigar.check(read, ref, (1, 6, 1, 5), parts, (3 * 4 - 5, None),
                       sc) == []
    assert cigar.check(read, ref, (1, 6, 1, 5), parts, (3 * 4 - 5, 0),
                       sc) == ['score']
    assert cigar.check(read, ref, (1, 6, 1, 6), parts, (7, None),
                       sc) == ['ends']
    assert cigar.check(read, ref, (0, 6, 1, 5), parts, (7, None),
                       sc) == ['clips', 'ends', 'score']
    assert cigar.check(read, ref, (1, 6, 1, 5), ['2X'], (7, None),
                       sc) == ['unparsed']


@pytest.mark.gpu
def test_stage_on_the_card_is_correct(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    import run
    root = cells.tree(tmp_path)
    b = cells.add_cell(root, cells.bench(), 'tiny',
                       *cells.tiny_align(depth=0.4,
                                         replicons=(400000, 20000),
                                         n50=8000, max_len=20000, sample=6,
                                         families=((5000, 2, 250),)))
    for trace in (0, 1):
        code, res = run.main(['--workload', 'tiny', '--seed', '7',
                              '--seconds', '1', '--trace', str(trace)],
                             bench=b, root=root)
        assert code == 0 and res['correct'], res['checks']
        assert res['device']['platform'] == 'gpu'
    assert 0 < res['metrics']['roofline.wave']['value'] < 100
    assert 0 < res['device']['busy_s'] < res['device']['window_s']
