"""The polish stage at a tiny size on the CPU route against the
reference, the run with its timed path broken underneath (correct comes
out false), and the control (the draft returned unvoted)."""

import functools
import json
import os

import pytest
import torch

import cells
import faults


def tiny_polish():
    with open(os.path.join(cells.HERE, 'configs',
                           'bact5m-longread.json')) as f:
        config = json.load(f)
    with open(os.path.join(cells.HERE, 'traffic', 'polish.json')) as f:
        traffic = json.load(f)
    config['replicons'] = [9000, 5000]
    traffic['depth'] = 30
    traffic['reads'].update(n50=2000, max_len=6000)
    return config, traffic


def _run(tmp_path, seed=3 * 2 ** 32 + 1):
    import run
    root = cells.tree(tmp_path)
    b = cells.add_cell(root, cells.bench(), 'tinyp', *tiny_polish(),
                       base_cell='polish.bact5m')
    code, res = run.main(['--workload', 'tinyp', '--seed', str(seed),
                          '--seconds', '0', '--trace', '0'],
                         device='cpu', bench=b, root=root)
    assert code == 0
    return res


def test_stage_on_the_cpu_route_is_correct(tmp_path):
    res = _run(tmp_path)
    assert res['correct'], res['checks']
    assert res['info']['alignments'] > 0
    assert res['checks']['cigar_off']['value'] == 0


def _unchanged(fn):
    """The round returns the draft as it went in."""
    @functools.wraps(fn)
    def wrapped(graph, *args, **kwargs):
        polished, quality, depths = fn(graph, *args, **kwargs)
        polished = {n: s.forward_sequence for n, s in graph.segments.items()}
        return polished, quality, depths
    return wrapped


def _altered(fn):
    @functools.wraps(fn)
    def wrapped(tasks, *args, **kwargs):
        out = fn(tasks, *args, **kwargs)
        for k, pa in enumerate(out):
            if pa is not None and pa.cigar:
                out[k] = pa._replace(score=pa.score - 1)
                break
        return out
    return wrapped


@pytest.mark.parametrize('fault', ['unchanged', 'half', 'altered'])
def test_broken_path_is_not_correct(tmp_path, monkeypatch, fault):
    from unicycler_tpu_torch.asm import polish
    from unicycler_tpu_torch.ops import banded
    if fault == 'altered':
        monkeypatch.setattr(banded, 'align_banded',
                            _altered(banded.align_banded))
    elif fault == 'half':
        # the round votes with the first half of the reads (faults.py)
        _, _, wrap = faults.FAULTS['polish_round']['half_reads']
        monkeypatch.setattr(polish, 'polish_round',
                            wrap(polish.polish_round))
    else:
        monkeypatch.setattr(polish, 'polish_round',
                            _unchanged(polish.polish_round))
    res = _run(tmp_path)
    assert not res['correct']
    bad = {k for k, v in res['checks'].items() if v['value'] > v['limit']}
    assert bad == ({'cigar_off'} if fault == 'altered'
                   else {'residual_per_kbp'})


def test_control_fails_the_limit():
    from harness import spec
    config, traffic = tiny_polish()
    cell = spec.Cell('polish.bact5m')
    stage = cell.stage().Stage({'config': config, 'traffic': traffic,
                                'seed': 5, 'device': torch.device('cpu')})
    stage.make_data()
    read = stage.control(1)
    assert read['residual_per_kbp'] > \
        3 * traffic['check']['limits']['residual_per_kbp']
