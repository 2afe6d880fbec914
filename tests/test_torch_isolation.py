"""unicycler_tpu_torch stands alone and keeps its device contract.

(a) Importing every module of the port (the command line's pipeline/
modules and __main__ among them, and chip_smoke.py) loads neither jax nor
any unicycler_tpu module. (f) Entry points with no device ask for
CUDA and raise on a host without it; a kernel wrapper given CPU tensors
runs its plain version and launches nothing.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import SCORING_T, tasks_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r'''
import importlib, importlib.util, pkgutil, sys
sys.path.insert(0, %r)
import unicycler_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    unicycler_tpu_torch.__path__, 'unicycler_tpu_torch.')
    if importlib.util.find_spec(m.name).origin.endswith('.py')]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert 'jax' not in sys.modules, 'jax was imported'
bad = [m for m in sys.modules
       if m == 'unicycler_tpu' or m.startswith('unicycler_tpu.')]
assert not bad, bad
print(len(names))
print(' '.join(names))
'''


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', _IMPORT_ALL % REPO],
                         cwd=REPO, env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    count, names = out.stdout.strip().split('\n')
    assert int(count) >= 20
    for name in ('__main__', 'version', 'pipeline.main', 'pipeline.rotation',
                 'pipeline.protein_search', 'asm.debruijn', 'asm.correct',
                 'asm.spades_compat', 'ops.kmer_count',
                 'pipeline.fake_reads'):
        assert 'unicycler_tpu_torch.' + name in names.split(), name


def _job():
    from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme
    from unicycler_tpu_torch.align.semi_global import AlignJob
    from unicycler_tpu_torch.io.fastx import Read, Reference
    rng = np.random.default_rng(0)
    ref = ''.join('ACGT'[x] for x in rng.integers(0, 4, 3000))
    return AlignJob([Read('r', ref[100:1100], None)],
                    [Reference('1', ref)],
                    AlignmentScoringScheme('3,-6,-5,-2'))


@pytest.mark.parametrize('entry', ['align_jobs', 'align_banded',
                                   'semi_global_align_long_reads',
                                   'align_pairs', 'batch_align',
                                   'create_long_read_bridges',
                                   'make_miniasm_string_graph',
                                   'polish_unitigs',
                                   'wavefront_batch_corridor', 'main',
                                   'main_short_reads', 'count_spectrum',
                                   'create_simple_long_read_bridges',
                                   'create_miniasm_bridges', 'place_contigs',
                                   'align_long_reads_to_assembly_graph'])
def test_entry_points_default_to_cuda_and_raise_without_it(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    from unicycler_tpu_torch.align import semi_global
    from unicycler_tpu_torch.asm import hybrid, polish
    from unicycler_tpu_torch.bridges import long_read
    from unicycler_tpu_torch.graph.string_graph import (StringGraph,
                                                        StringGraphSegment)
    from unicycler_tpu_torch.ops import banded, dispatch, pairwise, wavefront
    from unicycler_tpu_torch.ops.pairwise import Scoring
    with pytest.raises(RuntimeError, match='CUDA'):
        if entry == 'align_jobs':
            semi_global.align_jobs([_job()])
        elif entry == 'align_banded':
            q, r, cr, cf = tasks_np(1, [50], False)[0]
            banded.align_banded([banded.BandedTask(q, r, cr, cf)],
                                Scoring(*SCORING_T))
        elif entry == 'align_pairs':
            q, r, _, _ = tasks_np(1, [50], False)[0]
            pairwise.align_pairs([q], [r], Scoring(*SCORING_T))
        elif entry == 'batch_align':
            q, r, _, _ = tasks_np(1, [50], False)[0]
            dispatch.batch_align([q], [r], Scoring(*SCORING_T),
                                 pairwise.FULLY_GLOBAL)
        elif entry == 'create_long_read_bridges':
            long_read.create_long_read_bridges(
                None, {}, [], [], 0, 0.0, 1, None, 50, False, 10.0)
        elif entry == 'make_miniasm_string_graph':
            job = _job()
            hybrid.make_miniasm_string_graph(
                None, {'r': job.reads[0]}, None, job.scoring_scheme, None,
                None, None, [])
        elif entry == 'polish_unitigs':
            job = _job()
            graph = StringGraph(None)
            graph.segments['1'] = StringGraphSegment(
                '1', job.references[0].sequence)
            polish.polish_unitigs(graph, job.reads, job.scoring_scheme,
                                  hybrid=False)
        elif entry == 'main':
            from unicycler_tpu_torch.pipeline import main
            reads = tmp_path / 'reads.fq'
            reads.write_text('@r\nACGT\n+\nIIII\n')
            main.main(['-l', str(reads), '-o', str(tmp_path / 'out')])
        elif entry == 'main_short_reads':
            from unicycler_tpu_torch.pipeline import main
            reads = tmp_path / 'reads.fq'
            reads.write_text('@r\nACGT\n+\nIIII\n')
            main.main(['-1', str(reads), '-2', str(reads), '-o',
                       str(tmp_path / 'out')])
        elif entry == 'count_spectrum':
            from unicycler_tpu_torch.ops import kmer_count
            kmer_count.count_spectrum([np.zeros(30, np.int8)], 21)
        elif entry == 'create_simple_long_read_bridges':
            from unicycler_tpu_torch.bridges import long_read_simple
            long_read_simple.create_simple_long_read_bridges(
                None, str(tmp_path), 0, 1, {}, None, None, [])
        elif entry == 'create_miniasm_bridges':
            from unicycler_tpu_torch.bridges import miniasm
            miniasm.create_miniasm_bridges(None, StringGraph(None), [], None,
                                           0, 10.0)
        elif entry == 'place_contigs':
            hybrid.place_contigs(None, StringGraph(None), None, set())
        elif entry == 'align_long_reads_to_assembly_graph':
            from unicycler_tpu_torch.pipeline import main
            args = main.get_arguments(['-o', str(tmp_path / 'out')])
            main.align_long_reads_to_assembly_graph(None, [], args, {}, [],
                                                    None)
        elif entry == 'wavefront_batch_corridor':
            q, r, _, _ = tasks_np(1, [50], False)[0]
            wavefront.wavefront_batch(q[None], r[None], [-60], [len(q)],
                                      [len(r)], Scoring(*SCORING_T),
                                      pairwise.SEMI_GLOBAL, 128)
        else:
            job = _job()
            semi_global.semi_global_align_long_reads(
                job.references, None, {'r': job.reads[0]}, ['r'], None, 1,
                job.scoring_scheme, [None], False, 50, None, None, 0, 0,
                None)


def test_cpu_tensors_take_the_plain_versions():
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import banded_kernel as bk
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops import tape_kernels as tk
    from unicycler_tpu_torch.ops import traceback_kernels as tbk
    from unicycler_tpu_torch.ops import wavefront as wf
    from unicycler_tpu_torch.ops import wavetape_kernels as wk
    from unicycler_tpu_torch.ops.pairwise import SEMI_GLOBAL, Scoring
    from unicycler_tpu_torch.ops.tape import build_tapes
    from unicycler_tpu_torch.ops.tape import forward_inputs as tape_inputs
    from unicycler_tpu_torch.ops.wavetape import (build_wavetapes,
                                                  forward_inputs)

    scoring = Scoring(*SCORING_T)
    tasks = [bo.BandedTask(*t) for t in tasks_np(2, [90, 150], True)]
    before = dict(cuda_lib.LAUNCHES)
    W = 128
    tp = build_wavetapes(tasks, W, bo.build_corridor)[0]
    up = [torch.from_numpy(x) for x in forward_inputs(tp)]
    score, ei, ej, moves, db = wk.wavetape_forward(
        *up, scoring=scoring, config=SEMI_GLOBAL, W=W, need_moves=True)
    plane, _ = wk.group_plane(*up[2:11], tp.LR, tp.r_flat.shape[1], W)
    moves_p, _ = wk.wavetape_forward_plain(up[0], up[1], plane, scoring,
                                           SEMI_GLOBAL, W, True)
    assert torch.equal(moves, moves_p)
    args = (moves, db, torch.from_numpy(tp.n_tasks), ei, ej,
            torch.from_numpy(tp.abase))
    rec, fin = wk.wavetape_traceback(*args, W)
    rec_p, fin_p = wk.wavetape_traceback_plain(*args, W)
    assert torch.equal(rec, rec_p) and torch.equal(fin, fin_p)

    tp = build_tapes(tasks, 4096, bo.build_corridor)[0]
    up = [torch.from_numpy(x) for x in tape_inputs(tp)]
    score, ei, ej, moves, (c_rel, jr_rows) = tk.tape_forward(
        *up, scoring=scoring, config=SEMI_GLOBAL, W=4096, need_moves=True)
    rowinfo, gplane, _, _ = tk.tape_prolog(up[0], up[1], up[2], up[3],
                                           up[5], up[7], up[8], 4096)
    moves_p = tk.tape_forward_plain(rowinfo, gplane, up[1], scoring,
                                    SEMI_GLOBAL, 4096, True)[0]
    assert torch.equal(moves, moves_p)
    valid = up[6] > 0
    zero = torch.zeros_like(ei)
    targs = (moves, c_rel, jr_rows, torch.from_numpy(tp.n_tasks),
             torch.where(valid, up[8] + ei, zero),
             torch.where(valid, ej, zero), torch.where(valid, up[8], zero))
    rec, fin = tk.tape_traceback(*targs, 4096)
    rec_p, fin_p = tk.tape_traceback_plain(*targs, 4096)
    assert torch.equal(rec, rec_p) and torch.equal(fin, fin_p)

    host = bo._pack_bucket(tasks, [0, 1], 512, 512, W, 2)
    got = bk.banded_batch(*(torch.from_numpy(x) for x in host), scoring,
                          SEMI_GLOBAL, W, True)
    want = bk.banded_batch_plain(*(torch.from_numpy(x) for x in host),
                                 scoring, SEMI_GLOBAL, W, True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    crow = torch.from_numpy(host[2][:, 1:])
    got = tbk.banded_traceback(want[3], crow, want[1], want[2], W)
    for a, b in zip(got, tbk.banded_traceback_plain(want[3], crow, want[1],
                                                    want[2], W)):
        assert torch.equal(a, b)

    q = np.stack([np.resize(t.q, 150) for t in tasks])
    r = np.stack([np.resize(t.r, 200) for t in tasks])
    staged = wf._prepare(q, r, [np.arange(151) - 40] * 2, np.array([150] * 2),
                         np.array([200] * 2), W)
    args = [torch.from_numpy(x) for x in staged[:4]]
    kw = dict(W=W, Wcap=staged[6], a_lo=staged[4], scoring=scoring,
              config=SEMI_GLOBAL)
    for a, b in zip(wf.wavefront_forward(*args, **kw),
                    wf.wavefront_forward_plain(*args, **kw)):
        assert torch.equal(a, b)
    assert cuda_lib.LAUNCHES == before


def test_wide_bands_raise_not_implemented():
    """Bands W > 2048 once raised NotImplementedError here; they now take
    the row-tape route, which on CPU tensors runs the kernels' plain
    versions and launches nothing."""
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops import tape_kernels as tk
    from unicycler_tpu_torch.ops.pairwise import SEMI_GLOBAL, Scoring
    from unicycler_tpu_torch.utils import trace
    tasks = [bo.BandedTask(*t) for t in tasks_np(3, [60, 130], True)]
    before = dict(cuda_lib.LAUNCHES)
    calls = []
    plain = tk.tape_forward_plain

    def spy(*args, **kwargs):
        calls.append(args[0].device.type)
        return plain(*args, **kwargs)

    tk.tape_forward_plain = spy
    trace.reset()
    trace.enable()
    try:
        got = bo.align_banded_tape(tasks, Scoring(*SCORING_T), SEMI_GLOBAL,
                                   4096, True, device='cpu')
    finally:
        tk.tape_forward_plain = plain
        trace.disable()
    assert calls == ['cpu']
    counters = trace.as_dict()['counters']
    assert counters.get('tape.rows.W4096') == 512
    assert counters.get('tape.tracks') == 2
    assert [bool(p.cigar) for p in got] == [True, True]
    assert cuda_lib.LAUNCHES == before
