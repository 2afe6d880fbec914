"""Nothing a run or the reference imports is JAX or the JAX package;
names are compared by their whole top-level part."""

import os
import subprocess
import sys

import cells


def test_forbidden_compares_whole_top_level_names():
    from harness import isolation
    assert isolation.forbidden(['unicycler_tpu_torch', 'numpy',
                                'unicycler_tpu_torch.ops.banded',
                                'jax_like', 'flaxen']) == []
    assert isolation.forbidden(['unicycler_tpu.ops']) == ['unicycler_tpu']
    assert isolation.forbidden(['jax.numpy', 'jaxlib', 'flax.linen']) == \
        ['flax', 'jax', 'jaxlib']


def _modules_after(code):
    out = subprocess.run(
        [sys.executable, '-c', code + '\nimport sys\n'
         'print(" ".join(sorted({n.split(".")[0] for n in sys.modules})))'],
        cwd=cells.ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=cells.HERE + os.pathsep + cells.ROOT))
    return set(out.stdout.split())


def test_run_and_its_stage_load_no_jax():
    names = _modules_after(
        'import run\n'
        'from harness import spec, tracing\n'
        'cell = spec.Cell("align.bact5m")\n'
        'cell.stage()\n'
        'cell.readers("end_to_end"); cell.readers("layer_metrics")\n'
        'import unicycler_tpu_torch.align.semi_global\n'
        'import unicycler_tpu_torch.asm.polish\n')
    assert 'unicycler_tpu_torch' in names
    assert not names & {'jax', 'jaxlib', 'flax', 'unicycler_tpu'}


def test_reference_loads_nothing_of_the_program():
    names = _modules_after(
        'import reference.dp, reference.cigar, reference.bases\n'
        'import gen.synth, gen.longreads, gen.bridging, costs.banded\n')
    assert not names & {'jax', 'jaxlib', 'flax', 'unicycler_tpu',
                        'unicycler_tpu_torch'}
