"""(c) The port's wave route (tape builder, forward and walker plain
versions, record decode, band-escape retries) on the CPU equals the JAX
package's interpret-mode wave route at W = 128: scores, spans and CIGARs,
exactly, on straight and drifting corridors, for the configs with free
ends here and the rest in test_torch_wave_route_noend.py (the W = 512
cases are in test_torch_wavetape.py)."""

import pytest

from torch_parity import CONFIGS, pa_key, tasks_np
from test_torch_wavetape import jax_wave_route, port_wave_route


@pytest.mark.parametrize('drift', [False, True], ids=['straight', 'drift'])
@pytest.mark.parametrize('cfg', ['semi', 'overlap', 'path'])
def test_wave_route_matches_jax_w128(cfg, drift, monkeypatch):
    monkeypatch.setenv('UNICYCLER_TPU_WAVETAPE', '1')
    tasks = tasks_np(11, [60, 120, 200, 330, 90, 170], drift=drift)
    want = jax_wave_route(tasks, CONFIGS[cfg], 128)
    got = port_wave_route(tasks, CONFIGS[cfg], 128)
    assert [pa_key(p) for p in got] == [pa_key(p) for p in want]

