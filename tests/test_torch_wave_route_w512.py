"""(c) The port's wave route on the CPU equals the JAX package's
interpret-mode wave route at W = 512 on drifting corridors, for the
AlignConfigs that test_torch_wavetape.py leaves out: scores, spans and
CIGARs, exactly."""

import pytest

from torch_parity import CONFIGS, pa_key, tasks_np
from test_torch_wavetape import jax_wave_route, port_wave_route


@pytest.mark.parametrize('cfg', ['path', 'overlap', 'end'])
def test_wave_route_matches_jax_w512_drift(cfg, monkeypatch):
    monkeypatch.setenv('UNICYCLER_TPU_WAVETAPE', '1')
    tasks = tasks_np(31, [150, 400, 700, 260], drift=True)
    want = jax_wave_route(tasks, CONFIGS[cfg], 512)
    got = port_wave_route(tasks, CONFIGS[cfg], 512)
    assert [pa_key(p) for p in got] == [pa_key(p) for p in want]
