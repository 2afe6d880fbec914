"""(a) of test_torch_wave_layout.py at W = 512: the port's wave route on
the card's layout (one task a track), with the kernels' plain versions,
equals the JAX package's interpret-mode wave route per task, exactly, for
all five AlignConfigs on straight and drifting corridors."""

import pytest

from torch_parity import CONFIGS
from test_torch_wave_layout import check_route_matches_jax


@pytest.mark.parametrize('drift', [False, True], ids=['straight', 'drift'])
@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_task_layout_route_matches_jax_w512(cfg, drift, monkeypatch):
    check_route_matches_jax(cfg, drift, 512, monkeypatch)
