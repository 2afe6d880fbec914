"""(a) of test_torch_row_layout.py at W = 8192: the port's row route on
the card's layout (one task a track), with the kernels' plain versions,
equals the JAX package's interpret-mode row route per task, exactly, for
all five AlignConfigs."""

import pytest

from torch_parity import CONFIGS
from test_torch_row_layout import check_route_matches_jax


@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_row_layout_route_matches_jax_w8192(cfg):
    check_route_matches_jax(cfg, 8192)
