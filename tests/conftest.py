"""Test configuration: force the JAX CPU backend with 8 virtual devices.

Real TPU hardware is single-chip in this environment; multi-chip sharding
logic is validated on a virtual CPU mesh. jax.config must be updated before
any backend is initialised, hence this happens at conftest import time.

Set UNICYCLER_TPU_TESTS=1 to run the suite against the real TPU backend
instead (exercises the Pallas tape path rather than the XLA scan path).
"""

import os

if os.environ.get('UNICYCLER_TPU_TESTS') != '1':
    os.environ.setdefault('XLA_FLAGS',
                          '--xla_force_host_platform_device_count=8')

    import jax

    jax.config.update('jax_platforms', 'cpu')

REFERENCE_TEST_DIR = '/root/reference/test'


def reference_fixture(name):
    return os.path.join(REFERENCE_TEST_DIR, name)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'gpu: needs a CUDA device (skips without one)')
