import numpy as np
import pytest

import jax

# Tests run on the single real CPU device (the 512-device override is ONLY in
# repro.launch.dryrun, which must be executed as its own process).
jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def tiny_cfg(**kw):
    from repro.models.base import ModelConfig

    base = dict(
        name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=128, head_dim=16,
    )
    base.update(kw)
    return ModelConfig(**base)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself where none is present"
    )
