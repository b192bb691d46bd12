"""Test configuration: run JAX on CPU with 8 virtual devices so the
sharding tests exercise real multi-device programs without an
accelerator (SURVEY §4: shard-count invariance is the analogue of the
reference's thread-count invariance).

``JAX_PLATFORMS`` is only defaulted to cpu: the ``gpu``-marked tests run
on a GPU machine with ``JAX_PLATFORMS=cuda`` (README "Running").
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import numpy as np
import pytest

from spydrpick_jax.core.alignment import Alignment
from spydrpick_jax.utils.jax_cache import configure_compile_cache

# persistent compile cache: the suite is dominated by XLA compiles
configure_compile_cache(min_compile_secs=0.5)


@pytest.fixture
def gpu():
    """The first JAX device, which must be a GPU — decided at run time,
    never while the test modules are imported (every test worker must
    collect the same tests)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX device is {dev.platform})")
    return dev


def random_alignment(
    n_samples=64, n_loci=40, seed=0, gap_frac=0.1, n_original=None
) -> Alignment:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n_samples, n_loci)).astype(np.uint8)
    gaps = rng.random((n_samples, n_loci)) < gap_frac
    codes[gaps] = 4
    return Alignment(
        codes=codes,
        sample_names=[f"s{i}" for i in range(n_samples)],
        id_string="test",
        translation=np.arange(n_loci, dtype=np.int64),
        n_original_positions=n_original or n_loci,
        weights=rng.random(n_samples) * 0.9 + 0.1,
    )


@pytest.fixture
def small_alignment():
    return random_alignment()
