"""Test-tier bootstrap.

* Smoke tests see ONE device (the dry-run sets its own 512-device flag in a
  separate process; distributed tests spawn subprocesses with their own
  XLA_FLAGS).  CI may export XLA_FLAGS=--xla_force_host_platform_device_count=8
  — the smoke tests only ever use device 0, so that is harmless.
* When `hypothesis` is not installed, a deterministic in-repo fallback
  (tests/_propshim.py) is registered under the same import name so the
  property tests still run instead of erroring at collection.
* Tests that need a JAX feature the running version genuinely lacks skip
  with a reason (via `repro.compat.feature_status`) instead of hard-erroring:
  mark them ``@pytest.mark.jax_feature("host_offload")`` etc.
"""
import os

os.environ.setdefault("XLA_FLAGS", "")

try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import _propshim
    _propshim.install()

import jax  # noqa: E402
import pytest  # noqa: E402

from repro import compat  # noqa: E402
from repro.parallel.sharding import single_device_runtime  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "jax_feature(name): skip when the running JAX lacks the feature "
        "(names: shard_map, axis_types, set_mesh, host_offload)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's kernels); skips without one")


def pytest_runtest_setup(item):
    for mark in item.iter_markers("jax_feature"):
        if not mark.args:
            pytest.fail("@pytest.mark.jax_feature requires a feature name, "
                        "e.g. jax_feature('host_offload')")
        name = mark.args[0]
        ok, why = compat.feature_status(name)
        if not ok:
            pytest.skip(f"jax {jax.__version__} lacks {name!r}: {why}")


@pytest.fixture(scope="session")
def rt1():
    try:
        rt = single_device_runtime(remat="none")
    except (AttributeError, NotImplementedError) as e:
        # AttributeError = a JAX surface genuinely absent from this
        # version (compat needs extending) -> skip with reason; anything
        # else, including TypeError from a bad refactor, errors loudly
        pytest.skip(f"single-device runtime unavailable on jax "
                    f"{jax.__version__}: {e!r}")
    compat.set_mesh(rt.mesh)
    return rt
