"""Weight bridge round trip, the port's import boundary, and its refusal
to fall back to the CPU on its own."""
import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten
from repro.configs.registry import get_config as jax_config
from repro.models.transformer import init_params as jax_init_params
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flatten_bridge_round_trip_bit_exact(dtype, rt1):
    jcfg = dataclasses.replace(jax_config("llama3.2-3b").reduced(),
                               dtype=dtype)
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                              dtype=dtype)
    flat = _flatten(jax_init_params(jax.random.PRNGKey(0), jcfg, rt1))
    params = bridge.params_from_flat(flat, cfg, device="cpu")
    assert params["blocks"][0]["attn"]["w_kv"].shape == (
        2, 64, 2, 2, 16)                        # [n_periods, d, 2, G, Dk]
    assert params["blocks"][0]["attn"]["w_q"].dtype == getattr(torch, dtype)
    assert params["final_norm"]["scale"].dtype == torch.float32
    assert params["head_blocks"] == []
    back = bridge.params_to_flat(params)
    assert sorted(back) == sorted(flat)
    for key in flat:
        assert back[key].dtype == flat[key].dtype, key
        np.testing.assert_array_equal(back[key], flat[key], err_msg=key)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    # the tensor-parallel layers among them
    assert ROOT / "src" / "repro_torch" / "parallel" / "tensor.py" in files
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), (path, mod)


def test_entry_points_refuse_a_missing_gpu():
    """Without device= the port runs on cuda; with no GPU it raises
    rather than quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg = get_config("llama3.2-3b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runtime()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, seed=0)
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(params, cfg, scfg=ServeConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.params_from_flat(bridge.params_to_flat(params), cfg)
