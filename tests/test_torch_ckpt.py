"""The port's checkpointing (`repro_torch/ckpt/checkpoint.py`) against the
reference's `CheckpointManager` and `Trainer`.

* The reference's seven cases (`tests/test_ckpt.py`) on torch trees:
  round trip (bit-exact, bf16 through float32), the integrity raise, the
  torn ``.tmp`` dir, the fallback past a corrupt step (printed), none when
  all are corrupt, ``read_data_state`` and GC.
* The format both ways: the reference writes and the port restores, and
  the other way round, on reduced llama3.2-3b's bf16 parameters and an
  AdamW state: the same keys, shapes, dtypes and data_state, values
  exact; the chunked digest is the reference's whole-file sha256.
* Resume at hdp = 1: an interrupted port run (3 steps, the newest
  checkpoint damaged, resume at 2, one more step) is bit-equal to the
  uninterrupted one, calibrator and scheduler state included.
* The Trainer across the packages: the reference trains 2 steps and
  saves, the port resumes and trains step 3, held to the reference's own
  step 3 (loss within 1e-4 relative, the update within 1e-3 relative L2
  per leaf); and the other way round.
"""
import dataclasses
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JManager
from repro.ckpt.checkpoint import _flatten
from repro.configs.registry import get_config as jax_config
from repro.data.distribution import LengthDistribution as JDist
from repro.data.loader import GlobalScheduler as JScheduler
from repro.data.loader import SyntheticDataset as JDataset
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import bridge
from repro_torch.ckpt import CheckpointManager, flatten
from repro_torch.ckpt.checkpoint import sha256_file
from repro_torch.configs.registry import get_config
from repro_torch.data.distribution import LengthDistribution
from repro_torch.data.loader import GlobalScheduler, SyntheticDataset
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import Runtime
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_map
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "llama3.2-3b"
F32_TOL = 1e-4                  # tests/test_torch_train.py
UPDATE_TOL = 1e-3               # the step's update, relative L2 per leaf
DIST = ("tiny", 4.5, 0.8, 0.1, 1.5, 256)      # tests/test_system.py
TOKENS, CONTEXT, CAP = 1024, 512, 256


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"a": torch.tensor(rng.randn(8, 8), dtype=torch.float32),
            "b": {"c": torch.tensor(rng.randn(4), dtype=torch.bfloat16)},
            "l": [torch.tensor(rng.randn(3), dtype=torch.float32)]}


def _zeros(tree):
    return tree_map(torch.zeros_like, tree)


def _assert_same(got, want):
    g, w = flatten(got), flatten(want)
    assert sorted(g) == sorted(w)
    for key in w:
        assert g[key].dtype == w[key].dtype, key
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def _corrupt(path, step):
    npz = path / f"step_{step}" / "arrays.npz"
    data = bytearray(npz.read_bytes())
    data[len(data) // 2] ^= 0xFF                          # corrupt mid-file
    npz.write_bytes(bytes(data))


# ---------------------------------------------------------------------------
# the reference's seven cases
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    params, opt = _tree(0), _tree(1)
    mgr.save(7, params, opt, {"step": 7})
    p2, o2, ds = mgr.restore(7, _zeros(params), _zeros(opt))
    assert ds["step"] == 7
    assert p2["b"]["c"].dtype == torch.bfloat16
    _assert_same(p2, params)
    _assert_same(o2, opt)


@pytest.mark.parametrize("case", ["integrity_raise", "fallback_past_corrupt",
                                  "none_when_all_corrupt"])
def test_corrupt_checkpoints(tmp_path, capsys, case):
    """A damaged payload: ``restore`` of it raises; ``restore_latest``
    falls back to the newest one that passes integrity (the elastic
    restart after a mid-save kill), printing the skip; with none valid it
    returns None."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    params, opt = _tree(0), _tree(1)
    if case == "integrity_raise":
        mgr.save(1, params, opt, {"step": 1})
        _corrupt(tmp_path, 1)
        like = _zeros(params)
        with pytest.raises(IOError):
            mgr.restore(1, like, _zeros(opt))
        _assert_same(like, _zeros(params))          # nothing written
    elif case == "fallback_past_corrupt":
        mgr.save(2, params, opt, {"step": 2, "tag": "good"})
        mgr.save(4, _tree(5), opt, {"step": 4})
        _corrupt(tmp_path, 4)
        assert mgr.latest_step() == 4          # still *visible*...
        assert mgr.latest_valid_step() == 2    # ...but not *valid*
        step, p2, _, ds = mgr.restore_latest(_zeros(params), _zeros(opt))
        assert step == 2 and ds["tag"] == "good"
        _assert_same(p2, params)
        assert "checkpoint step 4 skipped" in capsys.readouterr().out
        with pytest.raises(IOError):
            mgr.restore(4, _zeros(params), _zeros(opt))
    else:
        assert mgr.restore_latest(params, opt) is None     # empty dir
        mgr.save(1, params, opt, {"step": 1})
        _corrupt(tmp_path, 1)
        assert mgr.latest_valid_step() is None
        assert mgr.restore_latest(params, opt) is None
        assert mgr.read_data_state(1) is None


def test_partial_checkpoint_invisible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    os.makedirs(tmp_path / ".tmp-step_9")                  # torn write
    (tmp_path / ".tmp-step_9" / "arrays.npz").write_bytes(b"junk")
    assert mgr.latest_step() is None
    params, opt = _tree(0), _tree(1)
    mgr.save(3, params, opt, {"step": 3})
    assert mgr.latest_step() == 3


def test_read_data_state_without_arrays(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    params, opt = _tree(0), _tree(1)
    mgr.save(3, params, opt, {"step": 3, "sched": {"hdp": 4}})   # async
    mgr.wait()
    ds = mgr.read_data_state(3)
    assert ds["sched"]["hdp"] == 4


def test_gc_keeps_last(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, async_save=False)
    params, opt = _tree(0), _tree(1)
    for s in (1, 2, 3, 4):
        mgr.save(s, params, opt, {"step": s})
    assert sorted(mgr.steps()) == [3, 4]


def test_snapshot_is_taken_before_the_writer_runs(tmp_path):
    """The async save's host copies: an in-place update right after
    ``save`` returns does not reach the file, and a shape mismatch is
    refused before any leaf of the like trees is written."""
    mgr = CheckpointManager(str(tmp_path))
    params, opt = _tree(0), _tree(1)
    want = tree_map(torch.clone, params)
    mgr.save(1, params, opt, {"step": 1})
    for x in (params["a"], params["l"][0]):
        x.add_(1.0)
    mgr.wait()
    p2, _, _ = mgr.restore(1, _zeros(params), _zeros(opt))
    _assert_same(p2, want)
    bad = _zeros(params)
    bad["a"] = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, bad, _zeros(opt))
    _assert_same(bad["b"], _zeros(params)["b"])


# ---------------------------------------------------------------------------
# the format, both ways
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_trees(rt1):
    """Reduced llama3.2-3b's bf16 parameters (fp32 norm scales, no head
    blocks) from the reference's init, and an AdamW state mid-run."""
    jcfg = jax_config(ARCH).reduced()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, rt1)
    rng = np.random.RandomState(3)
    state = jadamw.init_state(jp)
    state["step"] = jnp.int32(5)
    state["m"] = jax.tree.map(lambda p: jnp.array(
        rng.randn(*p.shape) * 0.01, jnp.float32), jp)
    state["v"] = jax.tree.map(lambda p: jnp.array(
        np.abs(rng.randn(*p.shape)) * 1e-4, jnp.float32), jp)
    return jcfg, jp, state


def _port_trees(jp, state):
    cfg = get_config(ARCH).reduced()
    tp = bridge.params_from_flat(_flatten(jp), cfg, "cpu")
    ts = {"step": torch.tensor(int(state["step"]), dtype=torch.int32),
          **{k: bridge.params_from_flat(_flatten(state[k]), dataclasses.replace(
              cfg, dtype="float32"), "cpu") for k in ("master", "m", "v")}}
    return tp, ts


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_the_format_is_the_references_both_ways(jax_trees, tmp_path, writer):
    jcfg, jp, jstate = jax_trees
    tp, ts = _port_trees(jp, jstate)
    assert tp["embed"].dtype == torch.bfloat16 and tp["head_blocks"] == []
    assert tp["final_norm"]["scale"].dtype == torch.float32
    ds = {"step": 5, "calib": {"speed": [1.0]}, "sched": {"hdp": 1}}
    if writer == "jax":
        JManager(str(tmp_path), async_save=False).save(5, jp, jstate, ds)
    else:
        CheckpointManager(str(tmp_path), async_save=False).save(5, tp, ts,
                                                                ds)
    npz = tmp_path / "step_5" / "arrays.npz"
    digest = hashlib.sha256(npz.read_bytes()).hexdigest()
    assert sha256_file(str(npz)) == digest
    want = {**{"params/" + k: v for k, v in _flatten(jp).items()},
            **{"opt/" + k: v for k, v in _flatten(jstate).items()}}
    with np.load(npz) as arrays:
        assert sorted(arrays.files) == sorted(want)
        for key, v in want.items():
            assert arrays[key].dtype == v.dtype, key
            np.testing.assert_array_equal(arrays[key], v, err_msg=key)
        step = arrays["opt/step"]
    assert step.dtype == np.int32 and step.shape == () and step == 5
    # the port restores it (into zeros), and so does the reference
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_valid_step() == 5
    step, p2, s2, got_ds = mgr.restore_latest(_zeros(tp), _zeros(ts))
    assert step == 5 and got_ds == ds
    _assert_same(p2, tp)
    _assert_same(s2, ts)
    assert s2["step"].dtype == torch.int32 and p2["head_blocks"] == []
    jparams, jopt, jds = JManager(str(tmp_path)).restore(5, jp, jstate)
    assert jds == ds
    for got, want_tree in ((jparams, jp), (jopt, jstate)):
        g, w = _flatten(got), _flatten(want_tree)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert jparams["embed"].dtype == jnp.bfloat16


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def _cfgs():
    return (dataclasses.replace(jax_config(ARCH).reduced(), dtype="float32"),
            dataclasses.replace(get_config(ARCH).reduced(), dtype="float32"))


def _port_trainer(ckpt_dir, params=None, **tcfg):
    _, cfg = _cfgs()
    ds = SyntheticDataset(LengthDistribution(*DIST), cfg.vocab_size,
                          tokens_per_step=TOKENS, context=CONTEXT)
    sched = GlobalScheduler(ds, cfg, capacity=CAP, hdp=1, use_offload=False)
    tr = Trainer(cfg, Runtime(device="cpu", attn_impl="ref"),
                 adamw.AdamWConfig(lr=1e-3, total_steps=8), sched,
                 TrainerConfig(capacity=CAP, ckpt_dir=str(ckpt_dir),
                               **tcfg), params=params)
    return tr


def _jax_trainer(rt1, ckpt_dir):
    jcfg, _ = _cfgs()
    ds = JDataset(JDist(*DIST), jcfg.vocab_size, tokens_per_step=TOKENS,
                  context=CONTEXT)
    sched = JScheduler(ds, jcfg, capacity=CAP, hdp=1, use_offload=False)
    return JTrainer(jcfg, rt1, jadamw.AdamWConfig(lr=1e-3, total_steps=8),
                    sched, JTrainerConfig(capacity=CAP, attn_impl="ref",
                                          calibrate=False,
                                          ckpt_dir=str(ckpt_dir)))


def _state_flat(tr, flat_fn):
    return {**{"params/" + k: v for k, v in flat_fn(tr.params).items()},
            **{"opt/" + k: v for k, v in flat_fn(tr.opt_state).items()}}


def test_interrupted_run_is_bit_equal_to_the_uninterrupted_one(tmp_path):
    """3 steps (checkpoints at 2 and 3), step 3's payload damaged; a fresh
    Trainer resumes at 2 and trains 1 more: loss, grad norm, parameters
    and optimiser state bit-equal to the uninterrupted step 3, with the
    calibrator (fixed clock) and the scheduler's state restored."""
    clock = lambda wave: 0.01 * float(max(wave.costs)) + 0.001  # noqa: E731
    a = _port_trainer(tmp_path, ckpt_every=2)
    a.wave_time_fn = clock
    hist_a = list(a.run(3))
    a.sched.stop()
    assert sorted(a.ckpt.steps()) == [2, 3]
    want = _state_flat(a, flatten)
    _corrupt(tmp_path, 3)
    b = _port_trainer(tmp_path, ckpt_save=False, params=None)
    b.wave_time_fn = clock
    assert b.calib.n_observed == 0
    assert b.resume_if_possible() and b.step == 2
    assert b.calib.n_observed == a.calib.n_observed - hist_a[2]["waves"]
    hist_b = list(b.run(1))
    b.sched.stop()
    assert [(r["loss"], r["grad_norm"], r["waves"]) for r in hist_b] == \
        [(r["loss"], r["grad_norm"], r["waves"]) for r in hist_a[2:]]
    got = _state_flat(b, flatten)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert b.calib.state_dict() == a.calib.state_dict()
    assert a.ckpt.latest_step() == 3 and a.ckpt.latest_valid_step() == 2


def _held_step(base, got_hist, got_flat, want_hist, want_flat):
    """One step from the same checkpoint on both sides: loss and grad norm
    within 1e-4 relative, the update per leaf within 1e-3 relative L2."""
    np.testing.assert_allclose(got_hist["loss"], want_hist["loss"],
                               rtol=F32_TOL)
    np.testing.assert_allclose(got_hist["grad_norm"], want_hist["grad_norm"],
                               rtol=F32_TOL)
    assert got_hist["waves"] == want_hist["waves"]
    keys = [k for k in base if k.startswith("params/")]
    assert len(keys) > 5 and sorted(keys) == sorted(
        k for k in got_flat if k.startswith("params/"))
    for key in keys:
        up, want = got_flat[key] - base[key], want_flat[key] - base[key]
        rel = np.linalg.norm(up - want) / np.linalg.norm(want)
        assert rel <= UPDATE_TOL, (key, rel)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_trainer_resumes_the_other_packages_checkpoint(rt1, tmp_path,
                                                       writer):
    """``writer`` trains 2 steps and saves; the other package's Trainer
    resumes and trains step 3, held to the writer's own step 3."""
    if writer == "jax":
        first = _jax_trainer(rt1, tmp_path)
    else:
        first = _port_trainer(tmp_path, calibrate=False)
    for _ in first.run(2):
        pass
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.latest_valid_step() == 2
    with np.load(tmp_path / "step_2" / "arrays.npz") as arrays:
        base = {k: arrays[k] for k in arrays.files}
    want = first.train_step()
    first.sched.stop()
    flat_fn = _flatten if writer == "jax" else flatten
    want_flat = _state_flat(first, flat_fn)
    if writer == "jax":
        second = _port_trainer(tmp_path, calibrate=False, ckpt_save=False)
    else:
        second = _jax_trainer(rt1, tmp_path)
    assert second.resume_if_possible() and second.step == 2
    assert int(second.opt_state["step"]) == 2
    got = second.train_step()
    second.sched.stop()
    got_flat = _state_flat(second, _flatten if writer == "torch"
                           else flatten)
    assert got["step"] == want["step"] == 3
    _held_step(base, got, got_flat, want, want_flat)
