"""The port's side of `tests/test_torch_ring.py`: ring cases and the
model-level gradient on 4 gloo ranks (one process per rank), written to
npz for the test to hold against the reference.

    python tests/_torch_ring_worker.py INPUTS.npz OUT_DIR

Imports torch and the port only (no JAX), so the four spawned ranks start
light.  The ring cases run first; the model case then waits for the
reference's parameters (``OUT_DIR/jax_params.npz``, written by the JAX
side before it computes its gradients) so both sides use the same weights.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

C, R = 16, 4                       # tokens per rank, ranks
T = C * R
H, G, D = 4, 2, 8
SCALE = 0.3
KV_CHUNK = 8
VIN_K = (0, 6)

# name: (composition, layout, window, softcap, head mode)
RING_CASES = {
    "g4": ((4,), "shuffled", 0, 0.0, "sharded"),
    "g4_win_cap": ((4,), "shuffled", 9, 25.0, "sharded"),
    "g2": ((2, 2), "shuffled", 0, 0.0, "sharded"),
    "g2_win_cap": ((2, 2), "shuffled", 9, 25.0, "sharded"),
    "g1_win_cap": ((1, 1, 1, 1), "shuffled", 9, 25.0, "sharded"),
    "mixed": ((2, 1, 1), "shuffled", 0, 0.0, "sharded"),
    "mixed_win_cap": ((2, 1, 1), "shuffled", 9, 25.0, "sharded"),
    "offset": ((1, 2, 1), "shuffled", 0, 0.0, "sharded"),
    "offset_win_cap": ((1, 2, 1), "shuffled", 9, 25.0, "sharded"),
    "zigzag": ((2, 2), "zigzag", 0, 0.0, "sharded"),
    "zigzag_win_cap": ((2, 2), "zigzag", 9, 25.0, "sharded"),
    "gather_g2": ((2, 2), "two_seq", 0, 0.0, "gather"),
    "gather_mixed": ((2, 1, 1), "two_seq", 0, 0.0, "gather"),
    "gather_offset": ((1, 2, 1), "two_seq", 0, 0.0, "gather"),
    "v_in_k": ((2, 2), "two_seq", 0, 0.0, "v_in_k"),
}
IMPLS = ("ref", "flash")
MODEL_COMPS = {"model_g2": (2, 2), "model_g4": (4,)}
KGI = {"gather": [0, 0, 1, 1], "v_in_k": [0, 0, 0, 0]}


def make_inputs() -> dict:
    """Every case's inputs, made from seeds with numpy (the layouts of
    `tests/test_ring_flash.py`'s RING_SCRIPT and GATHER_SCRIPT)."""
    from repro_torch.data.packing import zigzag_chunks
    rng = np.random.RandomState(1)
    out = {"q": rng.randn(T, H, D).astype(np.float32),
           "k": rng.randn(T, G, D).astype(np.float32),
           "v": rng.randn(T, G, D).astype(np.float32),
           "kl": rng.randn(T, 1, D).astype(np.float32)}
    # packed: two sequences and padding, shuffled across ranks
    seg = np.zeros(T, np.int32)
    pos = np.zeros(T, np.int32)
    order = np.random.RandomState(0).permutation(T)
    toks = [(1, i) for i in range(28)] + [(2, i) for i in range(32)] \
        + [(0, 0)] * 4
    for slot, (s_, p_) in zip(order, toks):
        seg[slot], pos[slot] = s_, p_
    out["seg_shuffled"], out["pos_shuffled"] = seg, pos
    # zigzag: one 32-token sequence per 2-rank group, chunk pairs (Fig. 14)
    zseg = np.zeros(T, np.int32)
    zpos = np.zeros(T, np.int32)
    for grp, sid in ((0, 1), (1, 2)):
        for j, lo, hi in zigzag_chunks(32, 2):
            r = 2 * grp + j
            zseg[r * C:r * C + 8] = sid
            zpos[r * C:r * C + 8] = np.arange(*lo)
            zseg[r * C + 8:r * C + 16] = sid
            zpos[r * C + 8:r * C + 16] = np.arange(*hi)
    out["seg_zigzag"], out["pos_zigzag"] = zseg, zpos
    out["seg_two_seq"] = np.repeat([1, 2], 32).astype(np.int32)
    out["pos_two_seq"] = np.tile(np.arange(32), 2).astype(np.int32)
    # model batch: tests/test_distributed.py GRAD_SCRIPT
    mrng = np.random.RandomState(0)
    out["tokens"] = mrng.randint(0, 512, T).astype(np.int32)
    out["labels"] = mrng.randint(0, 512, T).astype(np.int32)
    return out


def case_args(inp: dict, name: str, sl=slice(None)):
    """numpy (q, k, v, seg, pos, kwargs) of one ring case, rows ``sl``."""
    comp, layout, window, softcap, mode = RING_CASES[name]
    seg, pos = inp[f"seg_{layout}"][sl], inp[f"pos_{layout}"][sl]
    kw = dict(composition=comp, scale=SCALE, window=window, softcap=softcap,
              kv_chunk=KV_CHUNK, kv_sharded=mode == "sharded")
    if mode == "v_in_k":
        return inp["q"][sl], inp["kl"][sl], None, seg, pos, \
            dict(kw, v_in_k=VIN_K, kgi=KGI[mode])
    return inp["q"][sl], inp["k"][sl], inp["v"][sl], seg, pos, \
        dict(kw, kgi=KGI.get(mode))


def run_case(comm, inp, name, impl):
    """This rank's (out, loss share, dq, dk[, dv]) of one ring case
    (loss = sum of out², differentiated by autograd)."""
    import torch
    from repro_torch.core.ring import ring_attention
    r = 0 if comm is None else comm.rank
    n = T if comm is None else C
    q, k, v, seg, pos, kw = case_args(inp, name, slice(r * n, (r + 1) * n))
    kgi = kw.pop("kgi")
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)
          if x is not None]
    meta = [torch.tensor(x) for x in (seg, seg, pos, pos)]
    o = ring_attention(
        xs[0], xs[1], xs[2] if len(xs) > 2 else None, *meta,
        kv_group_of_head=None if kgi is None else torch.tensor(kgi),
        attn_impl=impl, comm=comm, **kw)
    loss = (o.float() ** 2).sum()
    grads = torch.autograd.grad(loss, xs)
    return [o.detach().numpy(), loss.detach().numpy()] + \
        [g.numpy() for g in grads]


def run_model(comm, inp, params_flat, comp, impl):
    """This rank's (loss share, flat grads) of reduced llama3.2-3b in
    float32 through the port's `grad_step` on its slice of the batch."""
    import dataclasses
    import torch
    from repro_torch import bridge
    from repro_torch.configs.registry import get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.train.train_step import make_accum_steps, zeros_accum
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                              dtype="float32")
    rt = Runtime(device="cpu", comm=comm, composition=comp, remat="none",
                 kv_chunk=16, attn_impl=impl)
    params = bridge.params_from_flat(params_flat, cfg, "cpu")
    sl = slice(comm.rank * C, (comm.rank + 1) * C)
    batch = {"tokens": torch.tensor(inp["tokens"][sl]),
             "labels": torch.tensor(inp["labels"][sl]),
             "seg": torch.tensor(inp["seg_two_seq"][sl]),
             "pos": torch.tensor(inp["pos_two_seq"][sl]),
             "denom": torch.tensor(float(T))}
    grad_step, _ = make_accum_steps(cfg, rt, AdamWConfig())
    acc, m = grad_step(params, zeros_accum(params), batch, rt)
    return float(m["loss"]), bridge.params_to_flat(acc)


def _wait_for(path: str, timeout: float = 300.0) -> None:
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.2)


def _rank_main(rank: int, inputs: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.comm import ProcessGroupComm
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            world_size=R, rank=rank)
    try:
        comm = ProcessGroupComm()
        inp = dict(np.load(inputs))
        res = {}
        for name in RING_CASES:
            for impl in IMPLS:
                for i, x in enumerate(run_case(comm, inp, name, impl)):
                    res[f"{name}/{impl}/{i}"] = x
        _wait_for(f"{out_dir}/jax_params.npz")
        params = dict(np.load(f"{out_dir}/jax_params.npz"))
        for name, comp in MODEL_COMPS.items():
            for impl in IMPLS:
                loss, grads = run_model(comm, inp, params, comp, impl)
                res[f"{name}/{impl}/loss"] = np.float32(loss)
                for key, g in grads.items():
                    res[f"{name}/{impl}/grad/{key}"] = g
        np.savez(f"{out_dir}/torch_rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    import torch.multiprocessing as mp
    inputs, out_dir = argv
    mp.start_processes(_rank_main, args=(inputs, out_dir), nprocs=R,
                       join=True, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    sys.exit(main(sys.argv[1:]))
