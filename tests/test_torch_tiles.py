"""The port's copy of the ring block predicate (`core/ring.py::_block_meta`,
`_block_relevant`), which the flash kernels apply per 64-row tile, against
the reference's on the same numpy inputs; every tile it drops holds no
visible pair; and its live-tile count at the training slice's layout."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ring as jring
from repro_torch.core import ring
from repro_torch.core.attention import attention_mask
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TILE = 64


def _packed(lens, n, rng=None):
    """Segments of the given lengths packed from row 0 (in a random order
    when ``rng`` is given), padding (segment 0) after them."""
    order = rng.permutation(len(lens)) if rng is not None else range(len(lens))
    seg = np.zeros(n, np.int32)
    pos = np.zeros(n, np.int32)
    cur = 0
    for i in order:
        seg[cur:cur + lens[i]] = i + 1
        pos[cur:cur + lens[i]] = np.arange(lens[i])
        cur += lens[i]
    assert cur <= n
    return seg, pos


# segment lengths around the tile size; the last tiles hold padding only
LAYOUTS = {
    "edges": ([1, 63, 64, 65, 1, 63, 64, 65], 640),
    "ragged": ([65, 1, 200, 63, 100], 500),
    "one_long": ([300], 384),
}
MASKS = [(True, 0), (True, 16), (True, 1), (False, 0), (False, 70)]


def _both_metas(seg, pos):
    """Per-tile metadata [4, n_tiles] from the torch copy and the JAX
    reference, on the same numpy slices."""
    t_m, j_m = [], []
    for a in range(0, len(seg), TILE):
        s, p = seg[a:a + TILE], pos[a:a + TILE]
        t_m.append(ring._block_meta(torch.tensor(s), torch.tensor(p)))
        j_m.append(np.asarray(jring._block_meta(jnp.array(s), jnp.array(p))))
    return torch.stack(t_m, dim=1), np.stack(j_m, axis=1)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_block_predicate_matches_jax(layout, causal, window):
    lens, n = LAYOUTS[layout]
    rng = np.random.RandomState(len(lens) + n)
    q_seg, q_pos = _packed(lens, n, rng)
    k_seg, k_pos = _packed(lens, n)
    tq, jq = _both_metas(q_seg, q_pos)
    tk, jk = _both_metas(k_seg, k_pos)
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(tk.numpy(), jk)
    assert tq.dtype == torch.int32
    # padding-only tiles: the empty-range sentinels
    assert (tq[:, -1].tolist() == [2**30, -1, 2**30, -1])
    got = ring._block_relevant(tq[:, :, None], tk[:, None, :], causal=causal,
                               window=window)
    want = jring._block_relevant(jnp.array(jq)[:, :, None],
                                 jnp.array(jk)[:, None, :], causal=causal,
                                 window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    torch.testing.assert_close(
        ring.tile_liveness(*(torch.tensor(x) for x in
                             (q_seg, k_seg, q_pos, k_pos)),
                           causal=causal, window=window), got, atol=0, rtol=0)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dropped_tiles_hold_no_visible_pair(layout, causal, window):
    """Skipping a tile the predicate drops changes nothing: its mask is
    all false.  (The converse need not hold: the predicate keeps some tiles
    whose pairs are all masked.)"""
    lens, n = LAYOUTS[layout]
    q_seg, q_pos = (torch.tensor(x) for x in _packed(
        lens, n, np.random.RandomState(7)))
    k_seg, k_pos = (torch.tensor(x) for x in _packed(lens, n))
    live = ring.tile_liveness(q_seg, k_seg, q_pos, k_pos, causal=causal,
                              window=window)
    mask = attention_mask(q_seg, k_seg, q_pos, k_pos, causal=causal,
                          window=window)
    for i in range(live.shape[0]):
        for j in range(live.shape[1]):
            if not live[i, j]:
                assert not mask[i * TILE:(i + 1) * TILE,
                                j * TILE:(j + 1) * TILE].any(), (i, j)


def test_slice_layout_live_tiles():
    """The training slice's packed wave (segments 3000/900/120, 76 padding
    rows, causal) at 64x64 tiles: the predicate keeps 1327 of 4096 tiles,
    of which 1252 hold a visible pair."""
    seg, pos = (torch.tensor(x) for x in _packed([3000, 900, 120], 4096))
    live = ring.tile_liveness(seg, seg, pos, pos, causal=True, window=0)
    visible = attention_mask(seg, seg, pos, pos).reshape(
        64, TILE, 64, TILE).any(dim=3).any(dim=1)
    assert live.shape == (64, 64)
    assert int(live.sum()) == 1327
    assert int(visible.sum()) == 1252
    assert not (visible & ~live).any()
