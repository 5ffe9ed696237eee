"""gs_tpu_torch binning against gs_tpu's on the CPU: integer outputs equal.

``tile_rect`` and ``bin_gaussians_aligned`` (default gather path) get the
same numpy screen-space inputs; starts, ends, pair_gauss, valid,
depth_order and num_pairs must match exactly, including when the pair
budget overflows and the deepest Gaussians are dropped. The reference
binning ``bin_gaussians`` is held bitwise to gs_tpu's on
tests/test_tiled.py's three binning inputs, with twins of that file's
checks (rects covered, depth order, aligned = reference, the sentinel),
as are ``vec_cumsum`` / ``vec_cummax``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_tpu.ops import binning as j_binning
from gs_tpu_torch.ops import binning

# (width, height, tile_w, tile_h, align, budget): budget None = no overflow
CASES = [
    (61, 47, 16, 16, 32, None),
    (64, 64, 16, 16, 64, None),
    (61, 47, 48, 32, 64, None),
    (64, 64, 16, 16, 32, 700),  # overflow: a depth prefix of Gaussians fits
    (61, 47, 16, 16, 64, 64),  # overflow after the first few Gaussians
]


def screen_inputs(n, width, height, seed):
    """Splats over and around the image, a few culled (radius 0) and some
    sharing a depth (the stable sort must keep index order)."""
    rng = np.random.default_rng(seed)
    means2d = rng.uniform(-20, max(width, height) + 20, (n, 2)).astype(np.float32)
    depths = rng.uniform(1, 10, n).astype(np.float32)
    depths[::7] = depths[3]
    radii = rng.integers(0, 25, n).astype(np.int32)
    radii[::11] = 0
    return means2d, depths, radii


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6, 7, 8))
def j_bin(means2d, depths, radii, tiles_x, tiles_y, tile_w, tile_h, budget, align):
    return j_binning.bin_gaussians_aligned(means2d, depths, radii, tiles_x, tiles_y,
                                           tile_w, tile_h, budget, align)


@pytest.mark.parametrize("w,h,tw,th", [(61, 47, 16, 16), (64, 64, 48, 32), (100, 30, 8, 8)])
def test_tile_rect(w, h, tw, th):
    m, _, r = screen_inputs(600, w, h, seed=3)
    tx, ty = -(-w // tw), -(-h // th)
    got = binning.tile_rect(torch.from_numpy(m), torch.from_numpy(r), tx, ty, tw, th)
    want = j_binning.tile_rect(jnp.asarray(m), jnp.asarray(r), tx, ty, tw, th)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("w,h,tw,th,align,budget", CASES)
def test_bin_gaussians_aligned(w, h, tw, th, align, budget):
    n = 400
    m, d, r = screen_inputs(n, w, h, seed=w + tw + (budget or 0))
    tx, ty = -(-w // tw), -(-h // th)
    if budget is None:
        budget = 8 * n
    got = binning.bin_gaussians_aligned(torch.from_numpy(m), torch.from_numpy(d),
                                        torch.from_numpy(r), tx, ty, tw, th, budget, align)
    want = j_bin(jnp.asarray(m), jnp.asarray(d), jnp.asarray(r), tx, ty, tw, th, budget, align)
    for field in ("pair_gauss", "valid", "starts", "ends", "depth_order"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    assert int(got.num_pairs) == int(want.num_pairs)
    assert got.pair_gauss.shape[0] == binning.aligned_buffer_size(budget, tx * ty, align)
    n_valid, num_pairs = int(got.valid.sum()), int(got.num_pairs)
    if budget < 8 * n:  # the overflow cases really overflow
        assert num_pairs > budget >= n_valid
    else:
        assert n_valid == num_pairs
    assert ((got.ends - got.starts) % align == 0).all()


def test_bin_all_culled():
    m, d, _ = screen_inputs(50, 64, 64, seed=5)
    got = binning.bin_gaussians_aligned(torch.from_numpy(m), torch.from_numpy(d),
                                        torch.zeros(50, dtype=torch.int32), 4, 4, 16, 16, 512, 32)
    assert int(got.num_pairs) == 0 and not got.valid.any()
    assert (got.pair_gauss == 50).all() and (got.starts == 0).all() and (got.ends == 0).all()


# --- the reference binning bin_gaussians (tests/test_tiled.py:TestBinning) -----------------


def random_scene_inputs(seed, n, h, w):
    """means2d, depths, radii of tests/test_tiled.py's ``random_scene(PRNGKey(seed), n, h, w)``."""
    from tests.reference_raster import random_scene

    args = random_scene(jax.random.PRNGKey(seed), n, h, w)
    return tuple(np.array(args[i]) for i in (0, 4, 5))


def both_bin_gaussians(m, d, r, *static):
    got = binning.bin_gaussians(torch.from_numpy(m), torch.from_numpy(d), torch.from_numpy(r),
                                *static)
    want = j_binning.bin_gaussians(jnp.asarray(m), jnp.asarray(d), jnp.asarray(r), *static)
    assert got._fields == want._fields
    for field in got._fields:
        assert getattr(got, field).dtype == (torch.int64 if field == "num_pairs" else torch.int32)
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    return got


def test_bin_gaussians_pairs_cover_tile_rects():
    """test_pairs_cover_tile_rects, the port's binning equal to gs_tpu's."""
    m, d, r = random_scene_inputs(0, 50, 64, 96)
    tx, ty, tw, th = 6, 4, 16, 16
    b = both_bin_gaussians(m, d, r, tx, ty, tw, th, 4096)
    x0, y0, x1, y1 = (v.numpy() for v in binning.tile_rect(torch.from_numpy(m),
                                                           torch.from_numpy(r), tx, ty, tw, th))
    assert int(b.num_pairs) == int(((x1 - x0) * (y1 - y0)).sum()) > 0
    off, pg = b.tile_offsets.numpy(), b.pair_gauss.numpy()
    for t in range(tx * ty):
        idx = pg[off[t]:off[t + 1]]
        assert (x0[idx] <= t % tx).all() and (x1[idx] > t % tx).all()
        assert (y0[idx] <= t // tx).all() and (y1[idx] > t // tx).all()
        assert (np.diff(d[idx]) >= 0).all()  # depth order within the tile


def test_aligned_binning_matches_reference_binning():
    """test_aligned_binning_matches_reference_binning on the port: each
    tile's valid aligned slots hold the reference's Gaussians in its order,
    padding at the tail, nothing valid outside the ranges."""
    m, d, r = random_scene_inputs(0, 50, 64, 96)
    tx, ty, tw, th, align = 6, 4, 16, 16, 8
    b = both_bin_gaussians(m, d, r, tx, ty, tw, th, 4096)
    ab = binning.bin_gaussians_aligned(torch.from_numpy(m), torch.from_numpy(d),
                                       torch.from_numpy(r), tx, ty, tw, th, 4096, align)
    assert int(ab.num_pairs) == int(b.num_pairs)
    off = b.tile_offsets.numpy()
    starts, ends = ab.starts.numpy(), ab.ends.numpy()
    pg, valid = ab.pair_gauss.numpy(), ab.valid.numpy()
    outside = np.ones(len(valid), bool)
    for t in range(tx * ty):
        assert starts[t] % align == 0 and ends[t] % align == 0
        got_valid = valid[starts[t]:ends[t]]
        np.testing.assert_array_equal(pg[starts[t]:ends[t]][got_valid],
                                      b.pair_gauss.numpy()[off[t]:off[t + 1]])
        assert not got_valid[got_valid.sum():].any()
        outside[starts[t]:ends[t]] = False
    assert not valid[outside].any()


@pytest.mark.parametrize("budget", [1024, 20])
def test_bin_gaussians_budget_sentinel_padding(budget):
    """test_budget_sentinel_padding, and a budget below num_pairs: the slots
    past the budget's pairs carry the sentinel tile, equal to gs_tpu's."""
    m, d, r = random_scene_inputs(1, 10, 32, 32)
    b = both_bin_gaussians(m, d, r, 2, 2, 16, 16, budget)
    npairs = int(b.num_pairs)
    assert b.pair_tile.shape == (budget,)
    if budget >= npairs:
        assert (b.pair_tile[npairs:] == 4).all() and int(b.tile_offsets[-1]) == npairs
    else:
        assert int(b.tile_offsets[-1]) == budget and (b.pair_tile < 4).all()


def test_vec_cumsum_and_cummax_match():
    x = np.random.default_rng(7).integers(-50, 90, 1000).astype(np.int32)
    got_s, got_m = binning.vec_cumsum(torch.from_numpy(x)), binning.vec_cummax(torch.from_numpy(x))
    assert got_s.dtype == got_m.dtype == torch.int32
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(j_binning.vec_cumsum(jnp.asarray(x))))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(j_binning.vec_cummax(jnp.asarray(x))))


def test_bin_gaussians_without_gaussians():
    """No Gaussian: every slot is padding, every tile empty."""
    empty = torch.zeros((0, 2)), torch.zeros(0), torch.zeros(0, dtype=torch.int32)
    b = binning.bin_gaussians(*empty, 3, 2, 16, 16, 64)
    assert int(b.num_pairs) == 0 and b.depth_order.shape == (0,)
    assert (b.pair_tile == 6).all() and (b.tile_offsets == 0).all()
    assert b.pair_gauss.shape == (64,) and b.tile_offsets.shape == (7,)
