"""gs_tpu_torch's pair-movement kernels B5 / B6 and their switches, against gs_tpu on the CPU.

gs_tpu's ``pairmove`` kernels (``_segred_kernel``, ``_expand_kernel``) run
here in interpret mode, as ``tests/test_pairmove.py`` runs them. On the
same numpy inputs:

- B5: ``segment_reduce_torch`` and the ``segment_reduce_sorted`` wrapper
  (which runs it on CPU tensors) against gs_tpu's ``segment_reduce_sorted``
  on test_pairmove's cases, to |d| <= 2e-5 x the segment's sum of |rows|
  (zero-count Gaussians exactly 0);
- B6: ``expand_intervals_torch`` and the ``expand_intervals`` wrapper
  against gs_tpu's ``expand_intervals``, bitwise, float and integer fields,
  also on the edge layouts of B6's block windows (``EXPAND_EDGES``), and
  against numpy on those gs_tpu cannot take (16 columns, NaN payloads and
  -0.0 as words);
- binning with ``count_by_gauss`` on both expansion paths against gs_tpu's
  ``"pallas"`` and ``"scatter"``, bitwise, with and without overflow;
- ``GatherPairsSegsum``'s gradient against the plain gather's, and
  ``rasterize_tiled``'s gradients under both ``GRAD_REDUCE`` modes
  against gs_tpu's ``"pallas"``;
- one ``train_step`` with both switches on against gs_tpu's with both on;
- the kernels' wrappers called on both sides of gs_tpu's 2^24 limit, which
  the port does not have, and the rejected values.

B5 and B6 against their plain versions on the card are marked ``cuda``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_tpu import cameras as j_cameras
from gs_tpu import training as j_training
from gs_tpu.config import OptimizationParams as JOptimizationParams
from gs_tpu.config import PipelineParams as JPipelineParams
from gs_tpu.config import RasterizeConfig as JRasterizeConfig
from gs_tpu.models import densify as j_densify
from gs_tpu.models import optim as j_optim
from gs_tpu.ops import binning as j_binning
from gs_tpu.ops import pairmove as j_pairmove
from gs_tpu.ops import rasterize_pallas as j_pallas
from gs_tpu.ops import rasterize_tiled as j_tiled
from gs_tpu_torch import interop, training
from gs_tpu_torch.config import OptimizationParams, RasterizeConfig
from gs_tpu_torch.ops import binning, cuda_build, pairmove, rasterize_tiled
from tests.test_torch_binning import screen_inputs
from tests.test_torch_tile import _close_per_column, _numpy_scene
from tests.torch_port_inputs import camera_args, camera_dict, jax_state, scene_arrays

# --- B5: segment reduce ----------------------------------------------------------------------

# name -> (b, n, window, rows, zero_frac): tests/test_pairmove.py:50-65's cases, and an
# empty input
SEGRED_CASES = {
    "dense": (5000, 1000, 256, 512, 0.0),
    "n_not_window_multiple": (3000, 777, 128, 256, 0.0),
    "single_block": (700, 65, 256, 128, 0.0),
    "mostly_empty": (100, 4000, 512, 512, 0.0),
    "zero_count_runs": (2000, 3000, 256, 256, 0.9),
    "empty": (0, 50, 128, 128, 0.0),
}


# B5's block-window layouts (csrc/segment_reduce.cu: 256 Gaussians a block, windows
# streamed in pieces of 512 rows, segments over 512 rows summed by the whole block):
# name -> per-Gaussian row counts from an rng
SEGRED_EDGES = {
    # n not a multiple of 256, empty segments on both sides of each block boundary
    "block_edge_empties": lambda rng: _zeroed(rng.integers(0, 12, size=1000),
                                              [0, 255, 256, 511, 512, 767, 768, 999]),
    # a block (Gaussians 256-511) whose whole window is empty
    "empty_block": lambda rng: _zeroed(rng.integers(0, 12, size=800), slice(256, 512)),
    # one segment of 3,000 rows, longer than a staged piece, among short ones
    "long_segment": lambda rng: _set(rng.integers(0, 6, size=300), 150, 3000),
    # every 32nd segment over 512 rows, and two side by side across a block boundary
    "long_every_32nd": lambda rng: _set(_set(rng.integers(0, 6, size=600), slice(0, None, 32),
                                             rng.integers(513, 700, size=19)), [255, 256],
                                        [513, 640]),
}


def _zeroed(counts, where):
    counts[where] = 0
    return counts


def _set(counts, where, value):
    counts[where] = value
    return counts


def _sorted_ids(rng, b, n, zero_frac):
    live = max(1, int(n * (1.0 - zero_frac)))
    pool = np.sort(rng.choice(n, size=live, replace=False))
    return np.sort(rng.choice(pool, size=b)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def segred_case(name):
    """(rows [B, 9], seg_cum [n], n, gs_tpu's sums [n, 9], sum |rows| per segment)."""
    rng = np.random.default_rng(ALL_SEGRED.index(name))
    if name == "giant_segment":  # tests/test_pairmove.py:68-82
        b, n, window, rows = 4000, 64, 128, 256
        ids = np.zeros(b, np.int32)
        ids[b // 2:] = 7
        b_real = b
    elif name == "padding_ids":  # :85-102, rows past the last segment hold the null row's ids
        n, b_real, b_pad, window, rows = 200, 900, 300, 128, 128
        ids = np.concatenate([np.sort(rng.integers(0, n, size=b_real)),
                              np.full(b_pad, n)]).astype(np.int32)
        b = b_real + b_pad
    elif name in SEGRED_EDGES:
        counts = SEGRED_EDGES[name](rng)
        n, window, rows = counts.size, 256, 512
        ids = np.repeat(np.arange(n), counts).astype(np.int32)
        b = b_real = ids.size
    else:
        b, n, window, rows, zero_frac = SEGRED_CASES[name]
        ids = _sorted_ids(rng, b, n, zero_frac)
        b_real = b
    g = rng.normal(size=(b, 9)).astype(np.float32)
    seg_cum = np.cumsum(np.bincount(ids[:b_real], minlength=n)).astype(np.int32)
    if b:
        want = np.asarray(j_pairmove.segment_reduce_sorted(
            jnp.asarray(g), jnp.asarray(ids), jnp.asarray(seg_cum), n, window=window, rows=rows))
    else:  # gs_tpu's kernel needs at least one row; the empty sums are 0
        want = np.zeros((n, 9), np.float32)
    sabs = np.zeros((n, 9))
    np.add.at(sabs, ids[:b_real], np.abs(g[:b_real]).astype(np.float64))
    return g, seg_cum, n, want, sabs


ALL_SEGRED = sorted(SEGRED_CASES) + ["giant_segment", "padding_ids"] + list(SEGRED_EDGES)


@pytest.mark.parametrize("fn", ["segment_reduce_torch", "segment_reduce_sorted"])
@pytest.mark.parametrize("case", ALL_SEGRED)
def test_segment_reduce_matches_gs_tpu(case, fn):
    g, seg_cum, n, want, sabs = segred_case(case)
    before = dict(cuda_build.LAUNCHES)
    got = getattr(pairmove, fn)(torch.from_numpy(g), torch.from_numpy(seg_cum), n).numpy()
    assert cuda_build.LAUNCHES == before  # no kernel on CPU tensors
    assert got.shape == (n, 9) and got.dtype == np.float32
    assert (np.abs(got - want) <= 2e-5 * sabs).all()
    assert (got[sabs.sum(1) == 0] == 0).all()  # zero-count Gaussians are exactly 0
    # and against the float64 sum of each segment
    ref = np.zeros((n, 9))
    ids = np.repeat(np.arange(n), np.diff(seg_cum, prepend=0))
    np.add.at(ref, ids, g[:ids.size].astype(np.float64))
    assert (np.abs(got - ref) <= 2e-5 * sabs).all()


def test_segment_reduce_cases_hold_their_shapes():
    assert segred_case("giant_segment")[1][7] - segred_case("giant_segment")[1][6] == 2000
    g, seg_cum, n, _, _ = segred_case("padding_ids")
    assert seg_cum[-1] < g.shape[0]  # rows past the last segment exist and are nonzero
    assert (np.diff(segred_case("zero_count_runs")[1], prepend=0) == 0).mean() > 0.8
    assert segred_case("empty")[0].shape[0] == 0
    counts = np.diff(segred_case("block_edge_empties")[1], prepend=0)
    assert counts.size % 256 and (counts[[0, 255, 256, 511, 512]] == 0).all()
    assert (np.diff(segred_case("empty_block")[1], prepend=0)[256:512] == 0).all()
    assert np.diff(segred_case("long_segment")[1], prepend=0).max() > 512
    counts = np.diff(segred_case("long_every_32nd")[1], prepend=0)
    assert (counts > 512).sum() == 20 and (counts[[255, 256]] > 512).all()


# --- B6: interval expand ---------------------------------------------------------------------


# B6's block (csrc/expand_intervals.cu's kBlockSlots; chip_smoke reads it from the library)
B6_BLOCK = 1024


def _edge_lengths(name, rng):
    """Interval lengths of B6's edge layouts (chip_smoke.expand_edge_layouts at a CPU
    size) and the slots past the last interval: name -> (lengths, extra slots)."""
    def lengths(n):
        return rng.integers(0, 12, size=n)

    if name == "n_not_block_multiple":
        return lengths(3001), 0
    if name == "empty_on_block_boundaries":  # each block split inside, a zero-length one first
        pieces = []
        for _ in range(6):
            cuts = np.sort(rng.choice(np.arange(1, B6_BLOCK), size=int(rng.integers(5, 40)),
                                      replace=False))
            pieces += [0, *np.diff(np.concatenate([[0], cuts, [B6_BLOCK]]))]
        return np.array(pieces), 0
    if name == "one_over_many_blocks":
        c = lengths(400)
        c[200] = 5 * B6_BLOCK + 123
        return c, 0
    if name == "run_of_100000_empty":  # 100,000 zero-length intervals sharing one offset
        return np.concatenate([lengths(1000), np.zeros(100_000, np.int64), lengths(1000)]), 0
    if name.startswith("total_mod_4_is_"):  # rows 1.. of the output start off 16 bytes
        e = lengths(1001)
        return e, (int(name[-1]) - int(e.sum())) % 4
    if name == "total_below_one_block":
        return lengths(150), 3
    raise KeyError(name)


EXPAND_EDGES = ("n_not_block_multiple", "empty_on_block_boundaries", "one_over_many_blocks",
                "run_of_100000_empty", "total_mod_4_is_1", "total_mod_4_is_2", "total_mod_4_is_3",
                "total_below_one_block")


def _expand_case(name):
    """(offsets, ends, float32 cols [12, N], total, rblk, wchunk): test_pairmove.py:159-171,
    and B6's edge layouts (EXPAND_EDGES)."""
    if name in EXPAND_EDGES:
        rng = np.random.default_rng(EXPAND_EDGES.index(name) + 20)
        counts, extra = _edge_lengths(name, rng)
        offsets = (np.cumsum(counts) - counts).astype(np.int32)
        ends = (offsets + counts).astype(np.int32)
        cols = (rng.normal(size=(12, counts.size))
                * 10.0 ** rng.integers(-6, 6, size=(12, counts.size))).astype(np.float32)
        return offsets, ends, cols, int(counts.sum()) + extra, 256, 128
    n, total, rblk, wchunk, zero_frac, gap_frac = {
        "dense": (700, 2000, 256, 128, 0.3, 0.0),
        "uncovered_gaps": (400, 1500, 128, 128, 0.5, 0.4),
        "many_empty": (3000, 900, 256, 256, 0.95, 0.0),
    }[name]
    rng = np.random.default_rng(len(name))
    counts = rng.integers(0, 9, size=n)
    counts[rng.random(n) < zero_frac] = 0
    gaps = (rng.random(n) < gap_frac) * rng.integers(1, 5, size=n)
    offsets = (np.cumsum(counts + gaps) - counts).astype(np.int32)
    ends = (offsets + counts).astype(np.int32)
    cols = (rng.normal(size=(12, n)) * 10.0 ** rng.integers(-6, 6, size=(12, n))).astype(
        np.float32)
    return offsets, ends, cols, total, rblk, wchunk


def _j_expand(offsets, ends, cols, total, rblk, wchunk):
    packed = j_pairmove.pack_interval_columns(
        jnp.asarray(offsets), jnp.asarray(ends), [jnp.asarray(c) for c in cols], wchunk=wchunk)
    out = j_pairmove.expand_intervals(packed, jnp.asarray(offsets), total, rblk=rblk,
                                      wchunk=wchunk)
    return np.asarray(out)[j_pairmove.VALS_ROW:j_pairmove.VALS_ROW + len(cols), :total]


@functools.lru_cache(maxsize=None)
def _expand_case_and_gs_tpu(case):
    """_expand_case(case) and gs_tpu's interpret-mode expansion of it (once per case)."""
    args = _expand_case(case)
    return args, _j_expand(*args)


@pytest.mark.parametrize("fn", ["expand_intervals_torch", "expand_intervals"])
@pytest.mark.parametrize("case", ["dense", "uncovered_gaps", "many_empty", *EXPAND_EDGES])
def test_expand_intervals_matches_gs_tpu_bitwise(case, fn):
    (offsets, ends, cols, total, rblk, wchunk), want = _expand_case_and_gs_tpu(case)
    before = dict(cuda_build.LAUNCHES)
    got = getattr(pairmove, fn)(torch.from_numpy(offsets), torch.from_numpy(ends),
                                torch.from_numpy(cols), total)
    assert cuda_build.LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == (12, total)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    if case == "uncovered_gaps":  # slots no interval owns are 0
        owned = np.zeros(total, bool)
        for o, e in zip(offsets, ends):
            owned[o:min(e, total)] = True
        assert (~owned).any() and (got.numpy()[:, ~owned] == 0).all()


@pytest.mark.parametrize("fn", ["expand_intervals_torch", "expand_intervals"])
def test_expand_intervals_integer_fields_exact(fn):
    """test_pairmove.py:173-190: offsets and indices up to 2^24 as int32 columns."""
    rng = np.random.default_rng(3)
    n, total = 900, 2600
    counts = rng.integers(0, 7, size=n)
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    ends = (offsets + counts).astype(np.int32)
    idx = rng.integers(0, (1 << 24) - 1, size=n).astype(np.int32)
    want = _j_expand(offsets, ends, [offsets, idx], total, 128, 128)
    got = getattr(pairmove, fn)(torch.from_numpy(offsets), torch.from_numpy(ends),
                                torch.from_numpy(np.stack([offsets, idx])), total)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert (got.numpy()[:, offsets[-1] + counts[-1]:] == 0).all()  # past the last interval


@pytest.mark.parametrize("fn", ["expand_intervals_torch", "expand_intervals"])
def test_expand_intervals_one_giant_interval(fn):
    """test_pairmove.py:193-203: one splat over 5,000 slots, then a short one."""
    offsets, ends = np.array([0, 5000], np.int32), np.array([5000, 5003], np.int32)
    cols = np.array([[3.25, -7.5]], np.float32)
    want = _j_expand(offsets, ends, cols, 5003, 256, 128)
    got = getattr(pairmove, fn)(torch.from_numpy(offsets), torch.from_numpy(ends),
                                torch.from_numpy(cols), 5003).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, :5000] == 3.25).all() and (got[0, 5000:] == -7.5).all()


def test_expand_edge_cases_hold_their_shapes():
    """Each of B6's edge layouts has the shape its name promises."""
    def counts(name):
        offsets, ends, _, total, _, _ = _expand_case(name)
        return offsets, ends - offsets, total

    off, lengths, total = counts("n_not_block_multiple")
    assert lengths.size % B6_BLOCK and total % B6_BLOCK
    off, lengths, total = counts("empty_on_block_boundaries")
    starts_empty = off[lengths == 0]
    assert set(range(0, total, B6_BLOCK)) <= set(starts_empty.tolist())
    assert counts("one_over_many_blocks")[1].max() > 5 * B6_BLOCK
    off, lengths, _ = counts("run_of_100000_empty")
    assert np.bincount(off[lengths == 0]).max() >= 100_000
    for r in (1, 2, 3):
        assert counts(f"total_mod_4_is_{r}")[2] % 4 == r
    assert counts("total_below_one_block")[2] < B6_BLOCK


def _expand_numpy(offsets, ends, words, total):
    """The expansion of 32-bit words in numpy: searchsorted, gather, mask."""
    slot = np.arange(total)
    owner = np.searchsorted(offsets, slot, side="right") - 1
    safe = np.maximum(owner, 0)
    return np.where((owner >= 0) & (slot < ends[safe]), words[:, safe], 0)


@pytest.mark.parametrize("fn", ["expand_intervals_torch", "expand_intervals"])
@pytest.mark.parametrize("layout", ["k_1", "k_16", "special_float_words"])
def test_expand_intervals_port_only_edges(layout, fn):
    """B6's edge layouts against numpy, bitwise as 32-bit words: one int32
    column, 16 columns, and float32 NaN payloads (quiet and signalling, both
    signs), infinities and -0.0. gs_tpu's kernel takes at most 14 value rows
    and its bf16-split matrix product turns NaN payloads and -0.0 into other
    words, so these are the port's own."""
    import chip_smoke

    rng = np.random.default_rng(31)
    h = rng.integers(0, 12, size=2000)
    k, kind = {"k_1": (1, "int"), "k_16": (16, "float"),
               "special_float_words": (5, "special")}[layout]
    offsets, ends, cols, total = chip_smoke.expand_edge_case(
        rng, (h, 0 * h, int(h.sum()) + 5, k, kind))
    got = getattr(pairmove, fn)(torch.from_numpy(offsets), torch.from_numpy(ends),
                                torch.from_numpy(cols), total)
    assert got.dtype == torch.from_numpy(cols).dtype and got.shape == (k, total)
    words = cols.view(np.int32)
    if kind == "special":
        assert np.isin(words.view(np.uint32), chip_smoke.SPECIAL_WORDS).mean() > 0.2
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  _expand_numpy(offsets, ends, words, total))


def test_pairmove_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError, match="seg_cum"):
        pairmove.segment_reduce_sorted(torch.zeros(4, 9), torch.zeros(3, dtype=torch.int64), 3)
    with pytest.raises(ValueError, match="cols"):
        pairmove.expand_intervals(torch.zeros(3, dtype=torch.int32),
                                  torch.zeros(3, dtype=torch.int32),
                                  torch.zeros(2, 3, dtype=torch.float64), 5)
    # the int32 index limit is checked before any kernel (a view: no 2^31 buffer)
    big = torch.zeros(1, 9).expand(1 << 31, 9)
    with pytest.raises(ValueError, match="2\\^31"):
        pairmove.segment_reduce_sorted(big, torch.zeros(1, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="2\\^31"):
        pairmove.expand_intervals(torch.zeros(1, dtype=torch.int32),
                                  torch.zeros(1, dtype=torch.int32),
                                  torch.zeros(1, 1, dtype=torch.int32), 1 << 31)


# --- binning's expansion paths ---------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6, 7, 8, 9))
def j_bin_counted(means2d, depths, radii, tiles_x, tiles_y, tile_w, tile_h, budget, align,
                  expand_impl):
    return j_binning.bin_gaussians_aligned(means2d, depths, radii, tiles_x, tiles_y, tile_w,
                                           tile_h, budget, align, count_by_gauss=True,
                                           expand_impl=expand_impl)


BIN_FIELDS = ("pair_gauss", "valid", "starts", "ends", "depth_order", "gauss_counts")


@pytest.mark.parametrize("impl", ["cuda", "scatter"])
@pytest.mark.parametrize("budget_frac", [1.0, 0.5])
def test_bin_expand_paths_match_gs_tpu(budget_frac, impl):
    """tests/test_tiled.py:85-111 at 300 Gaussians, 128x96, 16x16 tiles, align 8:
    both of the port's paths against both of gs_tpu's, bitwise."""
    n, w, h, tx, ty, align = 300, 128, 96, 8, 6, 8
    m, d, r = screen_inputs(n, w, h, seed=5)
    full = binning.bin_gaussians_aligned(torch.from_numpy(m), torch.from_numpy(d),
                                         torch.from_numpy(r), tx, ty, 16, 16, 8192, align)
    budget = max(int(int(full.num_pairs) * budget_frac), 8)
    got = binning.bin_gaussians_aligned(torch.from_numpy(m), torch.from_numpy(d),
                                        torch.from_numpy(r), tx, ty, 16, 16, budget, align,
                                        count_by_gauss=True, expand_impl=impl)
    for j_impl in ("pallas", "scatter"):
        want = j_bin_counted(jnp.asarray(m), jnp.asarray(d), jnp.asarray(r), tx, ty, 16, 16,
                             budget, align, j_impl)
        for field in BIN_FIELDS:
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)),
                                          err_msg=f"{field} vs gs_tpu {j_impl}")
        assert int(got.num_pairs) == int(want.num_pairs)
    counts = np.bincount(got.pair_gauss.numpy(), minlength=n + 1)[:n]
    np.testing.assert_array_equal(got.gauss_counts.numpy(), counts)
    if budget_frac < 1:
        assert int(got.num_pairs) > budget >= int(got.valid.sum())


def test_bin_expand_cuda_launches_b6_path(monkeypatch):
    """EXPAND_IMPL="cuda" sends step 2 through the B6 wrapper, once per binning;
    the default path does not call it."""
    calls = []
    orig = pairmove.expand_intervals
    monkeypatch.setattr(pairmove, "expand_intervals",
                        lambda *a: calls.append(a[3]) or orig(*a))
    m, d, r = screen_inputs(200, 64, 64, seed=9)
    args = (torch.from_numpy(m), torch.from_numpy(d), torch.from_numpy(r), 4, 4, 16, 16, 2000, 32)
    default = binning.bin_gaussians_aligned(*args)
    assert calls == []
    monkeypatch.setattr(binning, "EXPAND_IMPL", "cuda")
    expanded = binning.bin_gaussians_aligned(*args)
    assert calls == [2000]  # one expansion over the pair budget's slots
    for field in ("pair_gauss", "valid", "starts", "ends", "depth_order"):
        assert torch.equal(getattr(expanded, field), getattr(default, field)), field


def test_bin_expand_cuda_takes_wide_grids():
    """B6's owner fields carry x0 and y0 as columns of their own, so a grid
    600 tiles wide bins through B6 exactly as through the default path
    (gs_tpu packs them in 9 bits and takes grids below 512 tiles a side)."""
    n, tx, ty, tw, th, align = 300, 600, 2, 2, 16, 8
    m, d, r = screen_inputs(n, tx * tw, ty * th, seed=13)
    m[:, 1] = np.random.default_rng(14).uniform(-5, ty * th + 5, n).astype(np.float32)
    args = (torch.from_numpy(m), torch.from_numpy(d), torch.from_numpy(r), tx, ty, tw, th)
    budget = int(binning.bin_gaussians_aligned(*args, 1 << 20, align).num_pairs)
    got = binning.bin_gaussians_aligned(*args, budget, align, count_by_gauss=True,
                                        expand_impl="cuda")
    want = binning.bin_gaussians_aligned(*args, budget, align, count_by_gauss=True,
                                         expand_impl="scatter")
    assert int(got.valid.sum()) == budget > 0
    occupied = (got.ends > got.starts).nonzero().flatten()
    assert (occupied % tx >= 512).any()  # pairs on tiles whose x needs 10 bits
    for field in BIN_FIELDS:
        assert torch.equal(getattr(got, field), getattr(want, field)), field


# --- the kernels at gs_tpu's 2^24 limit, and rejected values ---------------------------------

LIMIT = 1 << 24


class _Called(Exception):
    """Raised by a wrapper's stand-in once it has recorded its call."""


def _stand_in(calls, record):
    def stand_in(*a):
        calls.append(record(*a))
        raise _Called
    return stand_in


@pytest.mark.parametrize("budget", [LIMIT - 1, LIMIT, LIMIT + 4096])
def test_expand_path_rule(monkeypatch, budget):
    """Under "cuda" the port calls B6's wrapper over the whole budget on both
    sides of 2^24 (its kernel indexes in int32); gs_tpu, traced with no
    buffer of that size, calls its kernel only below 2^24, where its f32 ids
    are exact. The wrapper's stand-in stops the binning at its call."""
    calls = []
    monkeypatch.setattr(pairmove, "expand_intervals", _stand_in(calls, lambda *a: a[3]))
    m, d, r = screen_inputs(100, 64, 64, seed=2)
    with pytest.raises(_Called):
        binning.bin_gaussians_aligned(torch.from_numpy(m), torch.from_numpy(d),
                                      torch.from_numpy(r), 4, 4, 16, 16, budget, 8,
                                      expand_impl="cuda")
    assert calls == [budget]
    j_called = []
    orig = j_pairmove.expand_intervals
    monkeypatch.setattr(j_pairmove, "expand_intervals",
                        lambda *a, **k: j_called.append(True) or orig(*a, **k))
    spec = jax.ShapeDtypeStruct
    jax.eval_shape(lambda m, d, r: j_binning.bin_gaussians_aligned(
        m, d, r, 4, 4, 16, 16, budget, 8, expand_impl="pallas"),
        spec((100, 2), jnp.float32), spec((100,), jnp.float32), spec((100,), jnp.int32))
    assert bool(j_called) == (budget < LIMIT)


@pytest.mark.parametrize("rows,n1", [(LIMIT - 1, 100), (LIMIT, 100), (100, LIMIT + 1)])
def test_reduce_path_rule(monkeypatch, rows, n1):
    """The port's reduction calls B5's wrapper with every sorted row on both
    sides of 2^24 rows and Gaussians; gs_tpu, traced, takes its kernel only
    below 2^24 and its cumsum at it. One column keeps the 2^24-row case
    small."""
    calls = []
    monkeypatch.setattr(pairmove, "segment_reduce_sorted",
                        _stand_in(calls, lambda rows, seg_cum, n: (rows.shape, n)))
    with pytest.raises(_Called):
        rasterize_tiled.reduce_pair_grads(torch.zeros(rows, 1), torch.zeros(rows, dtype=torch.int32),
                                          torch.zeros(n1 - 1, dtype=torch.int32), n1)
    assert calls == [((rows, 1), n1 - 1)]
    j_called = []
    orig = j_pairmove.segment_reduce_packed
    monkeypatch.setattr(j_tiled, "GRAD_REDUCE", "pallas")
    monkeypatch.setattr(j_pairmove, "segment_reduce_packed",
                        lambda *a, **k: j_called.append(True) or orig(*a, **k))
    spec = jax.ShapeDtypeStruct
    jax.eval_shape(lambda g, pg, sc: j_tiled.reduce_pair_grads(g, pg, sc, n1),
                   spec((rows, 9), jnp.float32), spec((rows,), jnp.int32),
                   spec((n1 - 1,), jnp.int32))
    assert bool(j_called) == (rows < LIMIT and n1 < LIMIT)


def test_unknown_switch_values_raise(monkeypatch):
    m, d, r = screen_inputs(20, 32, 32, seed=1)
    args = (torch.from_numpy(m), torch.from_numpy(d), torch.from_numpy(r), 2, 2, 16, 16, 256, 8)
    with pytest.raises(ValueError, match="expand_impl"):
        binning.bin_gaussians_aligned(*args, expand_impl="pallas")
    monkeypatch.setattr(binning, "EXPAND_IMPL", "gather")
    with pytest.raises(ValueError, match="expand_impl"):
        binning.bin_gaussians_aligned(*args)
    monkeypatch.setattr(rasterize_tiled, "GRAD_REDUCE", "pallas")
    sc = _numpy_scene(n=8, h=16, w=16)
    with pytest.raises(ValueError, match="GRAD_REDUCE"):
        rasterize_tiled.rasterize_tiled(*(torch.from_numpy(sc[k]) for k in (
            "means2d", "conics", "colors", "opacities", "depths", "radii")), 16, 16,
            torch.zeros(3), RasterizeConfig())


# --- the gradient reduction ------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["shuffled", "sorted", "one_gaussian"])
def test_gather_pairs_segsum_grad_matches_plain_gather(monkeypatch, layout):
    """tests/test_tiled.py:347-376: 37 Gaussians + the null row, 256 pair
    slots in a shuffled order (or Gaussian-sorted, or all of one Gaussian's),
    cotangents 0 on the padding slots. The backward goes through the B5
    wrapper once."""
    calls = []
    orig = pairmove.segment_reduce_sorted
    monkeypatch.setattr(pairmove, "segment_reduce_sorted",
                        lambda *a: calls.append(a[2]) or orig(*a))
    rng = np.random.default_rng(7)
    n, ab, k = 37, 256, 9
    attr = rng.normal(size=(n + 1, k)).astype(np.float32)
    counts = rng.integers(0, 9, size=n)
    if layout == "one_gaussian":
        counts = np.zeros(n, np.int64)
        counts[5] = 200
    pair_gauss = np.full(ab, n, np.int32)
    pair_gauss[:counts.sum()] = np.repeat(np.arange(n), counts)
    if layout != "sorted":
        pair_gauss = pair_gauss[rng.permutation(ab)]
    cot = rng.normal(size=(ab, k)).astype(np.float32) * (pair_gauss < n)[:, None]
    seg_cum = np.cumsum(counts).astype(np.int32)

    a = torch.from_numpy(attr).requires_grad_()
    pg, sc = torch.from_numpy(pair_gauss), torch.from_numpy(seg_cum)
    out = rasterize_tiled.GatherPairsSegsum.apply(a, pg, sc)
    assert torch.equal(out, a[pg.long()])
    (out * torch.from_numpy(cot)).sum().backward()
    assert calls == [n]
    a_ref = torch.from_numpy(attr).requires_grad_()
    (a_ref[pg.long()] * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), a_ref.grad.numpy(), rtol=1e-6, atol=1e-6)
    assert (a.grad[n] == 0).all()  # the null row
    j_grad = jax.grad(lambda x: jnp.vdot(j_tiled.gather_pairs_segsum(
        x, jnp.asarray(pair_gauss), jnp.asarray(seg_cum)), jnp.asarray(cot)))(jnp.asarray(attr))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(j_grad), rtol=1e-4, atol=1e-4)


LEAVES = ("means2d", "conics", "colors", "opacities")
RASTER_KW = dict(tile_w=16, tile_h=16, chunk=32)


@pytest.fixture(scope="module")
def reduce_scene():
    """tests/test_tiled.py:378-407's case at 160 Gaussians, 64x48, drawn with
    numpy, and gs_tpu's gradients with GRAD_REDUCE="pallas" (the segment-reduce
    kernel in interpret mode) on its XLA compositing backend."""
    sc = _numpy_scene(n=160, h=48, w=64, seed=11)
    target = np.random.default_rng(12).uniform(size=(3, 48, 64)).astype(np.float32)
    bg = np.array([0.3, 0.2, 0.1], np.float32)

    def loss(*leaves):
        out = j_tiled.rasterize_tiled(*leaves, jnp.asarray(sc["depths"]),
                                      jnp.asarray(sc["radii"]), 48, 64, jnp.asarray(bg),
                                      JRasterizeConfig(backend="xla", **RASTER_KW))
        return jnp.mean((out.image - target) ** 2)

    old = j_tiled.GRAD_REDUCE
    j_tiled.GRAD_REDUCE = "pallas"
    try:
        grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(sc[k]) for k in LEAVES))
    finally:
        j_tiled.GRAD_REDUCE = old
    return sc, target, bg, [np.asarray(g) for g in grads]


def _port_grads(sc, target, bg):
    leaves = [torch.from_numpy(sc[k]).requires_grad_() for k in LEAVES]
    out = rasterize_tiled.rasterize_tiled(*leaves, torch.from_numpy(sc["depths"]),
                                          torch.from_numpy(sc["radii"]), 48, 64,
                                          torch.from_numpy(bg), RasterizeConfig(**RASTER_KW))
    ((out.image - torch.from_numpy(target)) ** 2).mean().backward()
    return [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("mode", ["scatter", "cuda"])
def test_rasterize_grads_match_across_reduce_modes(monkeypatch, reduce_scene, mode):
    """Each mode against gs_tpu's "pallas" (per column, rtol 1e-4 + 1e-5 x
    max) and against the port's "scatter" at test_tiled's bar (rtol 1e-5,
    atol 1e-5 x max). "cuda" goes through the B5 wrapper once."""
    sc, target, bg, want = reduce_scene
    scatter = _port_grads(sc, target, bg)
    calls = []
    orig = pairmove.segment_reduce_sorted
    monkeypatch.setattr(pairmove, "segment_reduce_sorted",
                        lambda *a: calls.append(a[2]) or orig(*a))
    monkeypatch.setattr(rasterize_tiled, "GRAD_REDUCE", mode)
    got = _port_grads(sc, target, bg)
    assert calls == ([160] if mode == "cuda" else [])
    for name, g, s, w in zip(LEAVES, got, scatter, want):
        assert float(np.abs(w).max()) > 0, name
        _close_per_column(g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1), name=name)
        scale = max(float(np.abs(s).max()), 1e-3)
        np.testing.assert_allclose(g, s, rtol=1e-5, atol=1e-5 * scale, err_msg=name)


# --- the slice: one train_step with both switches on -----------------------------------------


def test_train_step_with_both_switches_matches_gs_tpu(monkeypatch):
    """One train_step (render, L1 + SSIM, backward, Adam, densify stats) at
    48x48 with 64 Gaussians, chunk 8, 16x16 tiles: GRAD_REDUCE and the
    expansion path on in both packages, gs_tpu's Pallas kernels in
    interpret mode. The pair_budget_factor is this test's own, so gs_tpu's
    jitted step is traced here with the switches on."""
    monkeypatch.setattr(j_tiled, "GRAD_REDUCE", "pallas")
    monkeypatch.setattr(j_binning, "EXPAND_IMPL", "pallas")
    monkeypatch.setattr(rasterize_tiled, "GRAD_REDUCE", "cuda")
    monkeypatch.setattr(binning, "EXPAND_IMPL", "cuda")
    seen = {"expand": 0, "reduce": 0, "j_expand": 0, "j_reduce": 0}
    for mod, name, key in ((pairmove, "expand_intervals", "expand"),
                           (pairmove, "segment_reduce_sorted", "reduce"),
                           (j_pairmove, "expand_intervals", "j_expand"),
                           (j_pairmove, "segment_reduce_packed", "j_reduce")):
        def rec(*a, _orig=getattr(mod, name), _key=key, **k):
            seen[_key] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, rec)

    arr = scene_arrays(n=64, sh_degree=3, seed=41, dead=4)
    arr["log_scale"] = np.random.default_rng(43).uniform(-3.0, -1.5, (64, 3)).astype(np.float32)
    args = camera_args(48, 48)
    args["T"] = np.array([0.1, 0.2, 3.0])
    jcam = j_cameras.make_camera(**args)
    target = dict(arr, xyz=arr["xyz"] + np.random.default_rng(42).normal(
        0, 0.05, arr["xyz"].shape).astype(np.float32))
    kw = dict(chunk=8, tile_w=16, tile_h=16, pair_budget_factor=7.25)
    img = np.asarray(j_training.eval_render(jax_state(target), jcam, jnp.zeros(3),
                                            active_sh_degree=0,
                                            raster_cfg=JRasterizeConfig(backend="xla", **kw)))
    jcam = jcam.replace(image=jnp.asarray(img))
    opt = dict(iterations=100, position_lr_max_steps=100)
    jstate, jadam, _, jm = j_training.train_step(
        jax_state(arr), j_optim.init(jax_state(arr).params()), j_densify.DensifyStats.zeros(64),
        jcam, jnp.zeros(3), jnp.int32(0), jnp.float32(1.5), active_sh_degree=0,
        opt_cfg=JOptimizationParams(**opt), raster_cfg=JRasterizeConfig(backend="pallas", **kw),
        accumulate_stats=True, pipe=JPipelineParams(), apply_update=True)
    ts = training.init_train_state(interop.state_from_numpy(arr, "cpu"), 1.5, 0)
    cam = interop.camera_from_numpy(dict(camera_dict(jcam), image=img), "cpu")
    state, adam, stats, m = training.train_step(
        ts.state, ts.adam, ts.stats, cam, torch.zeros(3), 0, 1.5, active_sh_degree=0,
        opt_cfg=OptimizationParams(**opt), raster_cfg=RasterizeConfig(**kw),
        accumulate_stats=True)
    assert j_pallas._interpret()
    # the port went through B6 (eval target is gs_tpu's) and B5 once each
    assert seen["expand"] == 1 and seen["reduce"] == 1
    assert seen["j_expand"] >= 1 and seen["j_reduce"] >= 1
    assert int(m["num_pairs"]) == int(jm["num_pairs"]) > 0
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    for k in ("xyz", "f_dc", "opacity", "scaling", "rotation"):
        g_got, g_want = adam.mu[k].numpy(), np.asarray(jadam.mu[k])
        assert float(np.abs(g_want).max()) > 0, k
        np.testing.assert_allclose(g_got, g_want, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(g_want).max()), err_msg=k)
        same = np.sign(g_got) == np.sign(g_want)
        np.testing.assert_allclose(state.params()[k].numpy()[same],
                                   np.asarray(jstate.params()[k])[same], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


# --- on the card -----------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_segment_reduce_matches_plain(cuda_device):
    """B5 against its plain version on the card, to 2e-5 x the segment's
    sum of |rows|, zero-count Gaussians 0, the same bits on a second launch."""
    g, seg_cum, n, _, sabs = segred_case("zero_count_runs")
    rows, sc = torch.from_numpy(g).to(cuda_device), torch.from_numpy(seg_cum).to(cuda_device)
    before = cuda_build.LAUNCHES["segment_reduce"]
    got = pairmove.segment_reduce_sorted(rows, sc, n)
    again = pairmove.segment_reduce_sorted(rows, sc, n)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["segment_reduce"] == before + 2
    ref = pairmove.segment_reduce_torch(rows, sc, n)
    assert torch.equal(got, again)
    assert (np.abs(got.cpu().numpy() - ref.cpu().numpy()) <= 2e-5 * sabs).all()
    assert (got.cpu()[torch.from_numpy(sabs.sum(1) == 0)] == 0).all()


@pytest.mark.cuda
def test_cuda_segment_reduce_edge_layouts(cuda_device):
    """chip_smoke.py's B5 edge layouts (n not a multiple of 256, empty
    segments at block boundaries, an empty block, a 100,000-row segment,
    every 16th segment ~1,000 rows, num_rows cutting the last segment)
    against the plain version on the CPU: bitwise on the segments B5 sums
    in row order, one rounding on those it sums as a block; the same bits
    twice, nothing read past the segments or num_rows."""
    import chip_smoke

    results = chip_smoke.segment_reduce_edges(torch, cuda_device)  # raises on a failed check
    assert all(r["row_order_equal"] and r["long_within_one_rounding"] and r["same_bits"]
               for r in results.values())


@pytest.mark.cuda
def test_cuda_expand_intervals_edge_layouts(cuda_device):
    """chip_smoke.py's B6 edge layouts (n and total no multiple of its block,
    a zero-length interval on every block boundary, one interval over 50
    blocks, 100,000 zero-length intervals at one offset, total % 4 = 1, 2, 3,
    total below one block, uncovered gaps, K = 1 and 16, NaN payloads and
    -0.0) against the plain version, bitwise as 32-bit words."""
    import chip_smoke

    results = chip_smoke.expand_intervals_edges(torch, cuda_device)  # raises on a failed check
    assert all(r["equal_to_plain"] for r in results.values())


@pytest.mark.cuda
def test_cuda_expand_intervals_matches_plain(cuda_device):
    """B6 against its plain version on the card, bitwise."""
    offsets, ends, cols, total, _, _ = _expand_case("uncovered_gaps")
    args = [torch.from_numpy(x).to(cuda_device) for x in (offsets, ends, cols)]
    before = cuda_build.LAUNCHES["expand_intervals"]
    got = pairmove.expand_intervals(*args, total)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["expand_intervals"] == before + 1
    assert torch.equal(got.view(torch.int32),
                       pairmove.expand_intervals_torch(*args, total).view(torch.int32))
