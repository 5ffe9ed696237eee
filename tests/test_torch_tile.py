"""gs_tpu_torch's tile-walk compositing form (B3 / B4) against gs_tpu's, on the CPU.

gs_tpu runs its tile-grid Pallas kernels ``_fwd_tile_kernel`` /
``_bwd_tile_kernel`` instead of the chunk-grid ones when the pair buffer is
large (``rasterize_tiled._pick_kernel_mode``); the port picks B3 / B4 by
the same rule (``pick_kernel_mode``). Here, on the same numpy inputs:

- the rule and the pair-layout alignment equal gs_tpu's, on both sides of
  the switch point, and the 128-aligned binning integers are equal;
- the port's plain versions (which the tile wrappers run on CPU tensors)
  against the interpret-mode tile kernels: forward at B1's tolerances
  (color 2e-5, T 2e-6, no ncon mismatch), backward per column at B2's
  (rtol 1e-4 + 1e-5 x the column's max), on tiles that cover a range that
  is not a whole superstep, an empty tile, a tile whose pixels all die in
  its first chunk, and rows past a trimmed end;
- the slice: ``rasterize_tiled`` (image and gradients) and one
  ``train_step`` with the tile form forced in both packages by their
  switch-point constants, against gs_tpu's ``backend="pallas"``.

B3 and B4 against their plain versions on the card are marked ``cuda``.
"""

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
from gs_tpu.ops import rasterize_pallas as j_pallas
from gs_tpu.ops import rasterize_tiled as j_tiled
from gs_tpu_torch import interop, training
from gs_tpu_torch.config import OptimizationParams, RasterizeConfig
from gs_tpu_torch.ops import binning, rasterize_cuda, rasterize_tiled
from tests.test_torch_binning import j_bin, screen_inputs
from tests.torch_port_inputs import camera_args, camera_dict, jax_state, scene_arrays

# --- the rule and the alignment ---------------------------------------------------------

# (pair_budget, chunk, num_tiles): the heavy scene's pairs at 48x32, a small
# budget, both sides of the 5.69M-pair switch point at 1,360 tiles, and the
# bench scene's grown 16x16 budget
MODE_CASES = [
    (14_795_840, 64, 1360),
    (1_000_000, 64, 1360),
    (5_690_816, 64, 1360),
    (5_690_880, 64, 1360),
    (4_912_512, 64, 8160),
]


@pytest.mark.parametrize("budget,chunk,tiles", MODE_CASES)
def test_pick_kernel_mode_matches(budget, chunk, tiles):
    want = j_tiled._pick_kernel_mode("pallas", budget, chunk, tiles)
    for backend in ("cuda", "auto"):
        assert rasterize_tiled.pick_kernel_mode(backend, budget, chunk, tiles) == want
    assert rasterize_tiled.pick_kernel_mode("torch", budget, chunk, tiles) is None
    assert j_tiled._pick_kernel_mode("xla", budget, chunk, tiles) is None


def test_switch_point_is_between_the_two_budgets():
    chunk_side, tile_side = MODE_CASES[2][0], MODE_CASES[3][0]
    assert rasterize_tiled.pick_kernel_mode("cuda", chunk_side, 64, 1360) == "chunk"
    assert rasterize_tiled.pick_kernel_mode("cuda", tile_side, 64, 1360) == "tile"
    assert tile_side - chunk_side == 64  # one chunk apart


@pytest.mark.parametrize("chunk", [8, 32, 64, 96])
@pytest.mark.parametrize("mode", ["tile", "chunk"])
def test_binning_align_matches(chunk, mode):
    got = rasterize_tiled.binning_align(chunk, "cuda", mode)
    assert got == j_tiled.binning_align(chunk, "pallas", mode)
    assert rasterize_tiled.binning_align(chunk, "torch", None) == chunk
    if mode == "tile":
        assert got % 128 == 0 and got % chunk == 0


# (width, height, tile_w, tile_h, chunk, budget): budget None = no overflow
BIN_CASES = [
    (61, 47, 16, 16, 32, None),
    (100, 64, 48, 32, 64, None),
    (64, 64, 16, 16, 64, 700),  # overflow: a depth prefix of Gaussians fits
]


@pytest.mark.parametrize("w,h,tw,th,chunk,budget", BIN_CASES)
def test_bin_gaussians_aligned_tile_layout(w, h, tw, th, chunk, budget):
    """The tile form's lcm(chunk, 128) layout: integers equal to gs_tpu's."""
    n = 400
    align = rasterize_tiled.binning_align(chunk, "cuda", "tile")
    m, d, r = screen_inputs(n, w, h, seed=w + chunk + (budget or 0))
    tx, ty = -(-w // tw), -(-h // th)
    budget = budget or 8 * n
    got = binning.bin_gaussians_aligned(torch.from_numpy(m), torch.from_numpy(d),
                                        torch.from_numpy(r), tx, ty, tw, th, budget, align)
    want = j_bin(jnp.asarray(m), jnp.asarray(d), jnp.asarray(r), tx, ty, tw, th, budget, align)
    for field in ("pair_gauss", "valid", "starts", "ends"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    assert int(got.num_pairs) == int(want.num_pairs)
    assert (got.starts % 128 == 0).all() and ((got.ends - got.starts) % 128 == 0).all()
    if budget < 8 * n:
        assert int(got.num_pairs) > budget


# --- the tile-walk kernels' function ----------------------------------------------------

CHUNK = 32
TILE = 16
SLOTS = 256  # pair slots per tile: two supersteps of 4 chunks


def _splats(rng, n, x0, y0, sigma=(1.5, 6.0), opac=(0.05, 0.9)):
    """[n, 9] packed attributes of random splats around a 16x16 tile at (x0, y0)."""
    sa = rng.uniform(*sigma, n) ** 2
    sc = rng.uniform(*sigma, n) ** 2
    sb = rng.uniform(-0.8, 0.8, n) * np.sqrt(sa * sc)
    det = sa * sc - sb * sb
    return np.concatenate([
        np.stack([x0 + rng.uniform(-4, TILE + 4, n), y0 + rng.uniform(-4, TILE + 4, n)], -1),
        np.stack([sc / det, -sb / det, sa / det], -1),
        rng.uniform(0, 1, (n, 3)),
        rng.uniform(*opac, n)[:, None],
    ], axis=1).astype(np.float32)


def _opaque(n, x0, y0):
    """Splats centred on a tile, 200 px wide, at opacity 0.99: three stop every pixel."""
    a = np.full(n, 1.0 / 40000.0)
    return np.concatenate([
        np.stack([np.full(n, x0 + TILE / 2), np.full(n, y0 + TILE / 2)], -1),
        np.stack([a, np.zeros(n), a], -1), np.full((n, 3), 0.5), np.full((n, 1), 0.99),
    ], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def tiles():
    """Four 16x16 tiles (2 x 2) over 1,024 pair slots, chunk 32:
    tile 0 composites [0, 160), one superstep and one chunk; tile 1 is
    empty; tile 2's first chunk holds opaque splats that stop every pixel;
    tile 3's pixels all stop at pair 712, so its backward range is trimmed
    below its forward end. Slots 160-255 and 768-1,023 belong to no range."""
    rng = np.random.default_rng(7)
    sp = np.zeros((4 * SLOTS, 9), np.float32)
    sp[0:160] = _splats(rng, 160, 0, 0)
    sp[256:512] = _splats(rng, 256, 0, 16)
    sp[256 + 5:256 + 9] = _opaque(4, 0, 16)
    sp[512:768] = _splats(rng, 256, 16, 16)
    sp[512 + 200:512 + 204] = _opaque(4, 16, 16)
    starts = np.array([0, 256, 256, 512], np.int32)
    ends = np.array([160, 256, 512, 768], np.int32)
    st_j = j_tiled.CompositeStatic(tiles_x=2, tiles_y=2, tile_w=TILE, tile_h=TILE, chunk=CHUNK,
                                   tile_batch=4, backend="pallas", kernel_mode="tile")
    st = rasterize_tiled.CompositeStatic(2, 2, TILE, TILE, CHUNK, 4, "cuda", "tile")
    m, p = 4, TILE * TILE
    g_color = rng.normal(size=(m, p, 3)).astype(np.float32)
    g_t = rng.normal(size=(m, p)).astype(np.float32)
    tile_ids = np.arange(4, dtype=np.int32)

    assert j_pallas._interpret()  # the Pallas kernels run in interpret mode here
    args = tuple(jnp.asarray(x) for x in (sp, tile_ids, starts, ends))
    color, t_final, ncon = j_pallas.composite_fwd_pallas(st_j, *args)
    trimmed = j_tiled.ncon_trimmed_ends(st_j, args[2], args[3], ncon)
    d_attr = j_pallas.composite_bwd_pallas(
        st_j, (args[0], args[1], args[2], trimmed, t_final, ncon),
        (jnp.asarray(g_color), jnp.asarray(g_t), None))[0]
    want = {k: np.asarray(v) for k, v in dict(color=color, t_final=t_final, ncon=ncon,
                                              trimmed=trimmed, d_attr=d_attr).items()}
    return dict(st=st, sp=sp, tile_ids=tile_ids, starts=starts, ends=ends, g_color=g_color,
                g_t=g_t, want=want)


def _t(x):
    return torch.from_numpy(np.array(x))


def _fwd_args(tl):
    return tl["st"], _t(tl["sp"]), _t(tl["tile_ids"]), _t(tl["starts"]), _t(tl["ends"])


def _bwd_args(tl):
    w = tl["want"]
    t_final = _t(w["t_final"])
    return (*_fwd_args(tl)[:4], _t(w["trimmed"]), t_final, _t(w["ncon"]), _t(tl["g_color"]),
            _t(tl["g_t"]) * t_final)


def _close_per_column(got, want, rtol=1e-4, atol_share=1e-5, name=""):
    got, want = np.asarray(got), np.asarray(want)
    for c in range(want.shape[-1]):
        scale = float(np.abs(want[..., c]).max())
        np.testing.assert_allclose(got[..., c], want[..., c], rtol=rtol,
                                   atol=atol_share * scale, err_msg=f"{name} column {c}")


def test_tiles_cover_the_cases(tiles):
    """The inputs really hold each case the kernels must get right."""
    w = tiles["want"]
    assert tiles["ends"][0] % (4 * CHUNK) != 0  # not a whole superstep
    assert tiles["starts"][1] == tiles["ends"][1]  # an empty tile
    assert (w["ncon"][1] == 0).all() and (w["t_final"][1] == 1).all()
    assert w["ncon"][2].max() <= 256 + CHUNK  # every pixel of tile 2 stops in chunk 0
    assert (w["t_final"][2] < 1e-2).all()
    assert w["trimmed"][3] < tiles["ends"][3]  # tile 3's backward range is trimmed
    assert (w["ncon"][0] > 0).any() and (w["ncon"][3] > 0).all()


@pytest.mark.parametrize("fn", ["composite_fwd_torch", "composite_fwd_tile_cuda"])
def test_tile_forward_matches_pallas_tile_kernel(tiles, fn):
    """The plain version, and the B3 wrapper on CPU tensors (which runs it),
    against the interpret-mode ``_fwd_tile_kernel``."""
    before = dict(rasterize_cuda.LAUNCHES)
    color, t_final, ncon = getattr(rasterize_cuda, fn)(*_fwd_args(tiles))
    assert rasterize_cuda.LAUNCHES == before  # no kernel on CPU tensors
    w = tiles["want"]
    np.testing.assert_allclose(color.numpy(), w["color"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(t_final.numpy(), w["t_final"], rtol=0, atol=2e-6)
    np.testing.assert_array_equal(ncon.numpy(), w["ncon"])


def test_ncon_trimmed_ends_match(tiles):
    w = tiles["want"]
    got = rasterize_tiled.ncon_trimmed_ends(tiles["st"], _t(tiles["starts"]),
                                            _t(tiles["ends"]), _t(w["ncon"]))
    np.testing.assert_array_equal(got.numpy(), w["trimmed"])


@pytest.mark.parametrize("fn", ["composite_bwd_torch", "composite_bwd_tile_cuda"])
def test_tile_backward_matches_pallas_tile_kernel(tiles, fn):
    before = dict(rasterize_cuda.LAUNCHES)
    got = getattr(rasterize_cuda, fn)(*_bwd_args(tiles))
    assert rasterize_cuda.LAUNCHES == before
    want = tiles["want"]["d_attr"]
    assert float(np.abs(want).max()) > 0
    _close_per_column(got.numpy(), want, name="d_attr")


def test_tile_backward_rows_outside_trimmed_ranges_are_zero(tiles):
    """Rows past a trimmed end (tile 3), past a forward end (tile 0) and in
    no range are exactly 0, in the port and in gs_tpu's masked result."""
    w = tiles["want"]
    got = rasterize_cuda.composite_bwd_torch(*_bwd_args(tiles)).numpy()
    covered = np.zeros(got.shape[0], bool)
    for s0, e0 in zip(tiles["starts"], w["trimmed"]):
        covered[s0:e0] = True
    past_trim = np.arange(w["trimmed"][3], tiles["ends"][3])
    assert past_trim.size and not covered[past_trim].any()
    assert (got[~covered] == 0).all() and (w["d_attr"][~covered] == 0).all()
    assert (got[covered] != 0).any()


# --- the tile order B4's blocks take -----------------------------------------------------

ORDER_CASES = [
    ([0, 5, 5, 20, 30, 40], [5, 5, 20, 25, 40, 50]),  # lengths 5, 0, 15, 5, 10, 10
    ([0] * 5, [0] * 5),  # all empty: index order
    ([7], [9]),
]


@pytest.mark.parametrize("starts,ends", ORDER_CASES)
def test_tile_order_is_longest_first_ties_in_index_order(starts, ends):
    starts = torch.tensor(starts, dtype=torch.int32)
    ends = torch.tensor(ends, dtype=torch.int32)
    order = rasterize_cuda.tile_order(starts, ends)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(starts.numel()))  # a permutation
    want = sorted(range(starts.numel()), key=lambda m: (-(int(ends[m]) - int(starts[m])), m))
    assert order.tolist() == want


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_plain_versions_ignore_the_tile_order(tiles, direction):
    """Every tile's result is independent of the others: the plain versions
    given the tiles in ``tile_order`` (B4's block order, here the longest
    trimmed range first) return the same bits, row for row, as in index
    order."""
    bwd = _bwd_args(tiles)
    order = rasterize_cuda.tile_order(bwd[3], bwd[4]).long()
    assert order.tolist() != list(range(order.numel()))  # the fixture's order permutes
    if direction == "forward":
        args = _fwd_args(tiles)
        got = rasterize_cuda.composite_fwd_torch(*args[:2], *(a[order] for a in args[2:]))
        ref = rasterize_cuda.composite_fwd_torch(*args)
        for g, r in zip(got, ref):
            assert torch.equal(g, r[order])
    else:
        per_tile = [a[order] for a in bwd[2:]]
        got = rasterize_cuda.composite_bwd_torch(bwd[0], bwd[1], *per_tile)
        ref = rasterize_cuda.composite_bwd_torch(*bwd)
        assert float(ref.abs().max()) > 0 and torch.equal(got, ref)


# --- the slice: tile form forced in both packages ---------------------------------------


@pytest.fixture
def tile_form(monkeypatch):
    """Both packages' switch points at 64 bytes: every budget takes the tile
    form. Yields the kernel forms each package's composite_tiles was given."""
    monkeypatch.setattr(j_tiled, "_SMEM_TABLE_BUDGET", 64)
    monkeypatch.setattr(rasterize_tiled, "TILE_MODE_TABLE_BYTES", 64)
    seen = {"jax": [], "port": []}
    j_orig, orig = j_tiled.composite_tiles, rasterize_tiled.composite_tiles

    def j_rec(st, *a):
        seen["jax"].append(st.kernel_mode)
        return j_orig(st, *a)

    def rec(st, *a):
        seen["port"].append(st.kernel_mode)
        return orig(st, *a)

    monkeypatch.setattr(j_tiled, "composite_tiles", j_rec)
    monkeypatch.setattr(rasterize_tiled, "composite_tiles", rec)
    return seen


def _numpy_scene(n=64, h=48, w=48, seed=3):
    """tests/test_tiled.py's random_scene at its tile-fallback size, drawn with numpy."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 30.0, n)
    c = rng.uniform(0.5, 30.0, n)
    b = rng.uniform(-0.9, 0.9, n) * np.sqrt(a * c)
    det = a * c - b * b
    mid = 0.5 * (a + c)
    lam = mid + np.sqrt(np.maximum(0.1, mid * mid - det))
    return dict(
        means2d=rng.uniform(-10.0, max(h, w) + 10.0, (n, 2)).astype(np.float32),
        conics=np.stack([c / det, -b / det, a / det], -1).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        opacities=rng.uniform(0.1, 1.0, n).astype(np.float32),
        depths=rng.uniform(2.0, 8.0, n).astype(np.float32),
        radii=np.ceil(3.0 * np.sqrt(lam)).astype(np.int32))


LEAVES = ("means2d", "conics", "colors", "opacities")


def test_rasterize_tiled_tile_form_matches_pallas(tile_form):
    """Image, T and the four leaves' gradients of one render, 48x48 pixels,
    64 Gaussians, chunk 8, 16x16 tiles."""
    sc = _numpy_scene()
    rng = np.random.default_rng(4)
    g_img = rng.normal(size=(3, 48, 48)).astype(np.float32)
    g_t = rng.normal(size=(48, 48)).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    kw = dict(chunk=8, tile_w=16, tile_h=16, pair_budget_factor=6.0)

    def j_loss(leaves):
        out = j_tiled.rasterize_tiled(*leaves, jnp.asarray(sc["depths"]),
                                      jnp.asarray(sc["radii"]), 48, 48, jnp.asarray(bg),
                                      JRasterizeConfig(backend="pallas", **kw))
        return jnp.sum(out.image * g_img) + jnp.sum(out.final_t * g_t), out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        [jnp.asarray(sc[k]) for k in LEAVES])
    leaves = [torch.from_numpy(sc[k]).requires_grad_() for k in LEAVES]
    out = rasterize_tiled.rasterize_tiled(*leaves, torch.from_numpy(sc["depths"]),
                                          torch.from_numpy(sc["radii"]), 48, 48,
                                          torch.from_numpy(bg), RasterizeConfig(**kw))
    ((out.image * torch.from_numpy(g_img)).sum() + (out.final_t * torch.from_numpy(g_t)).sum()
     ).backward()
    assert tile_form["port"] == ["tile"] and set(tile_form["jax"]) == {"tile"}
    np.testing.assert_allclose(out.image.detach().numpy(), np.asarray(j_out.image), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(out.final_t.detach().numpy(), np.asarray(j_out.final_t), rtol=0,
                               atol=2e-6)
    assert int(out.num_pairs) == int(j_out.num_pairs)
    for name, leaf, want in zip(LEAVES, leaves, j_grads):
        want = np.asarray(want)
        assert float(np.abs(want).max()) > 0, name
        _close_per_column(leaf.grad.numpy().reshape(want.shape[0], -1),
                          want.reshape(want.shape[0], -1), name=name)


def test_train_step_tile_form_matches_pallas(tile_form):
    """One train_step (render, L1 + SSIM, backward, Adam, densify stats) at
    48x48 with 64 Gaussians, chunk 8, 16x16 tiles, against gs_tpu's jitted
    step with its interpret-mode tile kernels."""
    arr = scene_arrays(n=64, sh_degree=3, seed=31, dead=4)
    arr["log_scale"] = np.random.default_rng(33).uniform(-3.0, -1.5, (64, 3)).astype(np.float32)
    args = camera_args(48, 48)
    args["T"] = np.array([0.2, -0.1, 3.0])  # close enough that the cloud covers the image
    jcam = j_cameras.make_camera(**args)
    target = dict(arr, xyz=arr["xyz"] + np.random.default_rng(32).normal(
        0, 0.05, arr["xyz"].shape).astype(np.float32))
    kw = dict(chunk=8, tile_w=16, tile_h=16, pair_budget_factor=7.0)
    img = np.asarray(j_training.eval_render(jax_state(target), jcam, jnp.zeros(3),
                                            active_sh_degree=0,
                                            raster_cfg=JRasterizeConfig(backend="xla", **kw)))
    tile_form["jax"].clear()  # the target's XLA render has no kernel form
    jcam = jcam.replace(image=jnp.asarray(img))
    opt = dict(iterations=100, position_lr_max_steps=100)
    jstate, jadam, _, jm = j_training.train_step(
        jax_state(arr), j_optim.init(jax_state(arr).params()), j_densify.DensifyStats.zeros(64),
        jcam, jnp.zeros(3), jnp.int32(0), jnp.float32(1.5), active_sh_degree=0,
        opt_cfg=JOptimizationParams(**opt), raster_cfg=JRasterizeConfig(backend="pallas", **kw),
        accumulate_stats=True, pipe=JPipelineParams(), apply_update=True)
    ts = training.init_train_state(interop.state_from_numpy(arr, "cpu"), 1.5, 0)
    cam = interop.camera_from_numpy(dict(camera_dict(jcam), image=img), "cpu")
    state, adam, _, m = training.train_step(
        ts.state, ts.adam, ts.stats, cam, torch.zeros(3), 0, 1.5, active_sh_degree=0,
        opt_cfg=OptimizationParams(**opt), raster_cfg=RasterizeConfig(**kw),
        accumulate_stats=True)
    assert tile_form["port"] == ["tile"] and set(tile_form["jax"]) == {"tile"}
    assert int(m["num_pairs"]) == int(jm["num_pairs"]) > 0
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    for k in ("xyz", "f_dc", "opacity", "scaling", "rotation"):
        g_got, g_want = adam.mu[k].numpy(), np.asarray(jadam.mu[k])
        assert float(np.abs(g_want).max()) > 0, k
        np.testing.assert_allclose(g_got, g_want, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(g_want).max()), err_msg=k)
        # Adam's first step moves each entry by lr x sign(gradient)
        same = np.sign(g_got) == np.sign(g_want)
        np.testing.assert_allclose(state.params()[k].numpy()[same],
                                   np.asarray(jstate.params()[k])[same], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


# --- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_fwd_tile_kernel_matches_plain(tiles, cuda_device):
    """B3 against its plain version on the card: same decisions, so ncon and
    T agree exactly and color to 2e-5; and bitwise against B1."""
    args = [tiles["st"], *(x.to(cuda_device) for x in _fwd_args(tiles)[1:])]
    before = rasterize_cuda.LAUNCHES["composite_fwd_tile"]
    got = rasterize_cuda.composite_fwd_tile_cuda(*args)
    torch.cuda.synchronize()
    assert rasterize_cuda.LAUNCHES["composite_fwd_tile"] == before + 1
    ref = rasterize_cuda.composite_fwd_torch(*args)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=2e-5)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=2e-6)
    assert torch.equal(got[2], ref[2])
    assert all(torch.equal(a, b) for a, b in zip(got, rasterize_cuda.composite_fwd_cuda(*args)))


@pytest.mark.cuda
def test_cuda_bwd_tile_kernel_matches_plain(tiles, cuda_device):
    """B4 against its plain version on the card, per column to rtol 1e-4,
    atol 1e-5 x max; rows outside every trimmed range exactly 0; bitwise
    against B2, whose layout, chunks, batches and sums it shares."""
    args = [tiles["st"], *(x.to(cuda_device) for x in _bwd_args(tiles)[1:])]
    before = rasterize_cuda.LAUNCHES["composite_bwd_tile"]
    got = rasterize_cuda.composite_bwd_tile_cuda(*args)
    torch.cuda.synchronize()
    assert rasterize_cuda.LAUNCHES["composite_bwd_tile"] == before + 1
    ref = rasterize_cuda.composite_bwd_torch(*args)
    _close_per_column(got.cpu().numpy(), ref.cpu().numpy(), name="d_attr")
    covered = torch.zeros(got.shape[0], dtype=torch.bool)
    for s0, e0 in zip(tiles["starts"], tiles["want"]["trimmed"]):
        covered[s0:e0] = True
    assert (got.cpu()[~covered] == 0).all()
    assert torch.equal(got, rasterize_cuda.composite_bwd_cuda(*args))
