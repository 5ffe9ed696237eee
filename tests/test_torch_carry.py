"""gs_tpu_torch's carry pair source (``PAIR_SOURCE="carry"``) against gs_tpu on the CPU.

gs_tpu's carry (``bin_carry_pairs``, binning's ``carry_attr``) runs its
pair-movement kernels in interpret mode, as ``tests/test_tiled.py`` runs
them; each of its results is computed once per module. On the same numpy
inputs:

- binning with ``carry_attr`` at budget fractions 1.0 and 0.5
  (test_tiled.py:85-111): ``pair_attr`` bitwise equal to
  ``attr_pad[pair_gauss]`` and to gs_tpu's ``pair_attr_t.T``, every other
  field equal to the default path's and gs_tpu's; one B6 call carries the
  five owner fields and the attributes as 14 int32 columns;
- 32-bit words that a float operation would change (denormals, which are
  what small int32 owner fields look like as float32, NaN payloads, -0.0)
  through B6, its plain version and the carry binning, bit for bit;
- ``rasterize_tiled`` under ``"carry"`` (test_tiled.py:410-447): the image
  bitwise equal to the gather path's, the gradients bitwise equal to the
  gather with ``GRAD_REDUCE="cuda"`` (both feed the same cotangent through
  the same B5) and within rtol 1e-5 + 1e-5 x max of gs_tpu's carry under
  ``GRAD_REDUCE="pallas"`` (its carry reduces with the segment-reduce kernel
  only there) and of the port's ``"scatter"`` gather;
- carry against the oracle (test_tiled.py:449-466);
- one ``train_step`` under ``"carry"`` in both packages.

The carry path on the card is marked ``cuda``.
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
from gs_tpu.ops import rasterize_tiled as j_tiled
from gs_tpu.ops.rasterize_oracle import rasterize_oracle as j_oracle
from gs_tpu_torch import interop, training
from gs_tpu_torch.config import OptimizationParams, RasterizeConfig
from gs_tpu_torch.ops import binning, cuda_build, pairmove, rasterize_tiled
from tests.test_torch_binning import screen_inputs
from tests.test_torch_tile import _numpy_scene
from tests.torch_port_inputs import camera_args, camera_dict, jax_state, scene_arrays

BIN_FIELDS = ("pair_gauss", "valid", "starts", "ends", "depth_order", "gauss_counts")
LEAVES = ("means2d", "conics", "colors", "opacities")


# --- binning with carry_attr -----------------------------------------------------------------

# test_tiled.py:85-111's case: 300 splats, 128x96, 16x16 tiles, align 8, drawn with numpy
N_BIN, W_BIN, H_BIN, TX, TY, ALIGN = 300, 128, 96, 8, 6, 8


@functools.lru_cache(maxsize=None)
def bin_case(budget_frac):
    """(screen inputs, attributes [300, 9], budget, gs_tpu's carry binning as numpy)."""
    m, d, r = screen_inputs(N_BIN, W_BIN, H_BIN, seed=5)
    full = binning.bin_gaussians_aligned(torch.from_numpy(m), torch.from_numpy(d),
                                         torch.from_numpy(r), TX, TY, 16, 16, 8192, ALIGN)
    budget = max(int(int(full.num_pairs) * budget_frac), 8)
    attr = np.random.default_rng(6).normal(size=(N_BIN, 9)).astype(np.float32)
    want = j_binning.bin_gaussians_aligned(
        jnp.asarray(m), jnp.asarray(d), jnp.asarray(r), TX, TY, 16, 16, budget, ALIGN,
        count_by_gauss=True, expand_impl="pallas", carry_attr=jnp.asarray(attr))
    want = {f: np.asarray(getattr(want, f)) for f in (*BIN_FIELDS, "num_pairs", "pair_attr_t")}
    return (m, d, r), attr, budget, want


def _bin(inputs, budget, **kw):
    m, d, r = (torch.from_numpy(x) for x in inputs)
    return binning.bin_gaussians_aligned(m, d, r, TX, TY, 16, 16, budget, ALIGN, **kw)


@pytest.mark.parametrize("budget_frac", [1.0, 0.5])
def test_carry_binning_matches_gather_and_gs_tpu(budget_frac):
    inputs, attr, budget, want = bin_case(budget_frac)
    got = _bin(inputs, budget, count_by_gauss=True, carry_attr=torch.from_numpy(attr))
    default = _bin(inputs, budget, count_by_gauss=True)
    for field in BIN_FIELDS:
        np.testing.assert_array_equal(getattr(got, field).numpy(), want[field], err_msg=field)
        assert torch.equal(getattr(got, field), getattr(default, field)), field
    assert int(got.num_pairs) == int(want["num_pairs"])
    attr_pad = np.concatenate([attr, np.zeros((1, 9), np.float32)])
    gathered = attr_pad[got.pair_gauss.numpy()]
    assert got.pair_attr.dtype == torch.float32 and got.pair_attr.shape == gathered.shape
    np.testing.assert_array_equal(got.pair_attr.numpy().view(np.uint32), gathered.view(np.uint32))
    np.testing.assert_array_equal(got.pair_attr.numpy().view(np.uint32),
                                  want["pair_attr_t"].T.view(np.uint32))
    if budget_frac < 1:  # the overflow dropped whole Gaussians
        assert int(got.num_pairs) > budget >= int(got.valid.sum())
    assert (got.pair_attr[~got.valid] == 0).all()


def test_carry_binning_takes_one_b6_call(monkeypatch):
    """The five owner fields and nine attributes go through B6's wrapper in
    one call of 14 int32 columns over the budget's slots, and nothing else
    of binning calls it."""
    calls = []
    orig = pairmove.expand_intervals
    monkeypatch.setattr(pairmove, "expand_intervals",
                        lambda *a: calls.append((a[2].dtype, tuple(a[2].shape), a[3])) or orig(*a))
    inputs, attr, budget, _ = bin_case(1.0)
    _bin(inputs, budget, carry_attr=torch.from_numpy(attr))
    assert calls == [(torch.int32, (binning.OWNER_FIELDS + 9, N_BIN), budget)]
    assert binning.OWNER_FIELDS + 9 <= pairmove.MAX_COLUMNS


def test_carry_binning_rejects_bad_attributes(monkeypatch):
    inputs, attr, budget, _ = bin_case(1.0)
    with pytest.raises(ValueError, match="expand_impl"):
        _bin(inputs, budget, carry_attr=torch.from_numpy(attr), expand_impl="scatter")
    with pytest.raises(ValueError, match="carry_attr"):
        _bin(inputs, budget, carry_attr=torch.zeros(N_BIN, binning.MAX_CARRY_COLUMNS + 1))
    with pytest.raises(ValueError, match="carry_attr"):
        _bin(inputs, budget, carry_attr=torch.from_numpy(attr).double())
    # the global EXPAND_IMPL does not stop carry: None means the B6 path
    monkeypatch.setattr(binning, "EXPAND_IMPL", "scatter")
    assert _bin(inputs, budget, carry_attr=torch.from_numpy(attr)).pair_attr is not None


# --- words a float operation would change ----------------------------------------------------

# denormals (what int32 owner fields 1..2^23 look like as float32, both signs),
# NaN payloads (quiet and signalling, both signs), infinities and -0.0
TOUCHY_WORDS = np.array([1, 2, 7, 4095, 1 << 20, (1 << 23) - 1, 0x80000001, 0x807FFFFF,
                         0x7FC00001, 0xFFC12345, 0x7F800001, 0xFFBFFFFF, 0x7F800000,
                         0xFF800000, 0x80000000], np.uint32)


def _touchy_floats(rng, shape, share=0.5):
    vals = rng.normal(size=shape).astype(np.float32)
    words = vals.view(np.uint32)
    pick = rng.random(shape) < share
    words[pick] = TOUCHY_WORDS[rng.integers(0, TOUCHY_WORDS.size, size=int(pick.sum()))]
    return vals


@pytest.mark.parametrize("fn", ["expand_intervals_torch", "expand_intervals"])
def test_expand_intervals_keeps_denormal_words(fn):
    """B6's plain version and its wrapper on float32 columns full of
    denormals (and NaN payloads, -0.0): every word copied bit for bit,
    against numpy on the words."""
    rng = np.random.default_rng(17)
    lengths = rng.integers(0, 9, size=3000)
    offsets = (np.cumsum(lengths) - lengths).astype(np.int32)
    ends = (offsets + lengths).astype(np.int32)
    cols = _touchy_floats(rng, (14, lengths.size))
    total = int(lengths.sum()) + 7
    got = getattr(pairmove, fn)(torch.from_numpy(offsets), torch.from_numpy(ends),
                                torch.from_numpy(cols), total)
    assert got.dtype == torch.float32
    slot = np.arange(total)
    owner = np.searchsorted(offsets, slot, side="right") - 1
    want = np.where(slot < ends[np.maximum(owner, 0)], cols.view(np.uint32)[:, owner], 0)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert np.isin(got.numpy().view(np.uint32), TOUCHY_WORDS[:8]).mean() > 0.1  # denormals


def test_carry_binning_keeps_denormal_words():
    """Attributes full of denormals, NaN payloads and -0.0 arrive in pair_attr
    word for word as the gather reads them."""
    inputs, _, budget, _ = bin_case(1.0)
    attr = _touchy_floats(np.random.default_rng(19), (N_BIN, 9))
    got = _bin(inputs, budget, carry_attr=torch.from_numpy(attr))
    attr_pad = np.concatenate([attr, np.zeros((1, 9), np.float32)])
    np.testing.assert_array_equal(got.pair_attr.numpy().view(np.uint32),
                                  attr_pad[got.pair_gauss.numpy()].view(np.uint32))
    assert np.isin(got.pair_attr.numpy().view(np.uint32), TOUCHY_WORDS).mean() > 0.2


# --- the rasterizer under "carry" ------------------------------------------------------------

RASTER_KW = dict(tile_w=16, tile_h=16, chunk=32)


@pytest.fixture(scope="module")
def carry_scene():
    """test_tiled.py:410-447's case at 160 Gaussians, 64x48, drawn with numpy,
    and gs_tpu's image and gradients with PAIR_SOURCE="carry" under
    GRAD_REDUCE="pallas" (interpret mode) on its XLA compositing backend."""
    sc = _numpy_scene(n=160, h=48, w=64, seed=21)
    target = np.random.default_rng(22).uniform(size=(3, 48, 64)).astype(np.float32)
    bg = np.array([0.3, 0.2, 0.1], np.float32)

    def run(*leaves):
        out = j_tiled.rasterize_tiled(*leaves, jnp.asarray(sc["depths"]),
                                      jnp.asarray(sc["radii"]), 48, 64, jnp.asarray(bg),
                                      JRasterizeConfig(backend="xla", **RASTER_KW))
        return jnp.mean((out.image - target) ** 2), out.image

    old = j_tiled.PAIR_SOURCE, j_tiled.GRAD_REDUCE
    j_tiled.PAIR_SOURCE, j_tiled.GRAD_REDUCE = "carry", "pallas"
    try:
        (_, img), grads = jax.value_and_grad(run, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(sc[k]) for k in LEAVES))
    finally:
        j_tiled.PAIR_SOURCE, j_tiled.GRAD_REDUCE = old
    return sc, target, bg, np.asarray(img), [np.asarray(g) for g in grads]


def _port_run(sc, target, bg, source, reduce):
    """The port's image and leaf gradients under (PAIR_SOURCE, GRAD_REDUCE)."""
    old = rasterize_tiled.PAIR_SOURCE, rasterize_tiled.GRAD_REDUCE
    rasterize_tiled.PAIR_SOURCE, rasterize_tiled.GRAD_REDUCE = source, reduce
    try:
        leaves = [torch.from_numpy(sc[k]).requires_grad_() for k in LEAVES]
        out = rasterize_tiled.rasterize_tiled(*leaves, torch.from_numpy(sc["depths"]),
                                              torch.from_numpy(sc["radii"]), 48, 64,
                                              torch.from_numpy(bg), RasterizeConfig(**RASTER_KW))
        ((out.image - torch.from_numpy(target)) ** 2).mean().backward()
    finally:
        rasterize_tiled.PAIR_SOURCE, rasterize_tiled.GRAD_REDUCE = old
    return out.image.detach().numpy(), [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("reduce", ["scatter", "cuda"])
def test_carry_image_and_grads(monkeypatch, carry_scene, reduce):
    """Under "carry" (whatever GRAD_REDUCE says): the image bitwise equal to
    the gather's; the gradients bitwise equal to the gather with "cuda", and
    within rtol 1e-5 + 1e-5 x max of gs_tpu's carry and the port's scatter
    gather. The backward goes through B5's wrapper once and B6's once."""
    sc, target, bg, j_img, j_grads = carry_scene
    img_g, grads_cuda = _port_run(sc, target, bg, "gather", "cuda")
    _, grads_scatter = _port_run(sc, target, bg, "gather", "scatter")
    calls = {"expand_intervals": 0, "segment_reduce_sorted": 0}
    for name in calls:
        def rec(*a, _orig=getattr(pairmove, name), _name=name):
            calls[_name] += 1
            return _orig(*a)
        monkeypatch.setattr(pairmove, name, rec)
    img, grads = _port_run(sc, target, bg, "carry", reduce)
    assert calls == {"expand_intervals": 1, "segment_reduce_sorted": 1}
    np.testing.assert_array_equal(img, img_g)
    np.testing.assert_allclose(img, j_img, atol=2e-5)
    for name, g, gc, gs, gj in zip(LEAVES, grads, grads_cuda, grads_scatter, j_grads):
        assert float(np.abs(gj).max()) > 0, name
        np.testing.assert_array_equal(g.view(np.uint32), gc.view(np.uint32), err_msg=name)
        for ref, tag in ((gj, "gs_tpu carry"), (gs, "port scatter")):
            scale = max(float(np.abs(ref).max()), 1e-3)
            np.testing.assert_allclose(g, ref, rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=f"{name} vs {tag}")


def test_carry_backward_skips_the_geometry():
    """BinCarryPairs gives the binning geometry no gradient (gs_tpu gives the
    int32 binning radii a float32 zero cotangent) and the attributes B5's sums."""
    sc = _numpy_scene(n=40, h=32, w=32, seed=9)
    attr = torch.from_numpy(np.random.default_rng(10).normal(size=(40, 9)).astype(np.float32))
    attr.requires_grad_()
    means2d = torch.from_numpy(sc["means2d"]).requires_grad_()
    depths = torch.from_numpy(sc["depths"]).requires_grad_()
    cs = rasterize_tiled.CarryStatic(2, 2, 16, 16, 1024, 8)
    sp_attr, ab = rasterize_tiled.bin_carry_pairs(cs, attr, means2d, depths,
                                                  torch.from_numpy(sc["radii"]))
    assert ab.pair_attr is None and ab.gauss_counts is not None
    cot = torch.from_numpy(np.random.default_rng(11).normal(size=tuple(sp_attr.shape))
                           .astype(np.float32))
    (sp_attr * cot).sum().backward()
    assert means2d.grad is None and depths.grad is None
    ref = torch.zeros(41, 9, dtype=torch.float64)
    ref.index_add_(0, ab.pair_gauss.long(), cot.double())
    np.testing.assert_allclose(attr.grad.numpy(), ref[:40].numpy(), rtol=1e-6, atol=1e-6)


def test_unknown_pair_source_raises(monkeypatch):
    monkeypatch.setattr(rasterize_tiled, "PAIR_SOURCE", "gathered")
    sc = _numpy_scene(n=8, h=16, w=16)
    with pytest.raises(ValueError, match="PAIR_SOURCE"):
        rasterize_tiled.rasterize_tiled(*(torch.from_numpy(sc[k]) for k in (
            *LEAVES, "depths", "radii")), 16, 16, torch.zeros(3), RasterizeConfig())


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_carry_matches_oracle(monkeypatch, backend):
    """test_tiled.py:449-466: carry at 48x48 with 96 Gaussians, chunk 8,
    16x16 tiles, against gs_tpu's oracle (atol, rtol 1e-3), and bitwise
    equal to the port's gather on the same backend."""
    sc = _numpy_scene(n=96, h=48, w=48, seed=23)
    bg = np.array([0.1, 0.5, 0.9], np.float32)
    want = np.asarray(j_oracle(*(jnp.asarray(sc[k]) for k in (*LEAVES, "depths", "radii")),
                               48, 48, jnp.asarray(bg)).image)
    cfg = RasterizeConfig(backend=backend, chunk=8, tile_w=16, tile_h=16, pair_budget_factor=6.0)
    args = [torch.from_numpy(sc[k]) for k in (*LEAVES, "depths", "radii")]
    gather = rasterize_tiled.rasterize_tiled(*args, 48, 48, torch.from_numpy(bg), cfg).image
    monkeypatch.setattr(rasterize_tiled, "PAIR_SOURCE", "carry")
    got = rasterize_tiled.rasterize_tiled(*args, 48, 48, torch.from_numpy(bg), cfg).image
    assert torch.equal(got, gather)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)


# --- the slice: one train_step under "carry" -------------------------------------------------


def test_train_step_with_carry_matches_gs_tpu(monkeypatch):
    """One train_step (render, L1 + SSIM, backward, Adam, densify stats) at
    48x48 with 64 Gaussians, chunk 8, 16x16 tiles, PAIR_SOURCE="carry" in
    both packages (gs_tpu's under GRAD_REDUCE="pallas", its kernels in
    interpret mode). The pair_budget_factor is this test's own, so gs_tpu's
    jitted step is traced here with its switches on."""
    monkeypatch.setattr(j_tiled, "PAIR_SOURCE", "carry")
    monkeypatch.setattr(j_tiled, "GRAD_REDUCE", "pallas")
    monkeypatch.setattr(rasterize_tiled, "PAIR_SOURCE", "carry")
    seen = {"expand": 0, "reduce": 0, "j_expand": 0, "j_reduce": 0}
    for mod, name, key in ((pairmove, "expand_intervals", "expand"),
                           (pairmove, "segment_reduce_sorted", "reduce"),
                           (j_pairmove, "expand_intervals", "j_expand"),
                           (j_pairmove, "segment_reduce_packed", "j_reduce")):
        def rec(*a, _orig=getattr(mod, name), _key=key, **k):
            seen[_key] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, rec)

    arr = scene_arrays(n=64, sh_degree=3, seed=51, dead=4)
    arr["log_scale"] = np.random.default_rng(53).uniform(-3.0, -1.5, (64, 3)).astype(np.float32)
    args = camera_args(48, 48)
    args["T"] = np.array([0.1, 0.2, 3.0])
    jcam = j_cameras.make_camera(**args)
    target = dict(arr, xyz=arr["xyz"] + np.random.default_rng(52).normal(
        0, 0.05, arr["xyz"].shape).astype(np.float32))
    kw = dict(chunk=8, tile_w=16, tile_h=16, pair_budget_factor=7.75)
    img = np.asarray(j_training.eval_render(jax_state(target), jcam, jnp.zeros(3),
                                            active_sh_degree=0,
                                            raster_cfg=JRasterizeConfig(backend="xla", **kw)))
    jcam = jcam.replace(image=jnp.asarray(img))
    opt = dict(iterations=100, position_lr_max_steps=100)
    jstate, jadam, _, jm = j_training.train_step(
        jax_state(arr), j_optim.init(jax_state(arr).params()), j_densify.DensifyStats.zeros(64),
        jcam, jnp.zeros(3), jnp.int32(0), jnp.float32(1.5), active_sh_degree=0,
        opt_cfg=JOptimizationParams(**opt), raster_cfg=JRasterizeConfig(backend="xla", **kw),
        accumulate_stats=True, pipe=JPipelineParams(), apply_update=True)
    ts = training.init_train_state(interop.state_from_numpy(arr, "cpu"), 1.5, 0)
    cam = interop.camera_from_numpy(dict(camera_dict(jcam), image=img), "cpu")
    state, adam, stats, m = training.train_step(
        ts.state, ts.adam, ts.stats, cam, torch.zeros(3), 0, 1.5, active_sh_degree=0,
        opt_cfg=OptimizationParams(**opt), raster_cfg=RasterizeConfig(**kw),
        accumulate_stats=True)
    # the port carried through B6 and reduced through B5 once each
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
def test_cuda_carry_matches_gather(cuda_device):
    """On the card, carry_scene's case: the carry image bitwise equal to the
    gather's, the gradients bitwise equal to the gather with "cuda", one B6
    and one B5 launch beside B1 and B2."""
    sc = _numpy_scene(n=160, h=48, w=64, seed=21)
    target = torch.from_numpy(np.random.default_rng(22).uniform(size=(3, 48, 64))
                              .astype(np.float32)).to(cuda_device)
    bg = torch.tensor([0.3, 0.2, 0.1], device=cuda_device)

    def run(source, reduce):
        old = rasterize_tiled.PAIR_SOURCE, rasterize_tiled.GRAD_REDUCE
        rasterize_tiled.PAIR_SOURCE, rasterize_tiled.GRAD_REDUCE = source, reduce
        try:
            leaves = [torch.from_numpy(sc[k]).to(cuda_device).requires_grad_() for k in LEAVES]
            out = rasterize_tiled.rasterize_tiled(
                *leaves, *(torch.from_numpy(sc[k]).to(cuda_device) for k in ("depths", "radii")),
                48, 64, bg, RasterizeConfig(**RASTER_KW))
            ((out.image - target) ** 2).mean().backward()
        finally:
            rasterize_tiled.PAIR_SOURCE, rasterize_tiled.GRAD_REDUCE = old
        return out.image.detach(), [leaf.grad for leaf in leaves]

    img_g, grads_g = run("gather", "cuda")
    before = dict(cuda_build.LAUNCHES)
    img, grads = run("carry", "scatter")
    torch.cuda.synchronize()
    added = {k: cuda_build.LAUNCHES[k] - before[k] for k in before}
    assert added == {**{k: 0 for k in before}, "composite_fwd": 1, "composite_bwd": 1,
                     "segment_reduce": 1, "expand_intervals": 1}
    assert torch.equal(img, img_g)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_g))
