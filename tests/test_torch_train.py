"""gs_tpu_torch's training slice against gs_tpu's, on the CPU.

The same numpy inputs, made from seeds, go through gs_tpu under JAX and
through the port's plain versions:

- the compositing backward (B2): ``composite_bwd_torch`` against
  ``_composite_bwd_xla`` (through ``jax.vjp`` of ``composite_tiles``) and
  the Pallas kernel ``composite_bwd_pallas`` in interpret mode, per column
  to rtol 1e-4, atol 1e-5 x max|want| (gs_tpu's own pallas-vs-xla bound,
  tests/test_pallas.py:55);
- ``rasterize_tiled``'s gradients against the float64 golden bundle at
  tests/test_golden.py's rtol 2e-3, atol 2e-5 x max(scale, 1);
- ``render``'s gradients for the six groups and ``means2d_offset`` against
  ``jax.grad`` of gs_tpu's render, per group to rtol 1e-3, atol 1e-4 x
  max|want|;
- losses, lr schedule, PSNR, Adam and its surgery, densify (fed gs_tpu's
  split draw), one ``train_step`` and a 10-iteration ``run_training``.

The backward kernel against its plain version on the card is marked ``cuda``.
"""

import math

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
from gs_tpu.renderer import render as j_render
from gs_tpu.utils import losses as j_losses
from gs_tpu.utils import metrics as j_metrics
from gs_tpu.utils import schedules as j_schedules
from gs_tpu_torch import interop, training
from gs_tpu_torch.config import OptimizationParams, PipelineParams, RasterizeConfig
from gs_tpu_torch.models import densify, optim
from gs_tpu_torch.ops import rasterize_cuda, rasterize_tiled
from gs_tpu_torch.renderer import render
from gs_tpu_torch.utils import losses, metrics, schedules
from tests.test_torch_raster import CHUNK, INPUTS, _port_static, _t, g, pairs  # noqa: F401
from tests.torch_port_inputs import camera_args, camera_dict, jax_state, scene_arrays

GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


def _close_per_column(got, want, rtol, atol_frac, name=""):
    """Each column (last axis) to rtol and atol_frac x its max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    for c in range(want.shape[-1]):
        scale = float(np.abs(want[..., c]).max())
        np.testing.assert_allclose(got[..., c], want[..., c], rtol=rtol,
                                   atol=atol_frac * scale, err_msg=f"{name} column {c}")


def _close_group(got, want, rtol, atol_frac, name=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * float(np.abs(want).max()),
                               err_msg=name)


# --- B2: the compositing backward ------------------------------------------------------


def _cotangents(p, seed=0):
    m, px = p["tile_ids"].shape[0], p["st"].tile_w * p["st"].tile_h
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, px, 3)).astype(np.float32),
            rng.normal(size=(m, px)).astype(np.float32))


def _jax_vjp(p, ends_key, g_color, g_t):
    """gs_tpu's forward outputs and its XLA backward's d_attr."""
    st = p["st"]
    (_, t_final, ncon), vjp = jax.vjp(
        lambda a: j_tiled.composite_tiles(st, a, p["tile_ids"], p["starts"], p[ends_key]),
        p["sp_attr"])
    (d_attr,) = vjp((jnp.asarray(g_color), jnp.asarray(g_t),
                     np.zeros(ncon.shape, jax.dtypes.float0)))
    return t_final, ncon, d_attr


def _port_bwd(p, ends_key, t_final, ncon, g_color, g_t, fn=None):
    st = _port_static(p["st"])
    starts, t_final, ncon = _t(p["starts"]), _t(t_final), _t(ncon)
    ends = rasterize_tiled.ncon_trimmed_ends(st, starts, _t(p[ends_key]), ncon)
    fn = fn or rasterize_cuda.composite_bwd_torch
    return fn(st, _t(p["sp_attr"]), _t(p["tile_ids"]), starts, ends, t_final, ncon,
              _t(g_color), _t(g_t) * t_final)


@pytest.mark.parametrize("ends_key", ["ends", "ends_eff"])
def test_composite_bwd_torch_matches_xla(pairs, ends_key):
    g_color, g_t = _cotangents(pairs)
    t_final, ncon, want = _jax_vjp(pairs, ends_key, g_color, g_t)
    got = _port_bwd(pairs, ends_key, t_final, ncon, g_color, g_t)
    _close_per_column(got.numpy(), want, 1e-4, 1e-5, "d_attr")
    assert float(np.abs(np.asarray(want)).max()) > 0


def test_composite_bwd_torch_matches_pallas(pairs):
    p = pairs
    assert j_pallas._interpret()  # the Pallas kernel runs in interpret mode here
    g_color, g_t = _cotangents(p, seed=1)
    t_final, ncon, _ = _jax_vjp(p, "ends_eff", g_color, g_t)
    ends = j_tiled.ncon_trimmed_ends(p["st"], p["starts"], p["ends_eff"], ncon)
    want = j_pallas.composite_bwd_pallas(
        p["st"], (p["sp_attr"], p["tile_ids"], p["starts"], ends, t_final, ncon),
        (jnp.asarray(g_color), jnp.asarray(g_t), None))[0]
    got = _port_bwd(p, "ends_eff", t_final, ncon, g_color, g_t)
    _close_per_column(got.numpy(), want, 1e-4, 1e-5, "d_attr")


@pytest.mark.parametrize("ends_key", ["ends", "ends_eff"])
def test_ncon_trimmed_ends_matches(pairs, ends_key):
    p = pairs
    _, ncon, _ = _jax_vjp(p, ends_key, *_cotangents(p))
    want = j_tiled.ncon_trimmed_ends(p["st"], p["starts"], p[ends_key], ncon)
    got = rasterize_tiled.ncon_trimmed_ends(_port_static(p["st"]), _t(p["starts"]),
                                            _t(p[ends_key]), _t(ncon))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got < _t(p[ends_key])).any()  # the trim does cut tails


@pytest.mark.parametrize("with_t", [True, False])
def test_composite_tiles_autograd_matches_xla(pairs, with_t):
    """The port's autograd Function end to end: forward, trimmed backward.
    Without a T cotangent the backward takes zeros, as gs_tpu does."""
    p = pairs
    g_color, g_t = _cotangents(p, seed=2)
    if not with_t:
        g_t = np.zeros_like(g_t)
    _, _, want = _jax_vjp(p, "ends_eff", g_color, g_t)
    sp_attr = _t(p["sp_attr"]).requires_grad_()
    color, t_final, _ = rasterize_tiled.composite_tiles(
        _port_static(p["st"]), sp_attr, _t(p["tile_ids"]), _t(p["starts"]), _t(p["ends_eff"]))
    loss = (color * _t(g_color)).sum() + ((t_final * _t(g_t)).sum() if with_t else 0.0)
    loss.backward()
    _close_per_column(sp_attr.grad.numpy(), want, 1e-4, 1e-5, "d_attr")


def test_composite_bwd_rows_outside_ranges_are_zero(pairs):
    p = pairs
    g_color, g_t = _cotangents(p)
    t_final, ncon, _ = _jax_vjp(p, "ends_eff", g_color, g_t)
    got = _port_bwd(p, "ends_eff", t_final, ncon, g_color, g_t)
    st = _port_static(p["st"])
    trimmed = rasterize_tiled.ncon_trimmed_ends(st, _t(p["starts"]), _t(p["ends_eff"]),
                                                _t(ncon))
    covered = torch.zeros(got.shape[0], dtype=torch.bool)
    for s0, e0 in zip(_t(p["starts"]).tolist(), trimmed.tolist()):
        covered[s0:e0] = True
    assert (~covered).any() and (got[~covered] == 0).all()
    assert (got[covered] != 0).any()


def test_cuda_bwd_wrapper_on_cpu_runs_plain_version(pairs):
    g_color, g_t = _cotangents(pairs)
    t_final, ncon, _ = _jax_vjp(pairs, "ends_eff", g_color, g_t)
    before = rasterize_cuda.LAUNCHES["composite_bwd"]
    got = _port_bwd(pairs, "ends_eff", t_final, ncon, g_color, g_t,
                    fn=rasterize_cuda.composite_bwd_cuda)
    ref = _port_bwd(pairs, "ends_eff", t_final, ncon, g_color, g_t)
    assert torch.equal(got, ref)
    assert rasterize_cuda.LAUNCHES["composite_bwd"] == before  # no kernel launched


@pytest.mark.parametrize("tile_batch", [1, 5])
def test_composite_bwd_tile_batching_is_invisible(pairs, tile_batch):
    g_color, g_t = _cotangents(pairs)
    t_final, ncon, _ = _jax_vjp(pairs, "ends_eff", g_color, g_t)
    ref = _port_bwd(pairs, "ends_eff", t_final, ncon, g_color, g_t)
    st = _port_static(pairs["st"])._replace(tile_batch=tile_batch)
    got = _port_bwd(pairs, "ends_eff", t_final, ncon, g_color, g_t,
                    fn=lambda _, *a: rasterize_cuda.composite_bwd_torch(st, *a))
    assert torch.equal(got, ref)


def test_composite_bwd_inputs_are_checked(pairs):
    p = pairs
    st = _port_static(p["st"])
    m, px = p["tile_ids"].shape[0], st.tile_w * st.tile_h
    args = [_t(p["sp_attr"]), _t(p["tile_ids"]), _t(p["starts"]), _t(p["ends"]),
            torch.ones(m, px), torch.zeros(m, px, dtype=torch.int32), torch.zeros(m, px, 3),
            torch.zeros(m, px)]
    with pytest.raises(ValueError, match="ncon"):
        rasterize_cuda.composite_bwd_cuda(st, *args[:5], args[5].long(), *args[6:])
    with pytest.raises(ValueError, match="g_color"):
        rasterize_cuda.composite_bwd_cuda(st, *args[:6], args[6][..., :2], args[7])


# --- golden gradients -----------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "auto"])
@pytest.mark.parametrize("truncate", [True, False])
def test_rasterize_tiled_gradients_match_golden(g, backend, truncate):
    h, w = int(g["height"]), int(g["width"])
    cfg = RasterizeConfig(backend=backend, chunk=CHUNK, min_pair_budget=1 << 13,
                          truncate_tiles=truncate)
    leaves = [torch.from_numpy(g[k]).requires_grad_() for k in INPUTS[:4]]
    out = rasterize_tiled.rasterize_tiled(*leaves, *(torch.from_numpy(g[k]) for k in INPUTS[4:]),
                                          h, w, torch.from_numpy(g["bg"]), cfg)
    loss = (out.image * torch.from_numpy(g["g_img"])).sum() \
        + (out.final_t * torch.from_numpy(g["g_t"])).sum()
    loss.backward()
    for leaf, key in zip(leaves, ("d_means2d", "d_conics", "d_colors", "d_opacities")):
        want = g[key]
        np.testing.assert_allclose(leaf.grad.double().numpy(), want, rtol=2e-3,
                                   atol=2e-5 * max(float(np.abs(want).max()), 1.0), err_msg=key)


# --- render gradients -----------------------------------------------------------------


@pytest.fixture(scope="module")
def grad_scene():
    arr = scene_arrays(n=2048, sh_degree=3, seed=5)
    jcam = j_cameras.make_camera(**camera_args(61, 47))
    rng = np.random.default_rng(6)
    return dict(arr=arr, jstate=jax_state(arr), jcam=jcam,
                state=interop.state_from_numpy(arr, "cpu"),
                cam=interop.camera_from_numpy(camera_dict(jcam), "cpu"),
                g_img=rng.normal(size=(3, 47, 61)).astype(np.float32),
                g_t=rng.normal(size=(47, 61)).astype(np.float32),
                bg=np.array([0.3, 0.2, 0.1], np.float32))


@pytest.mark.parametrize("deg", [0, 3])
def test_render_gradients_match_jax(grad_scene, deg):
    sc = grad_scene
    cap = sc["arr"]["xyz"].shape[0]

    def j_loss(params, offset):
        out = j_render(sc["jcam"], sc["jstate"].with_params(params), active_sh_degree=deg,
                       bg_color=jnp.asarray(sc["bg"]), means2d_offset=offset,
                       cfg=JRasterizeConfig(backend="xla"))
        return jnp.sum(out.image * sc["g_img"]) + jnp.sum(out.final_t * sc["g_t"])

    want_p, want_o = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(
        sc["jstate"].params(), jnp.zeros((cap, 2), jnp.float32))

    params = {k: v.clone().requires_grad_() for k, v in sc["state"].params().items()}
    offset = torch.zeros((cap, 2), requires_grad=True)
    out = render(sc["cam"], sc["state"].with_params(params), active_sh_degree=deg,
                 bg_color=sc["bg"], means2d_offset=offset)
    loss = (out.image * torch.from_numpy(sc["g_img"])).sum() \
        + (out.final_t * torch.from_numpy(sc["g_t"])).sum()
    got = torch.autograd.grad(loss, [*params.values(), offset], allow_unused=True,
                              materialize_grads=True)
    for name, got_g in zip([*params, "means2d_offset"], got):
        want_g = want_o if name == "means2d_offset" else want_p[name]
        assert float(jnp.abs(want_g).max()) > 0 or (name == "f_rest" and deg == 0), name
        _close_group(got_g.numpy(), want_g, 1e-3, 1e-4, name)


# --- losses, schedules, metrics -------------------------------------------------------


@pytest.mark.parametrize("which", ["l1", "ssim", "photometric"])
def test_loss_value_and_gradient_match(which):
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (3, 37, 45)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    jfn = {"l1": j_losses.l1_loss, "ssim": j_losses.ssim,
           "photometric": lambda x, y: j_losses.photometric_loss(x, y, 0.2)}[which]
    fn = {"l1": losses.l1_loss, "ssim": losses.ssim,
          "photometric": lambda x, y: losses.photometric_loss(x, y, 0.2)}[which]
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(a), jnp.asarray(b))
    x = torch.from_numpy(a).requires_grad_()
    got = fn(x, torch.from_numpy(b))
    (got_g,) = torch.autograd.grad(got, [x])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    _close_group(got_g.numpy(), want_g, 1e-5, 1e-5, "image gradient")


def test_ssim_of_identical_images_is_one():
    a = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (3, 20, 24)).astype(np.float32))
    assert abs(float(losses.ssim(a, a)) - 1.0) < 1e-6


@pytest.mark.parametrize("delay_steps", [0, 50])
def test_expon_lr_matches(delay_steps):
    kw = dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_steps=delay_steps, lr_delay_mult=0.01,
              max_steps=300)
    for step in (-1, 0, 1, 7, 150, 299, 300, 1000):
        want = float(j_schedules.expon_lr(step, **kw))
        got = float(schedules.expon_lr(step, **kw))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f"step {step}")
    opt = OptimizationParams()
    np.testing.assert_allclose(float(schedules.xyz_lr(10, opt, 2.5)),
                               float(j_schedules.xyz_lr(10, JOptimizationParams(), 2.5)), rtol=1e-6)
    assert float(schedules.expon_lr(5, 0.0, 0.0)) == 0.0


def test_psnr_matches():
    rng = np.random.default_rng(8)
    a = rng.uniform(0, 1, (2, 3, 9, 11)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    for x, y in ((a, b), (a[0], b[0])):
        want = np.asarray(j_metrics.psnr(jnp.asarray(x), jnp.asarray(y)))
        got = metrics.psnr(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6)


# --- Adam ---------------------------------------------------------------------------


def _param_arrays(cap=24, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"xyz": (cap, 3), "f_dc": (cap, 1, 3), "f_rest": (cap, 15, 3),
              "opacity": (cap, 1), "scaling": (cap, 3), "rotation": (cap, 4)}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def _assert_adam_close(got: optim.AdamState, want, rtol=1e-7):
    for k in GROUPS:
        np.testing.assert_allclose(got.mu[k].numpy(), np.asarray(want.mu[k]), rtol=rtol, atol=0)
        np.testing.assert_allclose(got.nu[k].numpy(), np.asarray(want.nu[k]), rtol=rtol, atol=0)
        assert got.step[k] == int(want.step[k])


def test_adam_update_matches():
    """Three steps, each from the same parameters and moments in both."""
    params = _param_arrays()
    rng = np.random.default_rng(1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = j_optim.init(jp)
    opt, jopt = OptimizationParams(), JOptimizationParams()
    for step in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) * 10.0 ** -step
                 for k, v in params.items()}
        xyz_lr = 1.6e-4 * (step + 1)
        tp = {k: _t(v) for k, v in jp.items()}
        tst = interop.adam_from_numpy(*({k: np.asarray(v) for k, v in tree.items()}
                                        for tree in jst), "cpu")
        tp, tst = optim.update(tp, {k: torch.from_numpy(v) for k, v in grads.items()}, tst,
                               optim.group_lrs(opt, xyz_lr))
        jp_old = jp
        jp, jst = j_optim.update(jp, {k: jnp.asarray(v) for k, v in grads.items()}, jst,
                                 j_optim.group_lrs(jopt, jnp.float32(xyz_lr)))
        for k in GROUPS:
            # XLA's CPU expm1 gives 1 - 0.9 as 0.099999994 where torch's (and
            # the float64 scalars of torch.optim.Adam) give 0.1, so lr / bc1
            # can differ by one float32 ulp: allow two ulps of the step taken
            step_size = float(np.abs(np.asarray(jp[k]) - np.asarray(jp_old[k])).max())
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-7,
                                       atol=2 * float(np.finfo(np.float32).eps) * step_size,
                                       err_msg=f"{k} step {step}")
        _assert_adam_close(tst, jst)


def test_adam_surgery_matches():
    params = _param_arrays(seed=2)
    grads = _param_arrays(seed=3)
    jst = j_optim.update({k: jnp.asarray(v) for k, v in params.items()},
                         {k: jnp.asarray(v) for k, v in grads.items()},
                         j_optim.init({k: jnp.asarray(v) for k, v in params.items()}),
                         j_optim.group_lrs(JOptimizationParams(), 1e-4))[1]
    tst = interop.adam_from_numpy(*({k: np.asarray(v) for k, v in tree.items()} for tree in jst),
                                  "cpu")
    keep = np.random.default_rng(4).uniform(size=24) < 0.5
    _assert_adam_close(optim.mask_slots(tst, torch.from_numpy(keep)),
                       j_optim.mask_slots(jst, jnp.asarray(keep)), rtol=0)
    _assert_adam_close(optim.reset_group(tst, "opacity"), j_optim.reset_group(jst, "opacity"),
                       rtol=0)
    grown, jgrown = optim.grow(tst, 40), j_optim.grow(jst, 40)
    assert grown.mu["xyz"].shape == (40, 3)
    _assert_adam_close(grown, jgrown, rtol=0)
    for k, v in optim.group_lrs(OptimizationParams(), 3e-5).items():
        assert v.dtype == torch.float32
        assert float(v) == float(j_optim.group_lrs(JOptimizationParams(), 3e-5)[k])


# --- densify ------------------------------------------------------------------------


def test_add_stats_matches():
    rng = np.random.default_rng(9)
    cap = 64
    stats = [rng.uniform(0, 1, cap).astype(np.float32) for _ in range(3)]
    grad = rng.normal(0, 1e-3, (cap, 2)).astype(np.float32)
    radii = rng.integers(0, 9, cap).astype(np.int32)
    want = j_densify.add_stats(j_densify.DensifyStats(*map(jnp.asarray, stats)),
                               jnp.asarray(grad), jnp.asarray(radii), jnp.asarray(radii > 0),
                               61, 47)
    got = densify.add_stats(interop.stats_from_numpy(*stats, "cpu"), torch.from_numpy(grad),
                            torch.from_numpy(radii), torch.from_numpy(radii > 0), 61, 47)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def _densify_inputs(cap, n_alive, seed, hot_share=0.4):
    """A state of ``cap`` slots, ``n_alive`` alive, whose grads, scales and
    opacities make some Gaussians clone, some split and some prune."""
    rng = np.random.default_rng(seed)
    arr = scene_arrays(n=cap, sh_degree=1, seed=seed, dead=cap - n_alive)
    arr["log_scale"] = rng.uniform(math.log(0.004), math.log(0.4), (cap, 3)).astype(np.float32)
    arr["logit_opacity"] = rng.uniform(-7, 3, (cap, 1)).astype(np.float32)
    hot = rng.uniform(size=cap) < hot_share
    accum = np.where(hot, rng.uniform(3e-4, 1e-2, cap), rng.uniform(0, 1e-4, cap))
    denom = rng.integers(0, 4, cap).astype(np.float32)
    stats = [(accum * denom).astype(np.float32), denom,
             rng.uniform(0, 20, cap).astype(np.float32)]
    params = _param_arrays(cap, seed)
    adam = [params, {k: np.abs(v) for k, v in _param_arrays(cap, seed + 1).items()},
            {k: 3 for k in GROUPS}]
    return arr, stats, adam


def _split_draw(cap, seed):
    """gs_tpu's split-child noise for slots 0..cap-1 (densify.py:176-182)."""
    key = jax.random.PRNGKey(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(cap, dtype=jnp.int32))
    eps = jax.vmap(lambda k: jax.random.normal(k, (2, 3), jnp.float32))(keys)
    return key, np.asarray(jnp.swapaxes(eps, 0, 1))


@pytest.mark.parametrize("case", ["roomy", "tight", "size_prune"])
def test_densify_and_prune_matches(case):
    cap, n_alive = {"roomy": (96, 40), "tight": (64, 64), "size_prune": (96, 40)}[case]
    use_size_prune = case == "size_prune"
    arr, stats, adam = _densify_inputs(cap, n_alive, seed=11,
                                       hot_share=0.9 if case == "tight" else 0.4)
    kw = dict(max_grad=2e-4, min_opacity=0.005, extent=2.0, percent_dense=0.05,
              use_size_prune=use_size_prune)
    key, noise = _split_draw(cap, 12)
    jstate = jax_state(arr)
    jadam = j_optim.AdamState(*({k: jnp.asarray(v) for k, v in t.items()} for t in adam))
    jnew, jadam2, jstats, jrep = j_densify.densify_and_prune(
        jstate, jadam, j_densify.DensifyStats(*map(jnp.asarray, stats)), key,
        **{**kw, "extent": jnp.float32(2.0)})
    new, adam2, new_stats, rep = densify.densify_and_prune(
        interop.state_from_numpy(arr, "cpu"), interop.adam_from_numpy(*adam, "cpu"),
        interop.stats_from_numpy(*stats, "cpu"), torch.from_numpy(noise), **kw)

    for field in rep._fields:
        assert int(getattr(rep, field)) == int(getattr(jrep, field)), field
    assert int(rep.n_cloned) > 0 and int(rep.n_split) > 0 and int(rep.n_pruned) > 0
    assert (int(rep.n_dropped) > 0) == (case == "tight")
    np.testing.assert_array_equal(new.alive.numpy(), np.asarray(jnew.alive))
    for k, v in new.params().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jnew.params()[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    for k in GROUPS:
        np.testing.assert_allclose(adam2.mu[k].numpy(), np.asarray(jadam2.mu[k]), rtol=1e-6)
        np.testing.assert_allclose(adam2.nu[k].numpy(), np.asarray(jadam2.nu[k]), rtol=1e-6)
    assert all(float(s.abs().sum()) == 0.0 for s in new_stats)


def test_split_noise_is_seeded():
    a = densify.split_noise(torch.Generator().manual_seed(3), 10, "cpu")
    b = densify.split_noise(torch.Generator().manual_seed(3), 10, "cpu")
    assert a.shape == (2, 10, 3) and torch.equal(a, b)


def test_reset_opacity_matches():
    arr, _, adam = _densify_inputs(48, 40, seed=13)
    jadam = j_optim.AdamState(*({k: jnp.asarray(v) for k, v in t.items()} for t in adam))
    jst, jad = j_densify.reset_opacity(jax_state(arr), jadam)
    st, ad = densify.reset_opacity(interop.state_from_numpy(arr, "cpu"),
                                   interop.adam_from_numpy(*adam, "cpu"))
    np.testing.assert_allclose(st.logit_opacity.numpy(), np.asarray(jst.logit_opacity),
                               rtol=1e-6, atol=1e-6)
    _assert_adam_close(ad, jad, rtol=0)


# --- train_step and run_training ------------------------------------------------------

TRAIN_OPT = dict(iterations=10, densify_from_iter=1000, densify_until_iter=1000,
                 opacity_reset_interval=1000, position_lr_max_steps=10)
TRAIN_W, TRAIN_H = 40, 32


@pytest.fixture(scope="module")
def train_scene():
    """512 Gaussians and three cameras whose images are renders of a
    perturbed copy of the scene."""
    arr = scene_arrays(n=512, sh_degree=3, seed=21, dead=8)
    target = dict(arr, xyz=arr["xyz"] + np.random.default_rng(22).normal(
        0, 0.05, arr["xyz"].shape).astype(np.float32))
    jcams, cams = [], []
    for i, x in enumerate((0.0, 0.4, -0.3)):
        args = camera_args(TRAIN_W, TRAIN_H)
        args["T"] = np.array([x, 0.1 * i, 5.0])
        jcam = j_cameras.make_camera(**args)
        img = np.asarray(j_training.eval_render(
            jax_state(target), jcam, jnp.zeros(3), active_sh_degree=0,
            raster_cfg=JRasterizeConfig(backend="xla")))
        jcams.append(jcam.replace(image=jnp.asarray(img)))
        cams.append(interop.camera_from_numpy(dict(camera_dict(jcam), image=img), "cpu"))
    return dict(arr=arr, jcams=jcams, cams=cams)


def _train_step_pair(sc):
    j_out = j_training.train_step(
        jax_state(sc["arr"]), j_optim.init(jax_state(sc["arr"]).params()),
        j_densify.DensifyStats.zeros(512), sc["jcams"][1], jnp.zeros(3), jnp.int32(0),
        jnp.float32(1.5), active_sh_degree=0, opt_cfg=JOptimizationParams(**TRAIN_OPT),
        raster_cfg=JRasterizeConfig(backend="xla"), accumulate_stats=True,
        pipe=JPipelineParams(), apply_update=True)
    ts = training.init_train_state(interop.state_from_numpy(sc["arr"], "cpu"), 1.5, 3)
    out = training.train_step(
        ts.state, ts.adam, ts.stats, sc["cams"][1], torch.zeros(3), 0, 1.5,
        active_sh_degree=0, opt_cfg=OptimizationParams(**TRAIN_OPT),
        raster_cfg=RasterizeConfig(), accumulate_stats=True)
    return out, j_out


def test_train_step_matches(train_scene):
    (state, adam, stats, m), (jstate, jadam, jstats, jm) = _train_step_pair(train_scene)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert int(m["num_pairs"]) == int(jm["num_pairs"])
    assert int(m["n_visible"]) == int(jm["n_visible"])
    np.testing.assert_allclose(float(m["xyz_lr"]), float(jm["xyz_lr"]), rtol=1e-6)
    for k in GROUPS:
        # first moments are 0.1 x the gradient: the render-gradient tolerance
        g_got, g_want = adam.mu[k].numpy(), np.asarray(jadam.mu[k])
        _close_group(g_got, g_want, 1e-3, 1e-4, f"mu {k}")
        _close_group(adam.nu[k].numpy(), np.asarray(jadam.nu[k]), 2e-3, 1e-4, f"nu {k}")
        assert adam.step[k] == int(jadam.step[k]) == 1
        # Adam's first step moves each entry by lr x sign(gradient): equal
        # wherever the signs agree; a sign may differ only where the
        # gradient is below the gradient tolerance
        p_got, p_want = state.params()[k].numpy(), np.asarray(jstate.params()[k])
        same = np.sign(g_got) == np.sign(g_want)
        np.testing.assert_allclose(p_got[same], p_want[same], rtol=1e-6, atol=1e-7, err_msg=k)
        assert (np.abs(g_want[~same]) <= 1e-4 * np.abs(g_want).max()).all(), k
    np.testing.assert_array_equal(state.alive.numpy(), np.asarray(jstate.alive))
    for name, a, b in zip(stats._fields, stats, jstats):
        _close_group(a.numpy(), np.asarray(b), 1e-3, 1e-4, name)


def test_train_step_without_update_keeps_params(train_scene):
    sc = train_scene
    ts = training.init_train_state(interop.state_from_numpy(sc["arr"], "cpu"), 1.5, 3)
    state, adam, stats, m = training.train_step(
        ts.state, ts.adam, ts.stats, sc["cams"][0], torch.zeros(3), 9, 1.5,
        active_sh_degree=1, opt_cfg=OptimizationParams(**TRAIN_OPT),
        raster_cfg=RasterizeConfig(), accumulate_stats=False, apply_update=False)
    assert state is ts.state and adam is ts.adam and stats is ts.stats
    assert np.isfinite(float(m["loss"]))


class _Scene:
    cameras_extent = 1.5
    model_path = ""

    def __init__(self, gaussians, cams):
        self.gaussians, self._cams = gaussians, cams

    def get_train_cameras(self):
        return self._cams

    def get_test_cameras(self):
        return []

    def save(self, iteration, state=None):
        pass


def test_run_training_loss_trajectory_matches(train_scene):
    """10 iterations, densify off: the same camera order by construction,
    the same losses step by step."""
    sc = train_scene
    want, got = [], []
    j_training.run_training(
        _Scene(jax_state(sc["arr"]), sc["jcams"]), JOptimizationParams(**TRAIN_OPT),
        JPipelineParams(), raster_cfg=JRasterizeConfig(backend="xla"), test_iterations=(),
        save_iterations=(), log_every=1, progress=lambda it, m: want.append(m["loss"]))
    ts = training.run_training(
        _Scene(interop.state_from_numpy(sc["arr"], "cpu"), sc["cams"]),
        OptimizationParams(**TRAIN_OPT), PipelineParams(), test_iterations=(),
        save_iterations=(), log_every=1, progress=lambda it, m: got.append(m["loss"]))
    assert len(got) == len(want) == 10
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    assert ts.iteration == 10 and all(s == 9 for s in ts.adam.step.values())


# --- on the card -----------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(16, 16), (48, 32)])
def test_cuda_bwd_kernel_matches_plain(g, cuda_device, tile):
    """B2 against its plain version on the card, on the golden splats binned
    and composited by the port: per column to rtol 1e-4, atol 1e-5 x max."""
    tw, th = tile
    h, w = int(g["height"]), int(g["width"])
    ins = [torch.from_numpy(g[k]).to(cuda_device) for k in INPUTS]
    tiles_x, tiles_y = -(-w // tw), -(-h // th)
    ab = rasterize_tiled.binning.bin_gaussians_aligned(
        ins[0], ins[4], rasterize_tiled.bin_radii(ins[5], ins[3]), tiles_x, tiles_y, tw, th,
        8192, CHUNK)
    sp_attr = rasterize_tiled.pack_attributes(*ins[:4])
    sp_attr = torch.cat([sp_attr, sp_attr.new_zeros(1, 9)])[ab.pair_gauss]
    st = rasterize_tiled.CompositeStatic(tiles_x, tiles_y, tw, th, CHUNK, 256, "cuda")
    tile_ids = torch.arange(tiles_x * tiles_y, dtype=torch.int32, device=cuda_device)
    _, t_final, ncon = rasterize_cuda.composite_fwd_cuda(st, sp_attr, tile_ids, ab.starts,
                                                         ab.ends)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    g_color = torch.randn((*t_final.shape, 3), generator=gen, device=cuda_device)
    gt_term = torch.randn(t_final.shape, generator=gen, device=cuda_device) * t_final
    ends = rasterize_tiled.ncon_trimmed_ends(st, ab.starts, ab.ends, ncon)
    args = (st, sp_attr, tile_ids, ab.starts, ends, t_final, ncon, g_color, gt_term)
    before = rasterize_cuda.LAUNCHES["composite_bwd"]
    got = rasterize_cuda.composite_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert rasterize_cuda.LAUNCHES["composite_bwd"] == before + 1
    ref = rasterize_cuda.composite_bwd_torch(*args)
    _close_per_column(got.cpu().numpy(), ref.cpu().numpy(), 1e-4, 1e-5, "d_attr")
