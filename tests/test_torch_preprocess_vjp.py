"""The preprocess's hand-written forward and VJP (``ops/preprocess_cuda.py``) on the CPU.

The plain closed-form VJP (the kernel's reference, and the CPU path of
``PreprocessFn``) against ``torch.autograd.grad`` of the plain route and
against ``jax.vjp`` of gs_tpu's preprocess, on the same numpy inputs, at SH
degrees 0-4, on ``torch_port_inputs.preprocess_edge_inputs``: Gaussians
behind the near plane, x/z and y/z past the clamp, needles whose 2D
covariance's det rounds to <= 0, a clamped colour channel, dead slots and
a centre on the camera. Autograd's exact zeros are exact zeros here. Then:
the Function engages only on the default route with a gradient to take
(not under ``no_grad``, not on the ``*_python`` or override routes, which
render as before), once a ``train_step``; the wrapper refuses a wrong
dtype, shape or device; and, on a card, the kernel against the plain
version (``cuda`` marker, skipped here; ``chip_smoke.preprocess_edges``).
The forward's wrapper ``preprocess_fwd`` is the plain forward on CPU
tensors, bit for bit; every render of the default route reaches it once,
with or without a gradient, and no other route does; it refuses what its
kernel does not take; on a card its kernel is held against the plain
forward (``chip_smoke.preprocess_fwd_edges``).

Tolerance (``ROW_RTOL`` = 1e-4 of each Gaussian's largest gradient entry
of a leaf, the same for autograd, gs_tpu and the kernel): the VJPs add
their float32 terms in other orders, and the quaternion's gradient is a
projection onto the tangent plane, (g - q (q . g)) / |q|, that cancels;
rows kept about five digits (autograd on the CPU: up to 2.5e-5; the
kernel on an H100: up to 8.8e-5). Needles the forward kept are held to finiteness only: their
det is all rounding, so every VJP's value there is rounding too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_tpu import cameras as j_cameras
from gs_tpu.ops import projection as j_projection
from gs_tpu_torch import interop, training
from gs_tpu_torch.ops import preprocess_cuda, projection
from gs_tpu_torch.renderer import render
from tests.torch_port_inputs import (PREPROCESS_EDGE_KINDS, ROW_RTOL,  # noqa: F401
                                     camera_args, camera_dict, one_torch_thread,
                                     preprocess_edge_inputs, row_errors, scene_arrays)

N = 2000
DEGREES = [0, 1, 2, 3, 4]
BG = np.array([0.1, 0.2, 0.3], np.float32)


@pytest.fixture(scope="module")
def cams():
    jcam = j_cameras.make_camera(**camera_args(61, 47))
    return jcam, interop.camera_from_numpy(camera_dict(jcam), "cpu")


def _case(deg, rest, cam, seed):
    """Edge inputs, the forward's mask and the Gaussians held to finiteness."""
    leaves, cots = preprocess_edge_inputs(N, rest, seed=seed, device="cpu")
    with torch.no_grad():
        sp, col = preprocess_cuda.plain_forward(*leaves, cam, 1.0, deg)
    kinds = torch.arange(N) % len(PREPROCESS_EDGE_KINDS)
    needle = (kinds == PREPROCESS_EDGE_KINDS.index("degenerate")) & sp.mask
    return leaves, cots, sp, col, kinds, needle


def _assert_close(got, want, keep, what):
    for name, e in row_errors(got, want, keep).items():
        assert e["rel"] <= ROW_RTOL, (what, name, e)


def _autograd(leaves, cam, deg, cots, depths):
    req = [t.clone().requires_grad_() for t in leaves]
    with torch.enable_grad():
        sp, col = preprocess_cuda.plain_forward(*req, cam, 1.0, deg)
    outs = [sp.means2d, sp.conics, col] + ([sp.depths] if depths else [])
    return torch.autograd.grad(outs, req, cots[:len(outs)], allow_unused=True,
                               materialize_grads=True)


@pytest.mark.parametrize("depths", [False, True], ids=["no_depths", "depths"])
@pytest.mark.parametrize("deg,rest", [(d, r) for d in DEGREES for r in sorted({d * (d + 2), 24})])
def test_plain_vjp_matches_autograd(cams, deg, rest, depths):
    """Every edge kind occurs; rows to ROW_RTOL; every exact zero of
    autograd's is an exact zero here (and the reverse); culled Gaussians
    take nothing from the projection; the coefficients past the active
    degree and, at degree 0, the view direction take nothing."""
    cam = cams[1]
    leaves, cots, sp, _, kinds, needle = _case(deg, rest, cam, seed=10 * deg + rest)
    t = leaves[0] @ cam.view[:3, :3].T + cam.view[:3, 3]
    in_front = t[:, 2] > projection.FRUSTUM_NEAR_Z
    lim_x = 1.3 * cam.tan_fovx
    assert (~in_front[kinds == 1]).all() and int((in_front & ~sp.mask).sum()) > 0
    assert int(((t[:, 0] / t[:, 2]).abs() > lim_x)[kinds == 2].sum()) > 0
    assert int(needle.sum()) > 0 and int((~sp.mask & (kinds == 4)).sum()) > 0
    got = preprocess_cuda.preprocess_bwd(*leaves, cam, 1.0, deg, sp.mask, *cots[:3],
                                         cots[3] if depths else None)
    want = _autograd(leaves, cam, deg, cots, depths)
    _assert_close(got, want, ~needle, "autograd")
    for name, g, w in zip(preprocess_cuda.LEAF_NAMES, got, want):
        assert torch.isfinite(g).all(), name
        assert torch.equal(g[~needle] == 0, w[~needle] == 0), name
    culled = ~sp.mask
    assert (got[1][culled] == 0).all() and (got[2][culled] == 0).all()
    assert (got[4][:, (deg + 1) ** 2 - 1:] == 0).all()
    dead = kinds == PREPROCESS_EDGE_KINDS.index("dead")
    assert all((g[dead] == 0).all() for g in got)
    clamped = kinds == PREPROCESS_EDGE_KINDS.index("clamped_colour")
    assert int((got[3][clamped] == 0).any(-1).sum()) > 0
    if deg == 0:  # xyz's gradient is the projection's alone: none where culled
        assert (got[0][culled] == 0).all()


@pytest.mark.parametrize("deg", DEGREES)
def test_plain_vjp_matches_jax(cams, deg):
    """Against jax.vjp of gs_tpu's compute_cov3d -> project_gaussians ->
    sh_colors on the same numpy inputs, depths' cotangent included. The
    needles are left out: whether their det rounds above 0 differs between
    the two forwards, which cull them differently."""
    jcam, cam = cams
    leaves, cots, sp, _, kinds, _ = _case(deg, 24, cam, seed=deg)
    keep = kinds != PREPROCESS_EDGE_KINDS.index("degenerate")

    def j_pre(xyz, log_scale, quat, f_dc, f_rest):
        jsp = j_projection.project_gaussians(
            xyz, j_projection.compute_cov3d(log_scale, quat), jcam)
        col = j_projection.sh_colors(xyz, f_dc, f_rest, jcam.cam_pos, deg)
        return jsp.means2d, jsp.conics, col, jsp.depths

    outs, vjp = jax.vjp(j_pre, *(jnp.asarray(t.numpy()) for t in leaves))
    np.testing.assert_array_equal(np.asarray(outs[3])[keep.numpy()], sp.depths[keep].numpy())
    want = [torch.from_numpy(np.array(g)) for g in vjp(tuple(jnp.asarray(c.numpy())
                                                             for c in cots))]
    got = preprocess_cuda.preprocess_bwd(*leaves, cam, 1.0, deg, sp.mask, *cots)
    _assert_close(got, want, keep, "gs_tpu")


def _counting(monkeypatch):
    """Count PreprocessFn's forwards, the forward wrapper's calls and the
    backward calls."""
    calls = {"apply": 0, "fwd": 0, "bwd": 0}
    apply, fwd = preprocess_cuda.PreprocessFn.apply, preprocess_cuda.preprocess_fwd
    bwd = preprocess_cuda.preprocess_bwd

    def counted_apply(*a):
        calls["apply"] += 1
        return apply(*a)

    def counted_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def counted_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(preprocess_cuda.PreprocessFn, "apply", counted_apply)
    monkeypatch.setattr(preprocess_cuda, "preprocess_fwd", counted_fwd)
    monkeypatch.setattr(preprocess_cuda, "preprocess_bwd", counted_bwd)
    return calls


@pytest.fixture(scope="module")
def scene():
    arr = scene_arrays(n=1024, sh_degree=3, seed=8)
    return interop.state_from_numpy(arr, "cpu")


@pytest.mark.parametrize("route", ["default", "no_grad", "convert_shs_python",
                                   "compute_cov3d_python", "override_color", "cov3d_precomp"])
def test_function_engages_only_on_the_default_route_with_a_gradient(cams, scene, monkeypatch,
                                                                      route):
    """The Function runs (one forward, one backward) on the default route
    with a gradient to take, and nowhere else; the forward's wrapper runs
    once a render on the default route, with or without a gradient, and on
    no other route; the render is bitwise the render of the plain route
    under no_grad, on every route."""
    cam = cams[1]
    kw = {}
    if route in ("convert_shs_python", "compute_cov3d_python"):
        kw[route] = True
    elif route == "override_color":
        kw[route] = torch.full((scene.capacity, 3), 0.5)
    elif route == "cov3d_precomp":
        kw[route] = projection.compute_cov3d(scene.log_scale, scene.quat)
    with torch.no_grad():
        plain = render(cam, scene, active_sh_degree=3, bg_color=BG, **kw)
    calls = _counting(monkeypatch)
    params = {k: v.clone().requires_grad_() for k, v in scene.params().items()}
    with torch.set_grad_enabled(route != "no_grad"):
        out = render(cam, scene.with_params(params), active_sh_degree=3, bg_color=BG, **kw)
    assert torch.equal(out.image, plain.image) and torch.equal(out.radii, plain.radii)
    engaged = route == "default"
    assert calls["apply"] == int(engaged)
    assert calls["fwd"] == int(route in ("default", "no_grad"))
    if route != "no_grad":
        grads = torch.autograd.grad(out.image.sum(), list(params.values()), allow_unused=True)
        assert grads[0] is not None and torch.isfinite(grads[0]).all()
    assert calls["bwd"] == int(engaged)


def test_train_step_takes_the_vjp_once(monkeypatch):
    """Two train_steps of the tiny synthetic fit: one PreprocessFn forward,
    one call of the forward's wrapper and one backward a step, and the loss
    falls."""
    from tests.torch_port_inputs import tiny_synthetic_scene
    from gs_tpu_torch.config import OptimizationParams, RasterizeConfig

    sc = tiny_synthetic_scene()
    cam = sc.get_train_cameras()[0]
    calls = _counting(monkeypatch)
    ts = training.init_train_state(sc.gaussians, 1.5, 0)
    state, adam, stats, losses = ts.state, ts.adam, ts.stats, []
    for i in range(2):
        state, adam, stats, m = training.train_step(
            state, adam, stats, cam, torch.zeros(3), i, 1.5, active_sh_degree=0,
            opt_cfg=OptimizationParams(), raster_cfg=RasterizeConfig(chunk=32),
            accumulate_stats=True)
        losses.append(float(m["loss"]))
    assert calls == {"apply": 2, "fwd": 2, "bwd": 2}
    assert losses[1] < losses[0]


def _bad(kind, leaves, cots, valid):
    """One argument made wrong: (leaves, cots, valid, degree)."""
    leaves, cots, deg = list(leaves), list(cots), 3
    if kind == "dtype":
        leaves[0] = leaves[0].double()
    elif kind == "shape":
        leaves[2] = leaves[2][:, :3]
    elif kind == "rest_rows":
        leaves[4] = leaves[4][:, :8]
    elif kind == "valid":
        valid = valid.to(torch.uint8)
    elif kind == "cotangent":
        cots[1] = cots[1][:, :2]
    elif kind == "degree":
        deg = 5
    elif kind == "device":
        leaves[3] = leaves[3].to("meta")
    return leaves, cots, valid, deg


@pytest.mark.parametrize("kind", ["dtype", "shape", "rest_rows", "valid", "cotangent",
                                  "degree", "device"])
def test_wrapper_raises_on_bad_arguments(cams, kind):
    cam = cams[1]
    leaves, cots = preprocess_edge_inputs(16, 15, seed=0, device="cpu")
    with torch.no_grad():
        sp, _ = preprocess_cuda.plain_forward(*leaves, cam, 1.0, 3)
    leaves, cots, valid, deg = _bad(kind, leaves, cots, sp.mask)
    with pytest.raises(ValueError):
        preprocess_cuda.preprocess_bwd(*leaves, cam, 1.0, deg, valid, *cots)


@pytest.mark.parametrize("deg,rest", [(d, r) for d in DEGREES for r in sorted({d * (d + 2), 24})])
def test_forward_wrapper_is_the_plain_forward_on_the_cpu(cams, deg, rest):
    """On CPU tensors ``preprocess_fwd`` returns ``plain_forward``'s tensors
    bit for bit (floats as 32-bit words, so -0.0 and NaN payloads count),
    on every edge kind, at the active degree and at 24 rest rows."""
    cam = cams[1]
    leaves, _ = preprocess_edge_inputs(N, rest, seed=100 + 10 * deg + rest, device="cpu")
    with torch.no_grad():
        want_sp, want_col = preprocess_cuda.plain_forward(*leaves, cam, 0.9, deg)
        got_sp, got_col = preprocess_cuda.preprocess_fwd(*leaves, cam, 0.9, deg)
    for name, g, w in zip((*projection.ProjectedSplats._fields, "colors"),
                          (*got_sp, got_col), (*want_sp, want_col)):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), name
    assert got_sp.radii.dtype == torch.int32 and got_sp.mask.dtype == torch.bool
    assert int((~got_sp.mask).sum()) > 0 and int(got_sp.mask.sum()) > 0


def _bad_leaves(kind, leaves):
    """One argument of the forward made wrong: (leaves, degree)."""
    leaves, deg = list(leaves), 3
    if kind == "dtype":
        leaves[1] = leaves[1].half()
    elif kind == "shape":
        leaves[3] = leaves[3][:, 0]
    elif kind == "rest_rows":
        leaves[4] = leaves[4][:, :14]
    elif kind == "degree":
        deg = -1
    elif kind == "device":
        leaves[0] = leaves[0].to("meta")
    elif kind == "index_limit":  # 2^31 rows as stride-0 views: no memory behind them
        leaves = [t[:1].expand(preprocess_cuda.INDEX_LIMIT, *t.shape[1:]) for t in leaves]
    return leaves, deg


@pytest.mark.parametrize("kind", ["dtype", "shape", "rest_rows", "degree", "device",
                                  "index_limit"])
def test_forward_wrapper_raises_on_bad_arguments(cams, kind):
    cam = cams[1]
    leaves, _ = preprocess_edge_inputs(16, 15, seed=0, device="cpu")
    leaves, deg = _bad_leaves(kind, leaves)
    with pytest.raises(ValueError, match="int32" if kind == "index_limit" else None):
        preprocess_cuda.preprocess_fwd(*leaves, cam, 1.0, deg)


# --- on the card -----------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_edges(cuda_device):
    """chip_smoke.preprocess_edges: the kernel against the plain version at
    degrees 0-4, N = 1, 3 blocks + 37, 0 and 4096, exact zeros exactly,
    same bits twice, one launch a call."""
    import chip_smoke

    worst = chip_smoke.preprocess_edges(torch, cuda_device)  # raises on a failed check
    assert all(e["rel"] <= ROW_RTOL for e in worst.values())


@pytest.mark.cuda
def test_cuda_forward_kernel_matches_plain_on_edges(cuda_device):
    """chip_smoke.preprocess_fwd_edges: P2 against the plain forward at
    degrees 0-4, N = 1, 3 blocks + 37, 0 and 4096, with the active degree's
    rest rows and with 24: the mask bit for bit, the radii, the float
    outputs within P2_MAX_STEPS (bit for bit where PyTorch's orders are
    P2's), the same bits twice, one launch a call."""
    import chip_smoke

    total = chip_smoke.preprocess_fwd_edges(torch, cuda_device)  # raises on a failed check
    assert total["cases"] == 36 and total["radii_off"] == 0


@pytest.mark.cuda
def test_cuda_train_step_launches_once(cuda_device):
    """Two train_steps of a small scene on the card (the edge camera, a
    random target): one launch of each preprocess kernel (P2, the forward,
    and P1, the VJP) a step, finite losses."""
    from gs_tpu_torch.config import OptimizationParams, RasterizeConfig
    from gs_tpu_torch.models import gaussians
    from gs_tpu_torch.ops import cuda_build
    from tests.torch_port_inputs import preprocess_edge_camera

    arrays = scene_arrays(n=4000, sh_degree=3, seed=0, dead=0)
    state = gaussians.state_from_arrays({k: v for k, v in arrays.items() if k != "alive"},
                                        device=cuda_device)
    cam = preprocess_edge_camera(cuda_device)
    cam.image = torch.rand((3, cam.height, cam.width), device=cuda_device)
    ts = training.init_train_state(state, 1.5, 3)
    st, adam, stats = ts.state, ts.adam, ts.stats
    before = dict(cuda_build.LAUNCHES)
    for i in range(2):
        st, adam, stats, m = training.train_step(
            st, adam, stats, cam, torch.zeros(3, device=cuda_device), i, 1.5,
            active_sh_degree=3, opt_cfg=OptimizationParams(), raster_cfg=RasterizeConfig(),
            accumulate_stats=True)
        assert np.isfinite(float(m["loss"]))
    for kernel in ("preprocess_fwd", "preprocess_bwd"):
        assert cuda_build.LAUNCHES[kernel] - before[kernel] == 2, kernel
