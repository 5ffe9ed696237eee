"""gs_tpu_torch rasterization: golden bundle, plain compositor vs gs_tpu's.

- The port's oracle and ``rasterize_tiled`` against the fp64 golden bundle
  at test_golden.py's forward tolerances (image rtol/atol 2e-5, T atol 2e-6).
- ``composite_fwd_torch`` against gs_tpu's XLA compositor and its Pallas
  kernel (interpret mode on the CPU, as tests/test_golden.py runs it) on
  the same binned pairs: color / T to 2e-5, ncon equal.
- ``effective_ends`` against gs_tpu's.
- The CUDA kernel against the plain version on the card (marked ``cuda``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_tpu.ops import binning as j_binning
from gs_tpu.ops import rasterize_pallas as j_pallas
from gs_tpu.ops import rasterize_tiled as j_tiled
from gs_tpu.ops.projection import bin_radii as j_bin_radii
from gs_tpu_torch.config import RasterizeConfig
from gs_tpu_torch.ops import rasterize_cuda, rasterize_tiled
from gs_tpu_torch.ops.rasterize_oracle import rasterize_oracle

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "raster_golden.npz")
INPUTS = ("means2d", "conics", "colors", "opacities", "depths", "radii")
CHUNK = 32


@pytest.fixture(scope="module")
def g():
    return dict(np.load(GOLDEN))


def _torch_inputs(g):
    return [torch.from_numpy(g[k]) for k in INPUTS]


def opaque_scene(h=64, w=64, n=160, seed=11):
    """Large opaque splats that cover whole tiles, so effective_ends truncates."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.001, 0.006, n)
    c = rng.uniform(0.001, 0.006, n)
    b = rng.uniform(-0.5, 0.5, n) * np.sqrt(a * c)
    det = a * c - b * b
    half_tr, cov_det = 0.5 * (a + c) / det, 1.0 / det
    lam = half_tr + np.sqrt(np.maximum(0.1, half_tr ** 2 - cov_det))
    return {
        "height": h, "width": w,
        "means2d": rng.uniform(0, max(h, w), (n, 2)).astype(np.float32),
        "conics": np.stack([a, b, c], -1).astype(np.float32),
        "colors": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "opacities": rng.uniform(0.85, 0.99, n).astype(np.float32),
        "depths": rng.uniform(2, 8, n).astype(np.float32),
        "radii": np.ceil(3.0 * np.sqrt(lam)).astype(np.int32),
    }


@pytest.fixture(scope="module", params=["golden", "opaque"])
def pairs(request, g):
    """Splats binned and gathered by gs_tpu (chunk 32, 16x16 tiles): the
    golden bundle's, and an opaque scene whose tiles truncate."""
    scene = g if request.param == "golden" else opaque_scene()
    h, w = int(scene["height"]), int(scene["width"])
    tiles_x, tiles_y = -(-w // 16), -(-h // 16)
    st = j_tiled.CompositeStatic(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=16, tile_h=16,
                                 chunk=CHUNK, tile_batch=8, backend="xla")

    @jax.jit
    def prepare(means2d, conics, colors, opac, depths, radii):
        ab = j_binning.bin_gaussians_aligned(means2d, depths, j_bin_radii(radii, opac),
                                             tiles_x, tiles_y, 16, 16, 8192, CHUNK)
        attr = j_tiled.pack_attributes(means2d, conics, colors, opac)
        sp_attr = jnp.concatenate([attr, jnp.zeros((1, 9), jnp.float32)])[ab.pair_gauss]
        tile_ids = jnp.arange(tiles_x * tiles_y, dtype=jnp.int32)
        ends_eff = j_tiled.effective_ends(st, sp_attr, tile_ids, ab.starts, ab.ends)
        return dict(sp_attr=sp_attr, tile_ids=tile_ids, starts=ab.starts, ends=ab.ends,
                    ends_eff=ends_eff, num_pairs=ab.num_pairs)

    out = prepare(*(jnp.asarray(scene[k]) for k in INPUTS))
    assert int(out["num_pairs"]) <= 8192
    return dict(out, name=request.param, st=st)


def _port_static(st, backend="torch"):
    return rasterize_tiled.CompositeStatic(st.tiles_x, st.tiles_y, st.tile_w, st.tile_h,
                                           st.chunk, st.tile_batch, backend)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_composite_close(got, want):
    color, t, ncon = (x.numpy() for x in got)
    np.testing.assert_allclose(color, np.asarray(want[0]), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(t, np.asarray(want[1]), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(ncon, np.asarray(want[2]))


# --- golden bundle -----------------------------------------------------------------


def _check_golden(out, g):
    np.testing.assert_allclose(out.image.numpy(), g["image"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.final_t.numpy(), g["t_final"], rtol=2e-5, atol=2e-6)


def test_oracle_matches_golden(g):
    h, w = int(g["height"]), int(g["width"])
    _check_golden(rasterize_oracle(*_torch_inputs(g), h, w, torch.from_numpy(g["bg"])), g)


@pytest.mark.parametrize("backend", ["torch", "auto", "cuda"])
@pytest.mark.parametrize("truncate", [True, False])
def test_rasterize_tiled_matches_golden(g, backend, truncate):
    h, w = int(g["height"]), int(g["width"])
    cfg = RasterizeConfig(backend=backend, chunk=CHUNK, min_pair_budget=1 << 13,
                          truncate_tiles=truncate)
    out = rasterize_tiled.rasterize_tiled(*_torch_inputs(g), h, w, torch.from_numpy(g["bg"]),
                                          cfg)
    _check_golden(out, g)
    assert int(out.num_pairs) <= rasterize_tiled.current_pair_budget(cfg, 384)


# --- compositor vs gs_tpu ------------------------------------------------------------


@pytest.mark.parametrize("ends_key", ["ends", "ends_eff"])
def test_composite_fwd_torch_matches_xla(pairs, ends_key):
    p = pairs
    want = j_tiled._composite_fwd_xla(p["st"], p["sp_attr"], p["tile_ids"], p["starts"],
                                      p[ends_key])
    got = rasterize_cuda.composite_fwd_torch(
        _port_static(p["st"]), _t(p["sp_attr"]), _t(p["tile_ids"]), _t(p["starts"]),
        _t(p[ends_key]))
    _assert_composite_close(got, want)


def test_composite_fwd_torch_matches_pallas(pairs):
    p = pairs
    assert j_pallas._interpret()  # the Pallas kernel runs in interpret mode here
    want = j_pallas.composite_fwd_pallas(p["st"], p["sp_attr"], p["tile_ids"], p["starts"],
                                         p["ends_eff"])
    got = rasterize_cuda.composite_fwd_torch(
        _port_static(p["st"]), _t(p["sp_attr"]), _t(p["tile_ids"]), _t(p["starts"]),
        _t(p["ends_eff"]))
    _assert_composite_close(got, want)


@pytest.mark.parametrize("tile_batch", [1, 7, 64])
def test_composite_tile_batching_is_invisible(pairs, tile_batch):
    p = pairs
    args = (_t(p["sp_attr"]), _t(p["tile_ids"]), _t(p["starts"]), _t(p["ends_eff"]))
    ref = rasterize_cuda.composite_fwd_torch(_port_static(p["st"]), *args)
    st = _port_static(p["st"])._replace(tile_batch=tile_batch)
    for a, b in zip(rasterize_cuda.composite_fwd_torch(st, *args), ref):
        assert torch.equal(a, b)


def test_effective_ends_matches(pairs):
    p = pairs
    got = rasterize_tiled.effective_ends(_port_static(p["st"]), _t(p["sp_attr"]),
                                         _t(p["tile_ids"]), _t(p["starts"]), _t(p["ends"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(p["ends_eff"]))
    if p["name"] == "opaque":
        assert (got < _t(p["ends"])).sum() > 10  # the opaque scene does truncate


def test_effective_ends_tile_subset(pairs):
    """Any disjoint ascending entry list works, e.g. every other tile."""
    p = pairs
    sel = np.arange(0, int(p["tile_ids"].shape[0]), 2)
    args = [np.asarray(p[k])[sel] for k in ("tile_ids", "starts", "ends")]
    want = j_tiled.effective_ends(p["st"], p["sp_attr"], *map(jnp.asarray, args))
    got = rasterize_tiled.effective_ends(_port_static(p["st"]), _t(p["sp_attr"]),
                                         *map(_t, args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cuda_wrapper_on_cpu_runs_plain_version(pairs):
    p = pairs
    args = (_t(p["sp_attr"]), _t(p["tile_ids"]), _t(p["starts"]), _t(p["ends_eff"]))
    before = rasterize_cuda.LAUNCHES["composite_fwd"]
    got = rasterize_cuda.composite_fwd_cuda(_port_static(p["st"], "cuda"), *args)
    ref = rasterize_cuda.composite_fwd_torch(_port_static(p["st"]), *args)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert rasterize_cuda.LAUNCHES["composite_fwd"] == before  # no kernel launched


def test_empty_tiles_composite_to_background(pairs):
    p = pairs
    st = _port_static(p["st"])
    starts = _t(p["starts"])
    color, t, ncon = rasterize_cuda.composite_fwd_torch(
        st, _t(p["sp_attr"]), _t(p["tile_ids"]), starts, starts.clone())
    assert (color == 0).all() and (t == 1).all() and (ncon == 0).all()


def test_composite_inputs_are_checked(pairs):
    p = pairs
    st = _port_static(p["st"])
    args = [_t(p["sp_attr"]), _t(p["tile_ids"]), _t(p["starts"]), _t(p["ends"])]
    with pytest.raises(ValueError, match="sp_attr"):
        rasterize_cuda.composite_fwd_cuda(st, args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="starts"):
        rasterize_cuda.composite_fwd_cuda(st, args[0], args[1], args[2].long(), args[3])


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="backend"):
        rasterize_tiled.resolve_backend("pallas")


# --- on the card -----------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(16, 16), (48, 32)])
def test_cuda_kernel_matches_plain(g, cuda_device, tile):
    """Kernel vs plain version on the card, on the golden splats binned by the
    port: same decisions, so ncon and T agree exactly and color to 2e-5."""
    tw, th = tile
    h, w = int(g["height"]), int(g["width"])
    inputs = [x.to(cuda_device) for x in _torch_inputs(g)]
    cfg = RasterizeConfig(tile_w=tw, tile_h=th, chunk=CHUNK, min_pair_budget=1 << 13)
    tiles_x, tiles_y = -(-w // tw), -(-h // th)
    ab = rasterize_tiled.binning.bin_gaussians_aligned(
        inputs[0], inputs[4], rasterize_tiled.bin_radii(inputs[5], inputs[3]), tiles_x,
        tiles_y, tw, th, 8192, CHUNK)
    attr = rasterize_tiled.pack_attributes(*inputs[:4])
    sp_attr = torch.cat([attr, attr.new_zeros(1, 9)])[ab.pair_gauss]
    st = rasterize_tiled.CompositeStatic(tiles_x, tiles_y, tw, th, CHUNK, cfg.tile_batch, "cuda")
    tile_ids = torch.arange(tiles_x * tiles_y, dtype=torch.int32, device=cuda_device)
    args = (sp_attr, tile_ids, ab.starts, ab.ends)
    before = rasterize_cuda.LAUNCHES["composite_fwd"]
    got = rasterize_cuda.composite_fwd_cuda(st, *args)
    torch.cuda.synchronize()
    assert rasterize_cuda.LAUNCHES["composite_fwd"] == before + 1
    ref = rasterize_cuda.composite_fwd_torch(st, *args)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=2e-5)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=2e-6)
    assert torch.equal(got[2], ref[2])
