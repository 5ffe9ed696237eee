"""gs_tpu_torch's LPIPS (VGG16) against gs_tpu's JAX LPIPS on the same weights.

The weights are synthetic, in the published shapes and the exact npz schema
``convert_torch_weights`` writes (a copy of ``tests/test_lpips.py``'s
helper); one file is read by both packages through ``GS_TPU_LPIPS_WEIGHTS``.
"""

import numpy as np
import pytest
import torch

from gs_tpu.utils import lpips as j_lpips
from gs_tpu_torch.utils import lpips as lpips_mod
from tests.torch_port_inputs import one_torch_thread  # noqa: F401 (autouse)


def _tiny_vgg_weights(rng):
    """Random weights in the exact npz schema convert_torch_weights emits."""
    out = {}
    cin = 3
    for i, (cout, _pool) in enumerate(lpips_mod._VGG_PLAN):
        out[f"conv{i}_w"] = rng.normal(scale=0.05, size=(3, 3, cin, cout)).astype(np.float32)
        out[f"conv{i}_b"] = rng.normal(scale=0.01, size=(cout,)).astype(np.float32)
        cin = cout
    tap_channels = [lpips_mod._VGG_PLAN[i][0] for i in lpips_mod._TAP_LAYERS]
    for j, c in enumerate(tap_channels):
        out[f"lin{j}_w"] = np.abs(rng.normal(size=(c,))).astype(np.float32)
    out["mean"] = np.array([0.485, 0.456, 0.406], np.float32)
    out["std"] = np.array([0.229, 0.224, 0.225], np.float32)
    return out


@pytest.fixture
def weights(monkeypatch, tmp_path):
    """Synthetic weights in a file both packages read; caches cleared around."""
    w = _tiny_vgg_weights(np.random.default_rng(3))
    path = tmp_path / "w.npz"
    np.savez(path, **w)
    monkeypatch.setenv("GS_TPU_LPIPS_WEIGHTS", str(path))
    lpips_mod._load_weights.cache_clear()
    j_lpips._load_weights.cache_clear()
    yield w
    lpips_mod._load_weights.cache_clear()
    j_lpips._load_weights.cache_clear()


def test_plan_and_default_path_match_gs_tpu():
    assert lpips_mod._VGG_PLAN == j_lpips._VGG_PLAN
    assert lpips_mod._TAP_LAYERS == j_lpips._TAP_LAYERS
    assert lpips_mod.DEFAULT_WEIGHTS == j_lpips.DEFAULT_WEIGHTS


def test_unavailable_without_weights_in_both(monkeypatch, tmp_path):
    monkeypatch.setenv("GS_TPU_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    lpips_mod._load_weights.cache_clear()
    j_lpips._load_weights.cache_clear()
    assert lpips_mod.lpips_fn("cpu") is None
    assert j_lpips.lpips_fn() is None


def test_network_holds_the_file_weights(weights):
    """13 convs with the npz kernels transposed from [KH,KW,Cin,Cout] to
    torch's [Cout,Cin,KH,KW], and the five lin weights."""
    net = lpips_mod.LPIPS(weights)
    assert len(net.convs) == 13
    for i, conv in enumerate(net.convs):
        np.testing.assert_array_equal(conv.weight.numpy(),
                                      weights[f"conv{i}_w"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(conv.bias.numpy(), weights[f"conv{i}_b"])
    for j in range(5):
        np.testing.assert_array_equal(getattr(net, f"lin{j}").reshape(-1).numpy(),
                                      weights[f"lin{j}_w"])
    assert not any(p.requires_grad for p in net.parameters())


@pytest.mark.parametrize("noise", [0.03, 0.12, 0.5])
def test_matches_gs_tpu_jax_lpips(weights, noise):
    """Port against gs_tpu's JAX LPIPS on 3x37x41 images, rtol 2e-4."""
    rng = np.random.default_rng(int(noise * 100))
    x = rng.uniform(0, 1, (3, 37, 41)).astype(np.float32)
    y = np.clip(x + rng.normal(0, noise, x.shape), 0, 1).astype(np.float32)
    ours = float(lpips_mod.lpips_fn("cpu")(x, y))
    theirs = float(j_lpips.lpips_fn()(x, y))
    assert theirs > 1e-6
    np.testing.assert_allclose(ours, theirs, rtol=2e-4)


def test_identity_zero_and_symmetric(weights):
    rng = np.random.default_rng(0)
    fn = lpips_mod.lpips_fn("cpu")
    x = torch.from_numpy(rng.uniform(0, 1, (3, 40, 48)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(0, 1, (3, 40, 48)).astype(np.float32))
    assert abs(float(fn(x, x))) < 1e-6
    d_xy, d_yx = float(fn(x, y)), float(fn(y, x))
    assert d_xy > 0.0
    np.testing.assert_allclose(d_xy, d_yx, rtol=1e-5)


def test_default_device_is_the_card(weights):
    """lpips_fn defaults to device="cuda": without a card it raises instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lpips_mod.lpips_fn()
