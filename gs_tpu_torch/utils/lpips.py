"""LPIPS v0.1 (VGG16) in PyTorch (port of ``gs_tpu/utils/lpips.py``).

The reference's lpipsPyTorch package (``lpipsPyTorch/modules/lpips.py``,
``networks.py:66-96``, ``utils.py:11-30``): frozen VGG16 conv features at
relu{1_2,2_2,3_3,4_3,5_3}, channel-unit-normalized activations, squared
differences weighted by learned 1x1 "lin" layers, spatial and layer mean.
gs_tpu runs the convolutions through ``jax.lax.conv_general_dilated``, no
Pallas kernel, so ``torch.nn.functional.conv2d`` is their counterpart here.

Weights come from the same ``.npz`` gs_tpu reads (env
``GS_TPU_LPIPS_WEIGHTS`` or ``~/.cache/gs_tpu/lpips_vgg.npz``), so one file
serves both packages: ``conv{i}_w`` [KH,KW,Cin,Cout] / ``conv{i}_b`` [Cout]
for the 13 VGG16 convs (transposed here to torch's [Cout,Cin,KH,KW]),
``lin{j}_w`` [C_j] for the 5 lin layers, and ``mean`` / ``std`` [3].
``convert_torch_weights`` writes that file on a machine with torchvision
and network access. Without the file :func:`lpips_fn` returns None and the
metrics report LPIPS as null.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from gs_tpu_torch.device import resolve_device

# VGG16 conv plan: (out_channels, pool_before) per conv layer; features taken
# after the ReLU of convs 1, 3, 6, 9, 12 (torchvision indices 3,8,15,22,29)
_VGG_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
_TAP_LAYERS = (1, 3, 6, 9, 12)

DEFAULT_WEIGHTS = os.path.expanduser("~/.cache/gs_tpu/lpips_vgg.npz")


def _weights_path() -> str | None:
    path = os.environ.get("GS_TPU_LPIPS_WEIGHTS", DEFAULT_WEIGHTS)
    return path if os.path.exists(path) else None


@functools.lru_cache(maxsize=1)
def _load_weights():
    path = _weights_path()
    if path is None:
        return None
    with np.load(path) as z:
        return {k: np.asarray(z[k]) for k in z.files}


class LPIPS(torch.nn.Module):
    """LPIPS distance of two [3,H,W] images in [0,1] from gs_tpu's npz weights."""

    def __init__(self, w: dict[str, np.ndarray]):
        super().__init__()
        self.register_buffer("mean", torch.from_numpy(np.asarray(w["mean"], np.float32))
                             .reshape(1, 3, 1, 1))
        self.register_buffer("std", torch.from_numpy(np.asarray(w["std"], np.float32))
                             .reshape(1, 3, 1, 1))
        self.convs = torch.nn.ModuleList()
        cin = 3
        for i, (cout, _) in enumerate(_VGG_PLAN):
            conv = torch.nn.Conv2d(cin, cout, 3, padding=1)
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(
                    np.ascontiguousarray(w[f"conv{i}_w"].transpose(3, 2, 0, 1))))
                conv.bias.copy_(torch.from_numpy(np.asarray(w[f"conv{i}_b"])))
            self.convs.append(conv)
            cin = cout
        for j in range(len(_TAP_LAYERS)):
            self.register_buffer(f"lin{j}", torch.from_numpy(
                np.asarray(w[f"lin{j}_w"], np.float32)).reshape(-1, 1, 1))
        self.requires_grad_(False)

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """[3,H,W] in [0,1] -> the tap activations, each [C,h,w]."""
        x = ((x[None] - self.mean) / self.std)
        taps = []
        for i, (conv, (_, pool)) in enumerate(zip(self.convs, _VGG_PLAN)):
            if pool:
                x = F.max_pool2d(x, 2, 2)
            x = F.relu(conv(x))
            if i in _TAP_LAYERS:
                taps.append(x[0])
        return taps

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        def unit_normalize(f):
            return f / (torch.sqrt(torch.sum(f * f, dim=0, keepdim=True)) + 1e-10)

        total = x.new_zeros(())
        for j, (a, b) in enumerate(zip(self.features(x), self.features(y))):
            diff = (unit_normalize(a) - unit_normalize(b)) ** 2  # [C,h,w]
            total = total + torch.mean(torch.sum(getattr(self, f"lin{j}") * diff, dim=0))
        return total


def lpips_fn(device: str | torch.device = "cuda"):
    """Returns ``lpips(x, y) -> 0-d tensor`` for [3,H,W] pairs in [0,1] on
    ``device``, or None when the weights file is unavailable (offline)."""
    w = _load_weights()
    if w is None:
        return None
    dev = resolve_device(device)
    net = LPIPS(w).to(dev).eval()

    @torch.no_grad()
    def lpips(x, y) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        y = torch.as_tensor(y, dtype=torch.float32, device=dev)
        return net(x, y)

    return lpips


def convert_torch_weights(out_path: str = DEFAULT_WEIGHTS) -> str:
    """One-time converter: torchvision VGG16 + richzhang lin -> npz.

    Run on a machine with torchvision and network access; copy the npz here.
    """
    import torchvision

    vgg = torchvision.models.vgg16(weights="IMAGENET1K_V1").features.eval()
    url = ("https://raw.githubusercontent.com/richzhang/PerceptualSimilarity"
           "/master/lpips/weights/v0.1/vgg.pth")
    lin_sd = torch.hub.load_state_dict_from_url(url, progress=True,
                                                map_location="cpu")
    out = {}
    conv_i = 0
    for layer in vgg:
        if isinstance(layer, torch.nn.Conv2d):
            out[f"conv{conv_i}_w"] = (
                layer.weight.detach().numpy().transpose(2, 3, 1, 0)
            )
            out[f"conv{conv_i}_b"] = layer.bias.detach().numpy()
            conv_i += 1
    for j in range(5):
        key = f"lin{j}.model.1.weight"
        out[f"lin{j}_w"] = lin_sd[key].detach().numpy().reshape(-1)
    # lpipsPyTorch normalizers for [0,1] inputs (modules/utils.py)
    out["mean"] = np.array([0.485, 0.456, 0.406], np.float32)
    out["std"] = np.array([0.229, 0.224, 0.225], np.float32)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez(out_path, **out)
    return out_path
