"""GaussianState: the learned scene representation.

Port of ``gs_tpu/models/gaussians.py``: a fixed-capacity set of tensors
with an ``alive`` mask (densify and prune rewrite slots; capacity grows by
doublings). Activations (exp / sigmoid / quat-normalize) are applied at
read time.

Parameter semantics (identical to the reference ``scene/gaussian_model.py``):
  xyz[.,3] world centers; features_dc[.,1,3] + features_rest[.,K-1,3] SH
  coefficients (K = (max_sh_degree+1)^2); log_scale[.,3]; quat[.,4]
  (w,x,y,z); logit_opacity[.,1].
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from gs_tpu_torch.device import resolve_device
from gs_tpu_torch.ops import knn, sh

INIT_OPACITY = 0.1  # scene/gaussian_model.py:160


@dataclass
class GaussianState:
    """Padded Gaussian parameters. Leading dim = capacity; ``alive`` gates use."""

    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    log_scale: torch.Tensor
    quat: torch.Tensor
    logit_opacity: torch.Tensor
    alive: torch.Tensor  # [C] bool

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def max_sh_degree(self) -> int:
        return int(round((self.features_rest.shape[1] + 1) ** 0.5)) - 1

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()

    @property
    def scaling(self) -> torch.Tensor:
        return torch.exp(self.log_scale)

    @property
    def rotation(self) -> torch.Tensor:
        return self.quat / torch.linalg.norm(self.quat, dim=-1, keepdim=True).clamp(min=1e-12)

    @property
    def opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.logit_opacity)

    @property
    def features(self) -> torch.Tensor:
        """[C, K, 3] dc-first SH features."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def params(self) -> dict[str, torch.Tensor]:
        """The trainable tensors, keyed like the reference's Adam param groups."""
        return {
            "xyz": self.xyz,
            "f_dc": self.features_dc,
            "f_rest": self.features_rest,
            "opacity": self.logit_opacity,
            "scaling": self.log_scale,
            "rotation": self.quat,
        }

    def with_params(self, p: dict[str, torch.Tensor]) -> "GaussianState":
        """The state with its trainable tensors taken from ``p`` (keyed as
        :meth:`params`); ``alive`` is kept."""
        return self.replace(
            xyz=p["xyz"],
            features_dc=p["f_dc"],
            features_rest=p["f_rest"],
            logit_opacity=p["opacity"],
            log_scale=p["scaling"],
            quat=p["rotation"],
        )

    def replace(self, **fields) -> "GaussianState":
        return dataclasses.replace(self, **fields)


def round_capacity(n: int, quantum: int = 4096) -> int:
    return max(quantum, -(-n // quantum) * quantum)


def empty_state(capacity: int, max_sh_degree: int, *,
                device: str | torch.device = "cuda") -> GaussianState:
    dev = resolve_device(device)
    k = sh.num_sh_coeffs(max_sh_degree)
    f32 = dict(dtype=torch.float32, device=dev)
    return GaussianState(
        xyz=torch.zeros(capacity, 3, **f32),
        features_dc=torch.zeros(capacity, 1, 3, **f32),
        features_rest=torch.zeros(capacity, k - 1, 3, **f32),
        log_scale=torch.full((capacity, 3), -10.0, **f32),
        quat=torch.tensor([1.0, 0.0, 0.0, 0.0], **f32).repeat(capacity, 1),
        logit_opacity=torch.full((capacity, 1), -10.0, **f32),
        alive=torch.zeros(capacity, dtype=torch.bool, device=dev),
    )


def state_from_arrays(arrays: dict[str, np.ndarray], *, capacity: int | None = None,
                      device: str | torch.device = "cuda") -> GaussianState:
    """A state holding the N Gaussians of ``arrays`` (numpy, keyed like the
    state's fields; ``alive`` optional) in the first N of ``capacity``
    slots (default :func:`round_capacity`)."""
    n = arrays["xyz"].shape[0]
    k1 = arrays["features_rest"].shape[1]
    cap = round_capacity(n) if capacity is None else capacity
    if cap < n:
        raise ValueError(f"capacity {cap} < point count {n}")
    st = empty_state(cap, int(round((k1 + 1) ** 0.5)) - 1, device=device)
    for name in ("xyz", "features_dc", "features_rest", "log_scale", "quat", "logit_opacity"):
        getattr(st, name)[:n] = torch.from_numpy(np.array(arrays[name], np.float32))
    alive = arrays.get("alive")
    st.alive[:n] = True if alive is None else torch.from_numpy(np.array(alive, bool))
    return st


def create_from_pcd(
    points: np.ndarray,
    colors: np.ndarray,
    max_sh_degree: int,
    capacity: int | None = None,
    *,
    device: str | torch.device = "cuda",
) -> GaussianState:
    """Initialize from an SfM point cloud (``scene/gaussian_model.py:135-174``).

    - SH dc band from RGB, higher bands zero
    - isotropic log-scale from sqrt(mean 3-NN squared distance)
    - identity quaternions, opacity sigmoid^-1(0.1)
    """
    n = points.shape[0]
    cap = round_capacity(n) if capacity is None else capacity
    if cap < n:
        raise ValueError(f"capacity {cap} < point count {n}")
    st = empty_state(cap, max_sh_degree, device=device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=st.device)
    dist2 = torch.clamp(knn.mean_knn_sq_dist(pts, k=3), min=1e-7)
    st.xyz[:n] = pts
    st.features_dc[:n] = sh.rgb_to_sh(
        torch.as_tensor(np.asarray(colors, np.float32), device=st.device))[:, None, :]
    st.log_scale[:n] = torch.log(torch.sqrt(dist2))[:, None]
    st.logit_opacity[:n] = float(np.log(INIT_OPACITY / (1 - INIT_OPACITY)))
    st.alive[:n] = True
    return st


def grow_capacity(state: GaussianState, new_capacity: int) -> GaussianState:
    """Pad every field with empty (dead) slots up to ``new_capacity``."""
    if new_capacity < state.capacity:
        raise ValueError("capacity can only grow")
    if new_capacity == state.capacity:
        return state
    tmpl = empty_state(new_capacity - state.capacity, state.max_sh_degree, device=state.device)
    return GaussianState(**{f.name: torch.cat([getattr(state, f.name), getattr(tmpl, f.name)])
                            for f in dataclasses.fields(GaussianState)})
