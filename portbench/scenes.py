"""Seeded scenes: Gaussians, an orbit of cameras, ground-truth images and
the optimizer state of a fit resumed half way, made from ``--seed`` alone.

Nothing here imports the program: the same tensors go to the program and
to the reference. Every draw comes from a ``torch.Generator`` on the
device, a few large calls a scene, in float32; each kind of draw has its
own stream (``generator``), so a scene is the same whatever else a run
draws.

The Gaussians fill a ball of radius ``scene.radius`` uniformly; the
cameras sit on an orbit outside it and look at its middle, so each view
sees the near half of the ball's middle and not its rim or back. Scales
are drawn log-normally around ``scene.scale_factor`` times the mean
spacing that N points in the ball imply, (4/3 pi r^3 / N)^(1/3), in closed
form: no nearest-neighbour search.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SH_C0 = 0.28209479177387814
CAPACITY_QUANTUM = 4096  # slots come in multiples of this, as a fit grows them
STREAMS = {"gaussians": 1, "adam": 2, "orbit": 3, "images": 4, "sample": 6}


def generator(seed: int, stream: str, device) -> torch.Generator:
    """The generator of one kind of draw for ``seed``."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + STREAMS[stream]) % (1 << 63))


def capacity(n: int) -> int:
    return -(-n // CAPACITY_QUANTUM) * CAPACITY_QUANTUM


def sh_rest_count(degree: int) -> int:
    return (degree + 1) ** 2 - 1


def gaussians(cfg: dict, seed: int, device) -> dict:
    """Raw parameters of ``cfg["gaussians"]`` live Gaussians in a
    ``capacity`` of slots (the dead tail as a fresh slot is), and ``alive``."""
    n = cfg["gaussians"]
    cap = capacity(n)
    sc = cfg["scene"]
    gen = generator(seed, "gaussians", device)
    f32 = dict(dtype=torch.float32, device=device)
    k = sh_rest_count(cfg["sh_degree"])

    def normal(*shape):
        return torch.randn(*shape, generator=gen, **f32)

    def uniform(*shape):
        return torch.rand(*shape, generator=gen, **f32)

    direction = normal(n, 3)
    direction = direction / torch.linalg.norm(direction, dim=1, keepdim=True)
    xyz = direction * (sc["radius"] * uniform(n, 1) ** (1.0 / 3.0))
    spacing = (4.0 / 3.0 * math.pi * sc["radius"] ** 3 / n) ** (1.0 / 3.0)
    log_scale = math.log(sc["scale_factor"] * spacing) + sc["log_scale_sigma"] * normal(n, 3)
    quat = normal(n, 4)
    logit = sc["opacity_logit_mean"] + sc["opacity_logit_sigma"] * normal(n, 1)
    f_dc = ((uniform(n, 1, 3) - 0.5) / SH_C0)
    f_rest = sc["sh_rest_sigma"] * normal(n, k, 3)

    def padded(x, fill):
        tail = torch.empty((cap - n,) + tuple(x.shape[1:]), **f32)
        tail[:] = torch.as_tensor(fill, **f32)
        return torch.cat([x, tail])

    alive = torch.zeros(cap, dtype=torch.bool, device=device)
    alive[:n] = True
    return dict(xyz=padded(xyz, 0.0), f_dc=padded(f_dc, 0.0), f_rest=padded(f_rest, 0.0),
                scaling=padded(log_scale, -10.0), rotation=padded(quat, [1.0, 0.0, 0.0, 0.0]),
                opacity=padded(logit, -10.0), alive=alive)


def adam_state(cfg: dict, params: dict, seed: int, device) -> tuple[dict, dict]:
    """Adam's moments half way through a fit: per group, first moments
    ~ N(0, (0.3 g)^2) and second moments g^2 (0.5 + U(0, 1)) for the
    group's assumed gradient scale g (``adam.grad_scale``); zero on dead
    slots, as a fit leaves pruned slots."""
    gen = generator(seed, "adam", device)
    mu, nu = {}, {}
    alive = params["alive"]
    for name in sorted(cfg["adam"]["grad_scale"]):
        g = cfg["adam"]["grad_scale"][name]
        p = params[name]
        mask = alive.reshape((-1,) + (1,) * (p.dim() - 1))
        m = 0.3 * g * torch.randn(p.shape, generator=gen, dtype=torch.float32, device=device)
        v = g * g * (0.5 + torch.rand(p.shape, generator=gen, dtype=torch.float32, device=device))
        mu[name] = torch.where(mask, m, 0.0)
        nu[name] = torch.where(mask, v, 0.0)
    return mu, nu


def look_at(center: np.ndarray, target: np.ndarray):
    """(R, T) in COLMAP convention (R camera-to-world, T world-to-camera)
    of a camera at ``center`` looking at ``target``, world up +z, image y
    down."""
    fwd = target - center
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    w2c = np.stack([right, down, fwd])
    return w2c.T, -w2c @ center


def fov(cfg: dict) -> tuple[float, float]:
    """(fovx, fovy) from the assumed focal length in pixels."""
    f = cfg["focal_px"]
    return 2 * math.atan(cfg["width"] / (2 * f)), 2 * math.atan(cfg["height"] / (2 * f))


def orbit_pose(orbit: dict, angle: float, lift: float, aim: np.ndarray):
    """(R, T) of the camera at ``angle`` on the orbit, ``lift`` above its
    height, aimed at ``aim``."""
    center = np.array([orbit["radius"] * math.cos(angle), orbit["radius"] * math.sin(angle),
                       orbit["height"] + lift])
    return look_at(center, aim)


def views(cfg: dict, seed: int) -> list:
    """The dataset's views: (R, T) of ``cfg["views"]`` cameras around the
    orbit in order, each lifted and aimed with a seeded jitter."""
    orbit = cfg["orbit"]
    n = cfg["views"]
    gen = generator(seed, "orbit", "cpu")
    jit = torch.rand(n, 5, generator=gen, dtype=torch.float64).numpy() * 2 - 1
    out = []
    for i in range(n):
        angle = 2 * math.pi * (i + 0.5 * jit[i, 0]) / n
        aim = orbit["aim_jitter"] * jit[i, 2:5]
        out.append(orbit_pose(orbit, angle, orbit["height_jitter"] * jit[i, 1], aim))
    return out


def split(n: int, test_every: int) -> tuple[list, list]:
    """Train and test view indices: every ``test_every``-th view is held
    out, as the published ``--eval`` does."""
    test = [i for i in range(n) if i % test_every == 0]
    return [i for i in range(n) if i % test_every != 0], test


def images(cfg: dict, seed: int, count: int, device, which=None, batch: int = 8):
    """[len(which), 3, H, W] ground-truth images in [0, 1] of views
    ``which`` (default all ``count``): per view and channel a sum of three
    seeded plane waves. Not a render of the scene, so the loss stays where
    a fit in progress has it."""
    h, w = cfg["height"], cfg["width"]
    gen = generator(seed, "images", device)
    f32 = dict(dtype=torch.float32, device=device)
    waves = torch.rand(count, 3, 3, 4, generator=gen, **f32)  # view, channel, wave, params
    if which is not None:
        waves = waves[torch.as_tensor(which, device=device)]
    ys = torch.arange(h, **f32)[:, None] / h
    xs = torch.arange(w, **f32)[None, :] / w
    out = torch.empty(waves.shape[0], 3, h, w, **f32)
    for b0 in range(0, waves.shape[0], batch):
        wv = waves[b0:b0 + batch, ..., None, None]
        fx, fy = 1 + 7 * wv[..., 0, :, :], 1 + 7 * wv[..., 1, :, :]
        phase, amp = 2 * math.pi * wv[..., 2, :, :], 0.15 + 0.1 * wv[..., 3, :, :]
        img = 0.5 + (amp * torch.sin(2 * math.pi * (fx * xs + fy * ys) + phase)).sum(2)
        out[b0:b0 + batch] = img.clamp(0.0, 1.0)
    return out


def scene_extent(poses: list) -> float:
    """The published camera extent (``getNerfppNorm``): 1.1 x the largest
    distance of a camera centre from their mean."""
    centers = np.stack([-r @ t for r, t in poses])
    mean = centers.mean(0)
    return 1.1 * float(np.linalg.norm(centers - mean, axis=1).max())
