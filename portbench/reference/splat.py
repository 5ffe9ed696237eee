"""Plain 3D Gaussian Splatting in PyTorch: the benchmark's reference.

A straightforward implementation of the published method (Kerbl et al.,
"3D Gaussian Splatting for Real-Time Radiance Field Rendering", SIGGRAPH
2023, and its CUDA rasterizer's forward and backward rules), written from
that description and independent of the program under test: it imports
nothing of it. Everything is computed in ``dtype`` (float32 for the
reference, a lower precision for the control) with TF32 off.

Forward, per view:

- covariance R S S^T R^T from the activated scale and the normalized
  quaternion; EWA projection with the 0.3 low-pass dilation, the z <= 0.2
  cull and the 1.3 tan(fov / 2) clamp; radius ceil(3 sqrt(lambda_max));
- colour from SH (degree <= 3) in the view direction, + 0.5, clamped at 0;
- each splat's 16x16 tile rectangle, a depth sort, per-tile lists;
- per pixel, front to back: skip power > 0 and alpha < 1/255, alpha capped
  at 0.99; the first splat with T (1 - alpha) < 1e-4 stops the pixel and
  does not contribute; colour = sum alpha T rgb, plus T_final * bg.

Backward: autograd through the same expressions, except where the
published backward departs from the derivative of its forward: the 0.99
cap passes the gradient through (the published kernel differentiates
opacity * G even where alpha is capped).

The loss is the published 0.8 L1 + 0.2 (1 - SSIM) with an 11x11 Gaussian
window (sigma 1.5) and zero padding, by ``conv2d``; Adam is
``torch.optim.Adam``'s update with eps 1e-15, one learning rate a group.

Tiles are composited in groups of about ``GROUP_ELEMENTS`` pair x pixel
evaluations, so a full-size view fits: a forward pass without gradients
gives the image; the loss's gradient on the image is then pushed back
group by group through a recomputed forward with autograd.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

ALPHA_SKIP = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
NEAR_Z = 0.2
DILATION = 0.3
TILE = 16
GROUP_ELEMENTS = 1 << 26
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)
SSIM_C1, SSIM_C2 = 0.01 ** 2, 0.03 ** 2
BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-15
GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


def no_tf32() -> None:
    """Full float32 in matrix products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def camera(R, T, fovx: float, fovy: float, width: int, height: int, device,
           znear: float = 0.01, zfar: float = 100.0) -> dict:
    """A view from COLMAP-convention extrinsics (R camera-to-world rotation,
    T world-to-camera translation), as the published ``Camera`` builds it."""
    w2c = np.eye(4)
    w2c[:3, :3] = np.asarray(R, np.float64).T
    w2c[:3, 3] = np.asarray(T, np.float64)
    tx, ty = math.tan(fovx / 2), math.tan(fovy / 2)
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = 1 / tx, 1 / ty
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    proj[3, 2] = 1.0
    full = proj.astype(np.float32) @ w2c.astype(np.float32)
    pos = np.linalg.inv(w2c)[:3, 3]

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return dict(view=f32(w2c), full=f32(full), pos=f32(pos), tan_x=tx, tan_y=ty,
                width=int(width), height=int(height))


def covariance(log_scale, quat):
    """[N, 3, 3] world covariance from raw scale and quaternion (w, x, y, z)."""
    q = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    rot = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1).reshape(-1, 3, 3)
    m = rot * torch.exp(log_scale)[:, None, :]
    return m @ m.transpose(1, 2)


def sh_color(xyz, f_dc, f_rest, cam_pos, degree: int):
    """RGB in the view direction, + 0.5 and clamped at 0 (degrees 0-3)."""
    d = xyz - cam_pos
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    sh = torch.cat([f_dc, f_rest], 1)
    rgb = SH_C0 * sh[:, 0]
    if degree > 0:
        rgb = rgb - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    if degree > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        rgb = (rgb + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
               + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6] + SH_C2[3] * xz * sh[:, 7]
               + SH_C2[4] * (xx - yy) * sh[:, 8])
    if degree > 2:
        rgb = (rgb + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9] + SH_C3[1] * xy * z * sh[:, 10]
               + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
               + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
               + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14] + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return torch.clamp(rgb + 0.5, min=0.0)


def project(params: dict, alive, cam: dict, degree: int):
    """Per-Gaussian splats: (attr [N, 9] = mean xy | conic abc | rgb |
    opacity, depth [N], radius [N] int64, 0 where culled)."""
    xyz = params["xyz"]
    dt = xyz.dtype
    view, full = cam["view"].to(dt), cam["full"].to(dt)
    t = xyz @ view[:3, :3].T + view[:3, 3]
    hom = xyz @ full[:, :3].T + full[:, 3]
    pw = 1.0 / (hom[:, 3] + 1e-7)
    mx = ((hom[:, 0] * pw + 1.0) * cam["width"] - 1.0) * 0.5
    my = ((hom[:, 1] * pw + 1.0) * cam["height"] - 1.0) * 0.5
    front = t[:, 2] > NEAR_Z
    tz = torch.where(front, t[:, 2], torch.ones_like(t[:, 2]))
    fx = cam["width"] / (2.0 * cam["tan_x"])
    fy = cam["height"] / (2.0 * cam["tan_y"])
    lx, ly = 1.3 * cam["tan_x"], 1.3 * cam["tan_y"]
    txz = torch.clamp(t[:, 0] / tz, -lx, lx) * tz
    tyz = torch.clamp(t[:, 1] / tz, -ly, ly) * tz
    zero = torch.zeros_like(tz)
    jac = torch.stack([fx / tz, zero, -fx * txz / (tz * tz),
                       zero, fy / tz, -fy * tyz / (tz * tz)], -1).reshape(-1, 2, 3)
    m = jac @ view[:3, :3]
    cov = m @ covariance(params["scaling"], params["rotation"]) @ m.transpose(1, 2)
    a = cov[:, 0, 0] + DILATION
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + DILATION
    det = a * c - b * b
    ok = front & (det > 0) & alive
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), zero)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.where(ok, torch.ceil(3.0 * torch.sqrt(lam.detach())), zero).long()
    rgb = sh_color(xyz, params["f_dc"], params["f_rest"], cam["pos"].to(dt), degree)
    opacity = torch.sigmoid(params["opacity"])[:, 0]
    attr = torch.cat([torch.stack([mx, my, c * inv, -b * inv, a * inv], -1), rgb,
                      opacity[:, None]], -1)
    return attr, t[:, 2].detach(), radius


def tile_lists(attr, depth, radius, width: int, height: int):
    """Per-tile depth-ordered splat lists: (splat index per pair, each
    tile's first pair, each tile's count), tiles row-major."""
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    mx, my = attr[:, 0].detach().float(), attr[:, 1].detach().float()
    r = radius.float()
    x0 = torch.clamp(torch.floor((mx - r) / TILE), 0, tiles_x).long()
    y0 = torch.clamp(torch.floor((my - r) / TILE), 0, tiles_y).long()
    x1 = torch.clamp(torch.floor((mx + r + TILE - 1) / TILE), 0, tiles_x).long()
    y1 = torch.clamp(torch.floor((my + r + TILE - 1) / TILE), 0, tiles_y).long()
    count = torch.where(radius > 0, (x1 - x0) * (y1 - y0), 0)
    keep = torch.nonzero(count > 0)[:, 0]
    keep = keep[torch.sort(depth[keep].float(), stable=True).indices]
    cnt = count[keep]
    owner = torch.repeat_interleave(torch.arange(keep.numel(), device=attr.device), cnt)
    local = torch.arange(owner.numel(), device=attr.device) - (torch.cumsum(cnt, 0) - cnt)[owner]
    w = (x1 - x0)[keep][owner]
    tile = (y0[keep][owner] + local // w) * tiles_x + x0[keep][owner] + local % w
    order = torch.sort(tile, stable=True).indices
    counts = torch.bincount(tile, minlength=tiles_x * tiles_y)
    return keep[owner[order]], torch.cumsum(counts, 0) - counts, counts


def tile_groups(counts, pixels: int = TILE * TILE, budget: int = GROUP_ELEMENTS):
    """Tiles with splats, in groups of similar list length: [(tiles, longest)]."""
    c = counts.cpu()
    tiles = torch.nonzero(c > 0)[:, 0]
    tiles = tiles[torch.sort(c[tiles], stable=True).indices]
    groups, lo = [], 0
    lengths = c[tiles].tolist()
    while lo < len(lengths):
        hi = lo + 1
        while hi < len(lengths) and (hi + 1 - lo) * lengths[hi] * pixels <= budget:
            hi += 1
        groups.append((tiles[lo:hi], lengths[hi - 1]))
        lo = hi
    return groups


def composite_group(attr_pairs, valid, tiles, tiles_x: int, bg):
    """Colour [G, 256, 3] (+ T_final bg) of G tiles from their padded
    depth-ordered splat attributes [G, L, 9] (``valid`` [G, L])."""
    dev, dt = attr_pairs.device, attr_pairs.dtype
    p = torch.arange(TILE * TILE, device=dev)
    px = ((tiles % tiles_x)[:, None] * TILE + p % TILE).to(dt)[:, None, :]
    py = ((tiles // tiles_x)[:, None] * TILE + p // TILE).to(dt)[:, None, :]
    a = attr_pairs[..., None]  # [G, L, 9, 1]
    dx, dy = a[:, :, 0] - px, a[:, :, 1] - py
    power = -0.5 * (a[:, :, 2] * dx * dx + a[:, :, 4] * dy * dy) - a[:, :, 3] * dx * dy
    raw = a[:, :, 8] * torch.exp(power)
    alpha = raw - torch.clamp(raw - ALPHA_MAX, min=0.0).detach()  # capped, gradient passes
    use = valid[..., None] & (power <= 0.0) & (alpha >= ALPHA_SKIP)
    alpha = torch.where(use, alpha, torch.zeros_like(alpha))
    keep = 1.0 - alpha
    t_after = torch.cumprod(keep, dim=1)
    t_before = torch.cat([torch.ones_like(t_after[:, :1]), t_after[:, :-1]], 1)
    stop = use & (t_after < T_EPS)
    live = use & (torch.cumsum(stop.to(torch.int32), 1) == 0)
    weight = torch.where(live, alpha * t_before, torch.zeros_like(alpha))
    color = weight.transpose(1, 2) @ attr_pairs[:, :, 5:8]
    t_final = torch.prod(torch.where(live, keep, torch.ones_like(keep)), dim=1)
    return color + t_final[..., None] * bg.to(dt)


def _group_inputs(g_tiles, longest, first, counts, order):
    dev = order.device
    g_tiles = g_tiles.to(dev)
    j = torch.arange(longest, device=dev)
    valid = j[None, :] < counts[g_tiles][:, None]
    pos = torch.where(valid, first[g_tiles][:, None] + j, 0)
    return g_tiles, valid, order[pos]


def render(params: dict, alive, cam: dict, degree: int, bg):
    """The [3, H, W] image of one view, without gradients."""
    with torch.no_grad():
        attr, depth, radius = project(params, alive, cam, degree)
        order, first, counts = tile_lists(attr, depth, radius, cam["width"], cam["height"])
        return _composite(attr, order, first, counts, cam, bg)


def _composite(attr, order, first, counts, cam, bg):
    w, h = cam["width"], cam["height"]
    tiles_x = -(-w // TILE)
    tiles_y = -(-h // TILE)
    dev, dt = attr.device, attr.dtype
    full = torch.empty(tiles_y * tiles_x, TILE * TILE, 3, dtype=dt, device=dev)
    full[:] = bg.to(dt)  # tiles no splat reaches show the background
    for g_tiles, longest in tile_groups(counts):
        g_tiles, valid, idx = _group_inputs(g_tiles, longest, first, counts, order)
        full[g_tiles] = composite_group(attr[idx], valid, g_tiles, tiles_x, bg)
    img = full.reshape(tiles_y, tiles_x, TILE, TILE, 3).permute(4, 0, 2, 1, 3)
    return img.reshape(3, tiles_y * TILE, tiles_x * TILE)[:, :h, :w]


def ssim(img1, img2):
    """Mean SSIM of two [3, H, W] images (11x11 Gaussian window, sigma 1.5)."""
    g = torch.exp(-((torch.arange(11, dtype=torch.float64) - 5) ** 2) / (2 * 1.5 ** 2))
    g = g / g.sum()
    win = (g[:, None] @ g[None, :]).to(img1.dtype).to(img1.device)
    win = win.expand(3, 1, 11, 11).contiguous()

    def blur(x):
        return F.conv2d(x[None], win, padding=5, groups=3)[0]

    mu1, mu2 = blur(img1), blur(img2)
    s11 = blur(img1 * img1) - mu1 * mu1
    s22 = blur(img2 * img2) - mu2 * mu2
    s12 = blur(img1 * img2) - mu1 * mu2
    num = (2 * mu1 * mu2 + SSIM_C1) * (2 * s12 + SSIM_C2)
    den = (mu1 * mu1 + mu2 * mu2 + SSIM_C1) * (s11 + s22 + SSIM_C2)
    return (num / den).mean()


def photometric_loss(img, gt, lambda_dssim: float = 0.2):
    return (1.0 - lambda_dssim) * (img - gt).abs().mean() + lambda_dssim * (1.0 - ssim(img, gt))


def loss_and_grads(params: dict, alive, cam: dict, degree: int, bg, gt,
                   lambda_dssim: float = 0.2):
    """(loss, {group: gradient}) of one view, by groups of tiles."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        attr_full, depth, radius = project(leaves, alive, cam, degree)
    attr = attr_full.detach().requires_grad_()
    with torch.no_grad():
        order, first, counts = tile_lists(attr, depth, radius, cam["width"], cam["height"])
        img = _composite(attr, order, first, counts, cam, bg)
    img = img.detach().requires_grad_()
    with torch.enable_grad():
        loss = photometric_loss(img, gt.to(img.dtype), lambda_dssim)
        (g_img,) = torch.autograd.grad(loss, [img])
    w, h = cam["width"], cam["height"]
    tiles_x, tiles_y = -(-w // TILE), -(-h // TILE)
    g_pad = F.pad(g_img, (0, tiles_x * TILE - w, 0, tiles_y * TILE - h))
    g_tiles_img = g_pad.reshape(3, tiles_y, TILE, tiles_x, TILE).permute(1, 3, 2, 4, 0)
    g_tiles_img = g_tiles_img.reshape(tiles_y * tiles_x, TILE * TILE, 3)
    for g_tiles, longest in tile_groups(counts):
        g_tiles, valid, idx = _group_inputs(g_tiles, longest, first, counts, order)
        with torch.enable_grad():
            out = composite_group(attr[idx], valid, g_tiles, tiles_x, bg)
            out.backward(g_tiles_img[g_tiles])
    with torch.enable_grad():
        attr_full.backward(attr.grad if attr.grad is not None else torch.zeros_like(attr))
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)) for k, v in leaves.items()}
    return loss.detach(), grads


def expon_lr(step: int, lr_init: float, lr_final: float, max_steps: int) -> float:
    """The published log-linear position learning rate at ``step``."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def adam(params: dict, grads: dict, mu: dict, nu: dict, steps: dict, lrs: dict):
    """torch.optim.Adam's update, eps 1e-15: new (params, mu, nu, steps)."""
    new_p, new_mu, new_nu, new_steps = {}, {}, {}, {}
    for k, p in params.items():
        t = steps[k] + 1
        m = BETA1 * mu[k] + (1 - BETA1) * grads[k]
        v = BETA2 * nu[k] + (1 - BETA2) * grads[k] * grads[k]
        bc1 = 1 - BETA1 ** t
        bc2 = 1 - BETA2 ** t
        new_p[k] = p - (lrs[k] / bc1) * m / (torch.sqrt(v) / math.sqrt(bc2) + ADAM_EPS)
        new_mu[k], new_nu[k], new_steps[k] = m, v, t
    return new_p, new_mu, new_nu, new_steps


def to_bytes(img) -> torch.Tensor:
    """The viewer's frame: clip to [0, 1], * 255, truncated to uint8, [H, W, 3]."""
    return (torch.clamp(img.float(), 0.0, 1.0) * 255.0).to(torch.uint8).permute(1, 2, 0)
