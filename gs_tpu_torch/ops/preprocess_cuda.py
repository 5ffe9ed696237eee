"""The per-Gaussian preprocess as two hand-written kernels: its forward and its VJP.

The preprocess is ``projection.compute_cov3d`` (covariance from log_scale
and quat, with the scaling modifier) -> ``projection.project_gaussians``
(the EWA projection to means2d, depths, conics, radii and the valid mask)
-> ``projection.sh_colors`` (SH colours at the active degree). Written in
plain PyTorch (``plain_forward``) it runs some 150 elementwise, cat, select
and GEMV kernels, and left to autograd it records a tape of them at every
step. Here:

- ``preprocess_fwd`` (the forward's wrapper) launches
  ``csrc/preprocess_fwd.cu`` on CUDA tensors
  (``cuda_build.LAUNCHES["preprocess_fwd"]`` counts it) and runs
  ``plain_forward`` on CPU tensors; it never falls back. The default
  route's forward, with or without a gradient to take.
- ``preprocess_bwd`` (the VJP's wrapper) launches ``csrc/preprocess_bwd.cu``
  on CUDA tensors (``cuda_build.LAUNCHES["preprocess_bwd"]`` counts it) and
  runs ``preprocess_bwd_torch``, the plain PyTorch version of the same
  closed-form VJP, on CPU tensors; it never falls back.
- ``PreprocessFn`` joins them as one autograd Function. The contract of
  its backward is ``torch.autograd.grad`` of the plain route, with
  autograd's subgradients: a clamp passes the gradient on its closed
  interval (x/z and y/z at +-1.3 tan(fov/2), ``rgb + 0.5 >= 0``, the view
  direction's norm at 1e-12), ``torch.where(valid, ...)`` gives exactly 0
  outside ``valid``, and the coefficients past the active degree and the
  view direction at degree 0 get exact zeros. ``valid`` is the forward's
  own mask, kept for the backward (1 byte a Gaussian; nothing else
  per-Gaussian is kept beyond the leaves).

Both kernels compute the forward's quantities by the same device functions
(``csrc/preprocess_forward.cuh``). They replace no gs_tpu kernel: gs_tpu
leaves this stage to XLA, which fuses the forward, and its VJP to XLA's
autodiff.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from gs_tpu_torch.cameras import Camera
from gs_tpu_torch.ops import cuda_build, projection, transforms
from gs_tpu_torch.ops import sh as sh_ops
from gs_tpu_torch.utils import profiling

INDEX_LIMIT = 1 << 31  # the kernel indexes Gaussians in int32
MAX_REST = sh_ops.num_sh_coeffs(sh_ops.MAX_DEGREE) - 1


LEAF_NAMES = ("xyz", "log_scale", "quat", "f_dc", "f_rest")  # PreprocessFn's inputs


def _check_leaves(leaves, camera: Camera, degree: int, what: str) -> None:
    """Raise ValueError unless the leaves are float32 tensors of the
    expected shapes for ``degree``, on one device with the camera's."""
    xyz, log_scale, quat, f_dc, f_rest = leaves
    n = xyz.shape[0] if xyz.dim() == 2 else -1
    shapes = {"xyz": (n, 3), "log_scale": (n, 3), "quat": (n, 4), "f_dc": (n, 1, 3)}
    for name, t in zip(LEAF_NAMES[:4], leaves[:4]):
        if t.dtype != torch.float32 or tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be float32 {shapes[name]}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    sh_ops._check_degree(degree)
    k = sh_ops.num_sh_coeffs(degree)
    if (f_rest.dtype != torch.float32 or f_rest.dim() != 3 or f_rest.shape[0] != n
            or f_rest.shape[2] != 3 or not k - 1 <= f_rest.shape[1] <= MAX_REST):
        raise ValueError(f"f_rest must be float32 [{n}, R, 3] with {k - 1} <= R <= {MAX_REST}, "
                         f"got {f_rest.dtype} {tuple(f_rest.shape)}")
    if n >= INDEX_LIMIT:
        raise ValueError(f"{n} Gaussians do not fit the kernel's int32 indices (limit 2^31)")
    dev = xyz.device
    for t in (*leaves, camera.view, camera.full_proj, camera.cam_pos, camera.tan_fovx,
              camera.tan_fovy):
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} takes CUDA or CPU tensors, got {dev}")


def _check_inputs(leaves, camera: Camera, degree: int, valid, cots, g_depths) -> None:
    """Raise ValueError unless the VJP's inputs are float32 (valid: bool)
    tensors of the expected shapes, all on one device."""
    _check_leaves(leaves, camera, degree, "preprocess_bwd")
    n, dev = leaves[0].shape[0], leaves[0].device
    if valid.dtype != torch.bool or tuple(valid.shape) != (n,):
        raise ValueError(f"valid must be bool [{n}], got {valid.dtype} {tuple(valid.shape)}")
    for name, t, c in zip(("g_means2d", "g_conics", "g_colors"), cots, (2, 3, 3)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n, c):
            raise ValueError(f"{name} must be float32 ({n}, {c}), got {t.dtype} "
                             f"{tuple(t.shape)}")
    if g_depths is not None and (g_depths.dtype != torch.float32
                                 or tuple(g_depths.shape) != (n,)):
        raise ValueError(f"g_depths must be float32 ({n},), got {g_depths.dtype} "
                         f"{tuple(g_depths.shape)}")
    for t in (valid, *cots, *(() if g_depths is None else (g_depths,))):
        if t.device != dev:
            raise ValueError(f"preprocess_bwd: tensors on {t.device} and {dev}")


def _kernel_inputs(leaves, camera: Camera, scaling_modifier):
    """The leaves and the camera's tensors as both kernels read them:
    contiguous, the quaternion 16-byte aligned (each kernel reads it as one
    float4), and the scaling modifier a float32 tensor on the card (a fill,
    not a copy from the host)."""
    dev = leaves[0].device
    leaves = [t.contiguous() for t in leaves]
    if leaves[2].data_ptr() % 16:
        leaves[2] = leaves[2].clone()
    if not isinstance(scaling_modifier, torch.Tensor):
        scaling_modifier = torch.full((), scaling_modifier, dtype=torch.float32, device=dev)
    cam = [t.contiguous() for t in (camera.view, camera.full_proj, camera.cam_pos,
                                    camera.tan_fovx, camera.tan_fovy,
                                    scaling_modifier.to(dev, torch.float32))]
    return leaves, cam


def _sh_basis_vjp(deg: int, d: torch.Tensor, gb: list) -> torch.Tensor:
    """The cotangents ``gb[k]`` [N] of the basis polynomials of
    ``sh.eval_sh_basis`` carried to the unit direction ``d`` [N, 3]:
    [N, 3], the kernel's closed forms."""
    c1, c2, c3, c4 = sh_ops.C1, sh_ops.C2, sh_ops.C3, sh_ops.C4
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    gx = -c1 * gb[3]
    gy = -c1 * gb[1]
    gz = c1 * gb[2]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        gx = gx + (c2[0] * y * gb[4] - 2.0 * c2[2] * x * gb[6] + c2[3] * z * gb[7]
                   + 2.0 * c2[4] * x * gb[8])
        gy = gy + (c2[0] * x * gb[4] + c2[1] * z * gb[5] - 2.0 * c2[2] * y * gb[6]
                   - 2.0 * c2[4] * y * gb[8])
        gz = gz + (c2[1] * y * gb[5] + 4.0 * c2[2] * z * gb[6] + c2[3] * x * gb[7])
        if deg > 2:
            gx = gx + (c3[0] * 6.0 * xy * gb[9] + c3[1] * yz * gb[10]
                       - c3[2] * 2.0 * xy * gb[11] - c3[3] * 6.0 * xz * gb[12]
                       + c3[4] * (4.0 * zz - 3.0 * xx - yy) * gb[13]
                       + c3[5] * 2.0 * xz * gb[14] + c3[6] * 3.0 * (xx - yy) * gb[15])
            gy = gy + (c3[0] * 3.0 * (xx - yy) * gb[9] + c3[1] * xz * gb[10]
                       + c3[2] * (4.0 * zz - xx - 3.0 * yy) * gb[11]
                       - c3[3] * 6.0 * yz * gb[12] - c3[4] * 2.0 * xy * gb[13]
                       - c3[5] * 2.0 * yz * gb[14] - c3[6] * 6.0 * xy * gb[15])
            gz = gz + (c3[1] * xy * gb[10] + c3[2] * 8.0 * yz * gb[11]
                       + c3[3] * 3.0 * (2.0 * zz - xx - yy) * gb[12]
                       + c3[4] * 8.0 * xz * gb[13] + c3[5] * (xx - yy) * gb[14])
        if deg > 3:
            gx = gx + (c4[0] * y * (3.0 * xx - yy) * gb[16] + c4[1] * 6.0 * xy * z * gb[17]
                       + c4[2] * y * (7.0 * zz - 1.0) * gb[18]
                       + c4[5] * z * (7.0 * zz - 3.0) * gb[21]
                       + c4[6] * 2.0 * x * (7.0 * zz - 1.0) * gb[22]
                       + c4[7] * 3.0 * z * (xx - yy) * gb[23]
                       + c4[8] * 4.0 * x * (xx - 3.0 * yy) * gb[24])
            gy = gy + (c4[0] * x * (xx - 3.0 * yy) * gb[16]
                       + c4[1] * 3.0 * z * (xx - yy) * gb[17]
                       + c4[2] * x * (7.0 * zz - 1.0) * gb[18]
                       + c4[3] * z * (7.0 * zz - 3.0) * gb[19]
                       - c4[6] * 2.0 * y * (7.0 * zz - 1.0) * gb[22]
                       - c4[7] * 6.0 * xy * z * gb[23]
                       + c4[8] * 4.0 * y * (yy - 3.0 * xx) * gb[24])
            gz = gz + (c4[1] * y * (3.0 * xx - yy) * gb[17] + c4[2] * 14.0 * xy * z * gb[18]
                       + c4[3] * y * (21.0 * zz - 3.0) * gb[19]
                       + c4[4] * z * (140.0 * zz - 60.0) * gb[20]
                       + c4[5] * x * (21.0 * zz - 3.0) * gb[21]
                       + c4[6] * 14.0 * z * (xx - yy) * gb[22]
                       + c4[7] * x * (xx - 3.0 * yy) * gb[23])
    return torch.stack([gx, gy, gz], dim=-1)


def _colour_vjp(xyz, f_dc, f_rest, cam_pos, degree, g_colors):
    """(g_xyz from the view direction, g_f_dc, g_f_rest) of ``sh_colors``."""
    k = sh_ops.num_sh_coeffs(degree)
    dirs = xyz - cam_pos
    nrm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
    nc = nrm.clamp(min=1e-12)
    d = dirs / nc
    basis = torch.cat(sh_ops.eval_sh_basis(degree, d), dim=-1)  # [N, K]
    feats = torch.cat([f_dc, f_rest], dim=1)[:, :k]  # [N, K, 3]
    rgb = torch.einsum("nk,nkc->nc", basis, feats)  # the forward's, bit for bit
    g_rgb = torch.where(rgb + 0.5 >= 0.0, g_colors, 0.0)
    g_feats = basis[:, :, None] * g_rgb[:, None, :]  # [N, K, 3]
    g_f_dc = g_feats[:, :1]
    g_f_rest = torch.zeros_like(f_rest)
    g_f_rest[:, :k - 1] = g_feats[:, 1:]
    if degree == 0:  # the basis is a constant: the direction gets nothing
        return torch.zeros_like(xyz), g_f_dc, g_f_rest
    g_basis = (feats * g_rgb[:, None, :]).sum(-1)  # [N, K]
    g_d = _sh_basis_vjp(degree, d, list(g_basis.unbind(-1)))
    g_dirs = g_d / nc
    g_nc = -(g_d * (d / nc)).sum(-1, keepdim=True)
    g_dirs = g_dirs + torch.where(nrm >= 1e-12, dirs * (g_nc / nrm), 0.0)
    return g_dirs, g_f_dc, g_f_rest


def preprocess_bwd_torch(xyz, log_scale, quat, f_dc, f_rest, camera: Camera,
                         scaling_modifier, degree: int, valid, g_means2d, g_conics, g_colors,
                         g_depths=None):
    """Plain version of the VJP (the kernel's reference, and the CPU path):
    the forward quantities recomputed by the plain route's own calls (so the
    culls and clamps decide as the forward did), then the chain rule in
    closed form, as ``csrc/preprocess_bwd.cu`` takes it. Returns the
    gradients of (xyz, log_scale, quat, f_dc, f_rest)."""
    _check_inputs((xyz, log_scale, quat, f_dc, f_rest), camera, degree, valid,
                  (g_means2d, g_conics, g_colors), g_depths)
    g_xyz, g_f_dc, g_f_rest = _colour_vjp(xyz, f_dc, f_rest, camera.cam_pos, degree, g_colors)

    # covariance: scale = exp(log_scale) * modifier, R from the unit quaternion
    e = torch.exp(log_scale)
    s = e * scaling_modifier
    s2 = s * s
    qn = torch.linalg.norm(quat, dim=-1, keepdim=True)
    q = quat / qn
    r = transforms.quat_to_rotmat(quat)  # [N, 3, 3]

    # the forward's covariance, camera-space centres and 2D covariance, bit for bit
    cov3d = transforms.build_covariance_packed(s, quat)
    proj, w_rot = camera.full_proj, camera.view[:3, :3]
    ew = projection.ewa(xyz, cov3d, camera)
    t, tz, txz, tyz, t0, t1 = ew.t, ew.tz, ew.txz, ew.tyz, ew.t0, ew.t1
    c_xx, c_xy, c_yy = ew.c_xx, ew.c_xy, ew.c_yy
    focal_x, focal_y = camera.focal_x, camera.focal_y
    lim_x, lim_y = 1.3 * camera.tan_fovx, 1.3 * camera.tan_fovy
    ux, uy = t[:, 0] / tz, t[:, 1] / tz
    inv_tz = 1.0 / tz
    inv_det = 1.0 / torch.where(valid, ew.det, 1.0)
    sig = transforms.unpack_symmetric(cov3d)
    st0 = (sig * t0[:, None, :]).sum(-1)  # Sigma t0
    st1 = (sig * t1[:, None, :]).sum(-1)

    # conics = (c_yy, -c_xy, c_xx) * inv_det
    gc0, gc1, gc2 = g_conics.unbind(-1)
    g_inv_det = gc0 * c_yy + gc1 * -c_xy + gc2 * c_xx
    g_det = -g_inv_det * (inv_det * inv_det)
    g_cxx = gc2 * inv_det + g_det * c_yy
    g_cyy = gc0 * inv_det + g_det * c_xx
    g_cxy = -(gc1 * inv_det) - 2.0 * (g_det * c_xy)

    # the 2D covariance: Sigma's cotangent g_sig (a packed entry off the diagonal
    # is the sum of its two places) and T's
    outer = lambda a, b: a[:, :, None] * b[:, None, :]  # noqa: E731
    g_sig = (g_cxx[:, None, None] * outer(t0, t0) + g_cxy[:, None, None] * outer(t0, t1)
             + g_cyy[:, None, None] * outer(t1, t1))
    gt0 = 2.0 * g_cxx[:, None] * st0 + g_cxy[:, None] * st1
    gt1 = g_cxy[:, None] * st0 + 2.0 * g_cyy[:, None] * st1
    g_j00, g_j02 = (gt0 * w_rot[0]).sum(-1), (gt0 * w_rot[2]).sum(-1)
    g_j11, g_j12 = (gt1 * w_rot[1]).sum(-1), (gt1 * w_rot[2]).sum(-1)
    g_inv_tz = g_j00 * focal_x + g_j02 * (-focal_x * txz) + g_j11 * focal_y \
        + g_j12 * (-focal_y * tyz)
    # the clamps pass the gradient on their closed intervals
    g_ux = torch.where((ux >= -lim_x) & (ux <= lim_x), g_j02 * inv_tz * -focal_x, 0.0)
    g_uy = torch.where((uy >= -lim_y) & (uy <= lim_y), g_j12 * inv_tz * -focal_y, 0.0)
    g_tz = -g_inv_tz * (inv_tz * inv_tz) - g_ux * (ux / tz) - g_uy * (uy / tz)
    if g_depths is not None:
        g_tz = g_tz + g_depths
    g_t = torch.stack([g_ux / tz, g_uy / tz, g_tz], dim=-1)

    # means2d = ((p_xy / (p_w + 1e-7) + 1) * (W, H) - 1) / 2
    p_hom = xyz @ proj[:, :3].T + proj[:, 3]
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    g_ndc_x = g_means2d[:, 0] * 0.5 * camera.width
    g_ndc_y = g_means2d[:, 1] * 0.5 * camera.height
    g_ph3 = -(g_ndc_x * p_hom[:, 0] + g_ndc_y * p_hom[:, 1]) * (p_w * p_w)
    g_ph = torch.stack([g_ndc_x * p_w, g_ndc_y * p_w, g_ph3], dim=-1)
    g_proj_xyz = g_t @ w_rot + g_ph @ proj[[0, 1, 3], :3]

    # Sigma = R diag(s2) R^T -> s2 and R; then log_scale and the quaternion
    g_r = torch.einsum("nij,njk,nk->nik", g_sig + g_sig.transpose(1, 2), r, s2)
    g_s2 = torch.einsum("nij,nik,njk->nk", g_sig, r, r)
    g_log_scale = 2.0 * s * g_s2 * scaling_modifier * e
    w, x, y, z = q.unbind(-1)
    gr = g_r.reshape(-1, 9).unbind(-1)  # row-major R_ij
    g_q = torch.stack([
        2.0 * (-z * gr[1] + y * gr[2] + z * gr[3] - x * gr[5] - y * gr[6] + x * gr[7]),
        2.0 * (y * gr[1] + z * gr[2] + y * gr[3] - 2.0 * x * gr[4] - w * gr[5] + z * gr[6]
               + w * gr[7] - 2.0 * x * gr[8]),
        2.0 * (-2.0 * y * gr[0] + x * gr[1] + w * gr[2] + x * gr[3] + z * gr[5] - w * gr[6]
               + z * gr[7] - 2.0 * y * gr[8]),
        2.0 * (-2.0 * z * gr[0] - w * gr[1] + x * gr[2] + w * gr[3] - 2.0 * z * gr[4]
               + y * gr[5] + x * gr[6] + y * gr[7]),
    ], dim=-1)
    g_qn = -(g_q * (q / qn)).sum(-1, keepdim=True)
    g_quat = g_q / qn + quat * (g_qn / qn)

    culled = ~valid[:, None]
    g_xyz = g_xyz + torch.where(culled, 0.0, g_proj_xyz)
    return (g_xyz, torch.where(culled, 0.0, g_log_scale), torch.where(culled, 0.0, g_quat),
            g_f_dc, g_f_rest)


def preprocess_bwd(xyz, log_scale, quat, f_dc, f_rest, camera: Camera, scaling_modifier,
                   degree: int, valid, g_means2d, g_conics, g_colors, g_depths=None):
    """Gradients of (xyz, log_scale, quat, f_dc, f_rest) through the
    preprocess, from the cotangents of means2d [N,2], conics [N,3], colours
    [N,3] and, if not None, depths [N]; ``valid`` [N] is the forward's mask.
    The kernel on CUDA tensors, the plain version on CPU tensors."""
    leaves = (xyz, log_scale, quat, f_dc, f_rest)
    cots = (g_means2d, g_conics, g_colors)
    _check_inputs(leaves, camera, degree, valid, cots, g_depths)
    if xyz.device.type == "cpu":
        return preprocess_bwd_torch(*leaves, camera, scaling_modifier, degree, valid, *cots,
                                    g_depths)
    dev = xyz.device
    leaves, cam = _kernel_inputs(leaves, camera, scaling_modifier)
    cots = [t.contiguous() for t in cots]
    g_depths = None if g_depths is None else g_depths.contiguous()
    valid = valid.contiguous()
    grads = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in leaves]
    n = xyz.shape[0]
    if n:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            cuda_build.launch(
                "preprocess_bwd", *(t.data_ptr() for t in (*leaves, *cam, valid, *cots)),
                None if g_depths is None else g_depths.data_ptr(),
                *(t.data_ptr() for t in grads), n, f_rest.shape[1] * 3, degree, camera.width,
                camera.height, stream)
    return tuple(grads)


def plain_forward(xyz, log_scale, quat, f_dc, f_rest, camera: Camera, scaling_modifier,
                  degree: int):
    """(ProjectedSplats, colours) by the plain route, under the spans
    ``gs.render.project`` (covariance and projection) and ``gs.render.sh``."""
    with profiling.annotate("gs.render.project"):
        cov3d = projection.compute_cov3d(log_scale, quat, scaling_modifier)
        sp = projection.project_gaussians(xyz, cov3d, camera)
    with profiling.annotate("gs.render.sh"):
        colors = projection.sh_colors(xyz, f_dc, f_rest, camera.cam_pos, degree)
    return sp, colors


def preprocess_fwd(xyz, log_scale, quat, f_dc, f_rest, camera: Camera, scaling_modifier,
                   degree: int):
    """(ProjectedSplats, colours) of the preprocess: the kernel on CUDA
    tensors (one launch), ``plain_forward`` on CPU tensors."""
    leaves = (xyz, log_scale, quat, f_dc, f_rest)
    _check_leaves(leaves, camera, degree, "preprocess_fwd")
    if xyz.device.type == "cpu":
        return plain_forward(*leaves, camera, scaling_modifier, degree)
    dev = xyz.device
    leaves, cam = _kernel_inputs(leaves, camera, scaling_modifier)
    n = xyz.shape[0]
    empty = lambda *shape, dtype=torch.float32: torch.empty(  # noqa: E731
        shape, dtype=dtype, device=dev)
    sp = projection.ProjectedSplats(means2d=empty(n, 2), depths=empty(n), conics=empty(n, 3),
                                    radii=empty(n, dtype=torch.int32),
                                    mask=empty(n, dtype=torch.bool))
    colors = empty(n, 3)
    if n:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            cuda_build.launch(
                "preprocess_fwd", *(t.data_ptr() for t in (*leaves, *cam, *sp, colors)), n,
                f_rest.shape[1] * 3, degree, camera.width, camera.height, stream)
    return sp, colors


class PreprocessFn(torch.autograd.Function):
    """The default route's preprocess where autograd needs a gradient:
    forward by ``preprocess_fwd`` (no tape), backward by ``preprocess_bwd``
    under the span ``gs.backward.preprocess``.
    Returns (means2d, depths, conics, radii, mask, colours); radii and mask
    are not differentiable."""

    @staticmethod
    def forward(ctx, xyz, log_scale, quat, f_dc, f_rest, camera: Camera, scaling_modifier,
                degree: int):
        sp, colors = preprocess_fwd(xyz, log_scale, quat, f_dc, f_rest, camera,
                                    scaling_modifier, degree)
        ctx.mark_non_differentiable(sp.radii, sp.mask)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xyz, log_scale, quat, f_dc, f_rest, sp.mask)
        ctx.camera, ctx.scaling_modifier, ctx.degree = camera, scaling_modifier, degree
        return sp.means2d, sp.depths, sp.conics, sp.radii, sp.mask, colors

    @staticmethod
    @once_differentiable
    def backward(ctx, g_means2d, g_depths, g_conics, _g_radii, _g_mask, g_colors):
        with profiling.annotate("gs.backward.preprocess"):
            xyz, log_scale, quat, f_dc, f_rest, valid = ctx.saved_tensors
            n = xyz.shape[0]
            zeros = lambda c: xyz.new_zeros((n, c))  # noqa: E731
            grads = preprocess_bwd(
                xyz, log_scale, quat, f_dc, f_rest, ctx.camera, ctx.scaling_modifier,
                ctx.degree, valid, zeros(2) if g_means2d is None else g_means2d,
                zeros(3) if g_conics is None else g_conics,
                zeros(3) if g_colors is None else g_colors, g_depths)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None, None)


def preprocess(xyz, log_scale, quat, f_dc, f_rest, camera: Camera, scaling_modifier,
               degree: int):
    """(ProjectedSplats, colours) of the default route: through
    ``PreprocessFn`` where autograd needs a gradient of a leaf, else
    ``preprocess_fwd`` alone."""
    leaves = (xyz, log_scale, quat, f_dc, f_rest)
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        means2d, depths, conics, radii, mask, colors = PreprocessFn.apply(
            *leaves, camera, scaling_modifier, degree)
        return projection.ProjectedSplats(means2d, depths, conics, radii, mask), colors
    return preprocess_fwd(*leaves, camera, scaling_modifier, degree)
