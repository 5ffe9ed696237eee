"""gs_tpu_torch leaf math against its gs_tpu twins on the CPU.

Transforms, SH (degrees 0-4), cameras (with ``stack_cameras``), projection
(with bin_radii), the 3-NN scale init and state creation: the same numpy
inputs go through the
jax function and the port's, at rtol 1e-5 / atol 1e-5 (1e-4 px for
means2d); integer radii must be equal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_tpu import cameras as j_cameras
from gs_tpu.models import gaussians as j_gaussians
from gs_tpu.ops import knn as j_knn
from gs_tpu.ops import projection as j_projection
from gs_tpu.ops import sh as j_sh
from gs_tpu.ops import transforms as j_transforms
from gs_tpu_torch import cameras, interop
from gs_tpu_torch.models import gaussians
from gs_tpu_torch.ops import knn, projection, sh, transforms
from tests.torch_port_inputs import camera_args, camera_dict, scene_arrays

TOL = dict(rtol=1e-5, atol=1e-5)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(1)


@pytest.fixture(scope="module")
def quats(rng):
    return rng.normal(0, 1, (257, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def scales(rng):
    return np.exp(rng.uniform(-4, 0, (257, 3))).astype(np.float32)


# --- transforms --------------------------------------------------------------


def test_quat_to_rotmat(quats):
    close(transforms.quat_to_rotmat(torch.from_numpy(quats)),
          j_transforms.quat_to_rotmat(jnp.asarray(quats)))


@pytest.mark.parametrize("packed", [False, True])
def test_build_covariance(quats, scales, packed):
    s, q = torch.from_numpy(scales), torch.from_numpy(quats)
    js, jq = jnp.asarray(scales), jnp.asarray(quats)
    if packed:
        close(transforms.build_covariance_packed(s, q),
              j_transforms.build_covariance_packed(js, jq))
    else:
        close(transforms.build_covariance(s, q), j_transforms.build_covariance(js, jq))


def test_pack_unpack_symmetric(quats, scales):
    cov = j_transforms.build_covariance(jnp.asarray(scales), jnp.asarray(quats))
    packed = transforms.pack_symmetric(torch.from_numpy(np.array(cov)))
    close(packed, j_transforms.pack_symmetric(cov))
    close(transforms.unpack_symmetric(packed), cov)


def test_inverse_sigmoid(rng):
    x = rng.uniform(0.01, 0.99, 100).astype(np.float32)
    close(transforms.inverse_sigmoid(torch.from_numpy(x)), j_transforms.inverse_sigmoid(x))


# --- spherical harmonics -------------------------------------------------------


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh(rng, deg):
    dirs = rng.normal(0, 1, (300, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    coeffs = rng.normal(0, 1, (300, 3, 16)).astype(np.float32)
    close(sh.eval_sh(deg, torch.from_numpy(coeffs), torch.from_numpy(dirs)),
          j_sh.eval_sh(deg, jnp.asarray(coeffs), jnp.asarray(dirs)))
    basis = torch.cat(sh.eval_sh_basis(deg, torch.from_numpy(dirs)), dim=-1)
    close(basis, jnp.concatenate(j_sh.eval_sh_basis(deg, jnp.asarray(dirs)), axis=-1))


def test_sh_rgb_roundtrip(rng):
    rgb = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    close(sh.rgb_to_sh(torch.from_numpy(rgb)), j_sh.rgb_to_sh(jnp.asarray(rgb)))
    close(sh.sh_to_rgb(sh.rgb_to_sh(torch.from_numpy(rgb))), rgb)


def test_sh_degree_out_of_range():
    """Degrees 0..4 are in range, as in gs_tpu; 5 and -1 raise in both."""
    for deg in (5, -1):
        with pytest.raises(ValueError):
            sh.eval_sh(deg, torch.zeros(2, 3, 36), torch.zeros(2, 3))
        with pytest.raises(ValueError):
            j_sh.eval_sh(deg, jnp.zeros((2, 3, 36)), jnp.zeros((2, 3)))


# --- cameras -------------------------------------------------------------------


def test_fov_helpers():
    assert cameras.fov_to_focal(1.1, 640) == j_cameras.fov_to_focal(1.1, 640)
    assert cameras.focal_to_fov(500.0, 640) == j_cameras.focal_to_fov(500.0, 640)


@pytest.mark.parametrize("translate,scale", [(None, 1.0), (np.array([0.3, -1.0, 2.0]), 0.7)])
def test_camera_matrices(rng, translate, scale):
    q = rng.normal(0, 1, 4)
    R = np.asarray(j_transforms.quat_to_rotmat(jnp.asarray(q, jnp.float32)))
    T = rng.normal(0, 2, 3)
    kw = dict(fovx=1.2, fovy=0.8, width=61, height=47, translate=translate, scale=scale)
    cam = cameras.make_camera(R, T, **kw, device="cpu")
    ref = j_cameras.make_camera(R, T, **kw)
    for field in ("view", "full_proj", "cam_pos", "tan_fovx", "tan_fovy", "znear", "zfar"):
        close(getattr(cam, field), getattr(ref, field))
    close(cam.focal_x, ref.focal_x)
    close(cam.focal_y, ref.focal_y)
    np.testing.assert_array_equal(cameras.make_projection_matrix(0.01, 100.0, 1.2, 0.8),
                                  j_cameras.make_projection_matrix(0.01, 100.0, 1.2, 0.8))


@pytest.mark.parametrize("with_images", ["all", "some"])
def test_stack_cameras(rng, with_images):
    """tests/test_math_core.py::test_stack_cameras's case (64x48, z=4, fov 60 x
    45 deg) with a second, moved camera: every field stacked as gs_tpu's,
    images only when every camera has one."""
    args = [dict(R=np.eye(3), T=np.array([0.0, 0.0, 4.0]), fovx=math.radians(60),
                 fovy=math.radians(45), width=64, height=48),
            dict(R=np.eye(3), T=np.array([0.5, -0.2, 4.5]), fovx=math.radians(50),
                 fovy=math.radians(40), width=64, height=48)]
    images = [rng.uniform(0, 1, (3, 48, 64)).astype(np.float32) for _ in args]
    if with_images == "some":
        images[1] = None
    cams = [cameras.make_camera(**a, image=im, device="cpu") for a, im in zip(args, images)]
    jcams = [j_cameras.make_camera(**a, image=im) for a, im in zip(args, images)]
    batch, jbatch = cameras.stack_cameras(cams), j_cameras.stack_cameras(jcams)
    assert batch.view.shape == (2, 4, 4) and (batch.width, batch.height) == (64, 48)
    for field in ("view", "full_proj", "cam_pos", "tan_fovx", "tan_fovy", "znear", "zfar"):
        assert getattr(batch, field).shape == getattr(jbatch, field).shape, field
        np.testing.assert_array_equal(getattr(batch, field).numpy(),
                                      np.asarray(getattr(jbatch, field)), err_msg=field)
    if with_images == "all":
        np.testing.assert_array_equal(batch.image.numpy(), np.stack(images))
        np.testing.assert_array_equal(np.asarray(jbatch.image), np.stack(images))
    else:
        assert batch.image is None and jbatch.image is None


def test_stack_cameras_errors():
    with pytest.raises(ValueError, match="empty camera list"):
        cameras.stack_cameras([])
    with pytest.raises(ValueError, match="empty camera list"):
        j_cameras.stack_cameras([])
    kw = dict(R=np.eye(3), T=np.array([0.0, 0.0, 4.0]), fovx=1.0, fovy=0.8)
    mixed = [dict(kw, width=64, height=48), dict(kw, width=32, height=48)]
    with pytest.raises(ValueError, match="uniform resolution"):
        cameras.stack_cameras([cameras.make_camera(**a, device="cpu") for a in mixed])
    with pytest.raises(ValueError, match="uniform resolution"):
        j_cameras.stack_cameras([j_cameras.make_camera(**a) for a in mixed])


# --- projection ---------------------------------------------------------------


@pytest.fixture(scope="module", params=[(61, 47), (64, 64)], ids=["61x47", "64x64"])
def projected(request):
    """Both packages' projection of one scene: (port, gs_tpu, arrays, cams)."""
    w, h = request.param
    arr = scene_arrays(n=4096, seed=2)
    jcam = j_cameras.make_camera(**camera_args(w, h))
    cam = interop.camera_from_numpy(camera_dict(jcam), "cpu")
    cov = projection.compute_cov3d(torch.from_numpy(arr["log_scale"]),
                                   torch.from_numpy(arr["quat"]))
    jcov = j_projection.compute_cov3d(jnp.asarray(arr["log_scale"]), jnp.asarray(arr["quat"]))
    got = projection.project_gaussians(torch.from_numpy(arr["xyz"]), cov, cam)
    want = jax.jit(j_projection.project_gaussians)(jnp.asarray(arr["xyz"]), jcov, jcam)
    return got, want, arr, cam, jcam, cov, jcov


def test_compute_cov3d(projected):
    _, _, _, _, _, cov, jcov = projected
    close(cov, jcov)


def test_project_gaussians(projected):
    got, want = projected[:2]
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(want.radii))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.radii.dtype == torch.int32 and int(got.mask.sum()) > 1000
    close(got.means2d, want.means2d, rtol=1e-5, atol=1e-4)
    close(got.conics, want.conics)
    close(got.depths, want.depths)


def test_bin_radii(projected, rng):
    got, want = projected[:2]
    opac = rng.uniform(0, 1, got.radii.shape[0]).astype(np.float32)
    opac[:20] = 1.0 / 255.0  # at the cutoff: radius 0
    b = projection.bin_radii(got.radii, torch.from_numpy(opac))
    jb = j_projection.bin_radii(want.radii, jnp.asarray(opac))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    assert (b <= got.radii).all() and (b[:20] == 0).all()


@pytest.mark.parametrize("deg", [0, 3, 4])
def test_sh_colors(projected, deg):
    _, _, arr, cam, jcam = projected[:5]
    rest = arr["features_rest"]
    if deg == 4:  # the scene is of degree 3: draw the fourth band's coefficients
        band = np.random.default_rng(4).normal(0, 0.2, (rest.shape[0], 9, 3))
        rest = np.concatenate([rest, band.astype(np.float32)], axis=1)
    args = (arr["xyz"], arr["features_dc"], rest)
    got = projection.sh_colors(*map(torch.from_numpy, args), cam.cam_pos, deg)
    want = j_projection.sh_colors(*map(jnp.asarray, args), jcam.cam_pos, deg)
    close(got, want)


# --- knn + state creation -------------------------------------------------------


@pytest.mark.parametrize("n", [3, 700, 4096])
def test_mean_knn_sq_dist(rng, n):
    pts = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    close(knn.mean_knn_sq_dist(torch.from_numpy(pts), chunk=512),
          j_knn.mean_knn_sq_dist(jnp.asarray(pts)))


def test_create_from_pcd(rng):
    pts = rng.uniform(-2, 2, (1000, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (1000, 3)).astype(np.float32)
    st = gaussians.create_from_pcd(pts, cols, max_sh_degree=3, device="cpu")
    ref = j_gaussians.create_from_pcd(pts, cols, max_sh_degree=3)
    assert st.capacity == ref.capacity == 4096 and st.max_sh_degree == 3
    for field in ("xyz", "features_dc", "features_rest", "log_scale", "quat",
                  "logit_opacity", "alive"):
        close(getattr(st, field), getattr(ref, field))
    close(st.opacity, ref.opacity)
    close(st.rotation, ref.rotation)
    assert set(st.params()) == set(ref.params())


# --- small helpers of gs_tpu's surface ------------------------------------------------


def test_densify_stats_init_and_asdict_shallow_match():
    got, want = gaussians.densify_stats_init(96, device="cpu"), j_gaussians.densify_stats_init(96)
    assert list(got) == list(want)
    for k in got:
        assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    from gs_tpu import config as j_config
    from gs_tpu_torch import config

    for name in ("OptimizationParams", "PipelineParams", "ParallelConfig"):
        got = config.asdict_shallow(getattr(config, name)())
        assert got == j_config.asdict_shallow(getattr(j_config, name)()), name


def test_process_info_outside_a_world():
    from gs_tpu.data import multihost as j_multihost
    from gs_tpu_torch.data import multihost

    assert multihost.process_info() == tuple(j_multihost.process_info()) == (0, 1)
