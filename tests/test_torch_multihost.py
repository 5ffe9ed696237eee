"""gs_tpu_torch's per-data-row image split and checkpoints of a gauss run
against gs_tpu's on the CPU (twins of ``TestMultiprocessBatchPath``,
tests/test_sharding.py:547-628).

In the port a process is one rank, and a data row of several shards spans
several processes, so ownership is by data row: the ranks of row d load
the train images gs_tpu's process d would in a world of one process a data
row. On the same inputs:

- ``should_load_image`` equal to gs_tpu's; the feeders of a mesh and the
  sampler's draws for one process a data row equal to gs_tpu's;
- ``assemble_global_batch``: the rows a rank runs need their image (the
  unowned slot raises, as gs_tpu's does), the others pass as they are;
- ``Scene(data_row=(d, D))`` on the COLMAP fixture of
  ``tests/test_torch_data.py``: the train cameras that hold an image are
  gs_tpu's ``Scene``'s with its process index d of D, the images bitwise;
  every test camera holds one;
- a reader opening a dataset while another's point-cloud conversion is
  half written reads the whole cloud;
- a ``.npz`` written by gs_tpu from its gauss step's global arrays loads in
  the port, and ``shard_rows`` cuts it into gs_tpu's device shards; a
  checkpoint directory of it loads the same.
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_tpu import cameras as j_cameras
from gs_tpu import config as j_config
from gs_tpu import scene as j_scene_mod
from gs_tpu.config import ModelParams as JModelParams
from gs_tpu.data import multihost as j_multihost
from gs_tpu.models import densify as j_densify
from gs_tpu.models import optim as j_optim
from gs_tpu.parallel import gauss_sharded as j_gauss
from gs_tpu.training import TrainState as JTrainState
from gs_tpu.utils import ckpt as j_ckpt
from gs_tpu_torch import scene
from gs_tpu_torch.config import ModelParams
from gs_tpu_torch.data import multihost
from gs_tpu_torch.parallel import gauss_sharded
from gs_tpu_torch.parallel import mesh as mesh_mod
from gs_tpu_torch.utils import ckpt
from tests.test_torch_data import colmap_scene  # noqa: F401
from tests.test_torch_sharding import (H, J_RCFG, W, _Cam, j_scene, j_submesh, port_scene)
from tests.torch_port_inputs import STATE_FIELDS, one_torch_thread  # noqa: F401


def test_should_load_image_matches_gs_tpu():
    """Train cameras by their owner, test cameras everywhere."""
    for count in (1, 2, 3):
        for pid in range(count):
            for i in range(11):
                for is_test in (False, True):
                    assert multihost.should_load_image(i, pid, count, is_test=is_test) == \
                        j_multihost.should_load_image(i, pid, count, is_test=is_test)


@pytest.mark.parametrize("data,shard", [(1, 4), (2, 2), (3, 1)])
def test_feeders_draw_as_gs_tpu_with_a_process_a_row(data, shard):
    """Data row d feeds slot d: the feeders are [0 .. data - 1], and the
    sampler over them draws what gs_tpu's draws in a world of ``data``
    processes (random.seed(123), 9 cameras, 3 of another resolution),
    every slot from its own row's cameras."""
    mesh = mesh_mod.in_process_mesh(data, shard, device="cpu")
    feeders = multihost.data_row_feeders(mesh)
    assert feeders == list(range(data))
    cams = [_Cam(32, 32) for _ in range(6)] + [_Cam(16, 16) for _ in range(3)]
    by_id = {id(c): i for i, c in enumerate(cams)}

    def draws(mod):
        random.seed(123)
        sampler = mod.BatchSampler(cams, feeders=feeders, process_count=data)
        return [[by_id[id(c)] for c in sampler.next_batch()] for _ in range(10)]

    got = draws(multihost)
    assert got == draws(j_multihost)
    for batch in got:
        assert [gi % data for gi in batch] == list(range(data))


def test_assemble_global_batch_takes_this_ranks_slot():
    """A rank of data row 1 of a 2 x 1 world needs slot 1's image and not
    slot 0's; an in-process mesh runs every row and needs them all; a
    missing image raises gs_tpu's error."""
    _, cam = port_scene()
    bare = dataclasses.replace(cam, image=None)
    row1 = mesh_mod.Mesh(2, 1, ((1, 0),), torch.device("cpu"))
    out = multihost.assemble_global_batch(row1, [bare, cam])
    assert out[0] is bare and out[1].image is cam.image
    with pytest.raises(RuntimeError, match="does not own"):
        multihost.assemble_global_batch(row1, [cam, bare])
    every = mesh_mod.in_process_mesh(2, 2, device="cpu")
    assert all(c is cam for c in multihost.assemble_global_batch(every, [cam, cam]))
    with pytest.raises(RuntimeError, match="does not own"):
        multihost.assemble_global_batch(every, [cam, bare])
    _, j_cam = j_scene()
    with pytest.raises(RuntimeError, match="does not own"):  # gs_tpu's, for comparison
        jax.block_until_ready(j_multihost.assemble_global_batch(
            j_submesh(2, 1), [j_cam, j_cam.replace(image=None)]).image)


@pytest.mark.parametrize("d", [0, 1])
def test_scene_loads_its_data_rows_images(colmap_scene, tmp_path, monkeypatch, d):  # noqa: F811
    """Scene(data_row=(d, 2)) on the COLMAP fixture (eval split): the train
    cameras holding an image are those gs_tpu's Scene holds as process d of
    2, images bitwise equal; every test camera holds its image; a camera
    without one still has its matrices."""
    path, _, _ = colmap_scene
    kw = dict(source_path=str(path), eval=True, sh_degree=1, resolution=2)
    random.seed(3)
    got = scene.Scene(ModelParams(model_path=str(tmp_path / "port"), **kw), device="cpu",
                      data_row=(d, 2))
    monkeypatch.setattr(j_multihost, "process_info", lambda: (d, 2))
    random.seed(3)
    want = j_scene_mod.Scene(JModelParams(model_path=str(tmp_path / "gs_tpu"), **kw))
    g_train, w_train = got.get_train_cameras(), want.get_train_cameras()
    held = [c.image is not None for c in g_train]
    assert held == [c.image is not None for c in w_train] == [i % 2 == d
                                                             for i in range(len(g_train))]
    for g, w in zip(g_train, w_train):
        np.testing.assert_array_equal(g.full_proj.numpy(), np.asarray(w.full_proj))
        if g.image is not None:
            np.testing.assert_array_equal(g.image.numpy(), np.asarray(w.image))
    assert all(c.image is not None for c in got.get_test_cameras())
    assert len(got.get_test_cameras()) == len(want.get_test_cameras()) > 0


def test_ranks_opening_one_dataset_convert_its_points_safely(colmap_scene,  # noqa: F811
                                                            monkeypatch):
    """The ranks of a mesh run read one COLMAP dataset at once, and the first
    reads convert points3D.bin to a PLY. Another rank opening the dataset
    while this one's conversion is half written (here: inside the writer,
    with half the file on disk) must not read that half: it converts for
    itself, both get the whole point cloud, and no temporary file is
    left."""
    import os

    from gs_tpu_torch.data import ply, readers

    path, xyz, _ = colmap_scene
    real_write, paused, inner = ply.write_pointcloud_ply, [], []

    def half_then_whole(target, points, colors):
        real_write(target, points, colors)
        if not paused:  # the first writer pauses with half its file written
            paused.append(target)
            size = os.path.getsize(target)
            with open(target, "r+b") as f:
                f.truncate(size // 2)
            inner.append(readers.load_scene_info(str(path)).point_cloud[0])
            real_write(target, points, colors)

    monkeypatch.setattr(ply, "write_pointcloud_ply", half_then_whole)
    outer = readers.load_scene_info(str(path)).point_cloud[0]
    assert len(inner) == 1
    for pts in (outer, *inner):
        np.testing.assert_array_equal(pts, xyz.astype(np.float32))
    assert sorted(os.listdir(path / "sparse" / "0")) == [
        "cameras.bin", "images.bin", "points3D.bin", "points3D.ply"]


def test_gs_tpu_gauss_checkpoint_loads_into_shards(tmp_path):
    """gs_tpu's TrainState after one gauss step on a 1 x 4 mesh, saved by
    gs_tpu as .npz (its global arrays), loads in the port; shard_rows cuts
    it into gs_tpu's device shards bitwise, and a checkpoint directory
    written from it loads the same leaves."""
    st, cam = j_scene()
    mesh = j_submesh(1, 4)
    step = j_gauss.make_gauss_sharded_train_step(mesh, j_config.OptimizationParams(), J_RCFG,
                                                 H, W, st.capacity, 1)
    s, a, d, _ = step(st, j_optim.init(st.params()), j_densify.DensifyStats.zeros(st.capacity),
                      j_cameras.stack_cameras([cam]), jnp.zeros(3), jnp.int32(0),
                      jnp.float32(1.0), jnp.bool_(True))
    j_ts = JTrainState(state=s, adam=a, stats=d, iteration=1, spatial_lr_scale=1.0,
                       max_sh_degree=1)
    j_ckpt.save_train_state(str(tmp_path / "gauss.npz"), j_ts)
    ts = ckpt.load_train_state(str(tmp_path / "gauss.npz"), device="cpu")
    assert ts.iteration == 1 and ts.adam.step == {k: 1 for k in ts.adam.step}
    for i in range(4):
        state, adam, stats = gauss_sharded.shard_rows((ts.state, ts.adam, ts.stats), 4, i)
        for k in STATE_FIELDS:
            part, = [p for p in getattr(s, k).addressable_shards if p.index[0].start == 16 * i]
            np.testing.assert_array_equal(getattr(state, k).numpy(), np.asarray(part.data),
                                          err_msg=f"{k} shard {i}")
        part, = [p for p in a.nu["xyz"].addressable_shards if p.index[0].start == 16 * i]
        np.testing.assert_array_equal(adam.nu["xyz"].numpy(), np.asarray(part.data))
        part, = [p for p in d.xyz_grad_accum.addressable_shards if p.index[0].start == 16 * i]
        np.testing.assert_array_equal(stats.xyz_grad_accum.numpy(), np.asarray(part.data))
        assert adam.step == ts.adam.step
    ckpt.save_train_state(str(tmp_path / "gauss_dir"), ts)
    back = ckpt.load_train_state(str(tmp_path / "gauss_dir"), device="cpu")
    want = ckpt.to_flat_dict(ts)
    for k, v in ckpt.to_flat_dict(back).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
