"""The seeded generators: the same seed gives the same scene."""

import torch

from portbench import scenes
from portbench.traffic import fit
from portbench.tests.small import SEED, small_cell


def test_same_seed_same_scene_other_seed_other_scene():
    cfg = small_cell("mipnerf360-train").config
    a, b, c = (scenes.gaussians(cfg, s, "cpu") for s in (SEED, SEED, SEED + 1))
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["xyz"], c["xyz"])
    assert int(a["alive"].sum()) == cfg["gaussians"]
    assert a["xyz"].shape[0] == scenes.capacity(cfg["gaussians"])
    assert scenes.views(cfg, SEED)[5][0].tolist() == scenes.views(cfg, SEED)[5][0].tolist()
    imgs = scenes.images(cfg, SEED, 4, "cpu")
    assert torch.equal(imgs, scenes.images(cfg, SEED, 4, "cpu"))
    assert torch.equal(imgs[[1, 3]], scenes.images(cfg, SEED, 4, "cpu", which=[1, 3]))
    assert 0.0 <= float(imgs.min()) and float(imgs.max()) <= 1.0
    mu, nu = scenes.adam_state(cfg, a, SEED, "cpu")
    mu2, _ = scenes.adam_state(cfg, b, SEED, "cpu")
    assert all(torch.equal(mu[k], mu2[k]) for k in mu)
    assert all(float(v.min()) >= 0 for v in nu.values())


def test_split_and_orbit():
    train, test = scenes.split(194, 8)
    assert (len(train), len(test)) == (169, 25)
    train, test = scenes.split(251, 8)
    assert (len(train), len(test)) == (219, 32)
    cfg = small_cell("tandt-view").config
    for r, t in scenes.views(cfg, SEED):
        center = -r @ t
        assert abs(float((r.T @ r - torch.eye(3).numpy()).max())) < 1e-9
        # every camera looks at the scene's middle from outside the ball
        fwd = r[:, 2]
        assert fwd @ -center / (center @ center) ** 0.5 > 0.95
        assert (center @ center) ** 0.5 > cfg["scene"]["radius"]


def test_camera_order_is_the_loops():
    """``fit.camera_order`` gives the views ``run_training`` takes."""
    cell = small_cell("mipnerf360-train")
    out = fit.run(cell, SEED, 1.0, False, torch.device("cpu"), 0.0)
    train = scenes.split(cell.config["views"], cell.config["test_every"])[0]
    first = out.notes["phases"][0].watch
    assert first.views == fit.camera_order(SEED, train, cell.traffic["check_steps"])
