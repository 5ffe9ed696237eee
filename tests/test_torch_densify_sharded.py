"""gs_tpu_torch's densify, rebalance and growth on the Gaussian-sharded
layout against gs_tpu's on the CPU.

gs_tpu runs on the 8-virtual-device CPU mesh of ``tests/conftest.py``; the
port on an in-process mesh of the same shape, its shards put back with
``gather_rows`` and compared slot by slot with gs_tpu's global arrays:

- ``TestShardedDensify``: three clone rounds and a split round on 8 shards
  with content-keyed hot statistics, the port fed gs_tpu's per-slot
  ``fold_in`` split noise: alive masks and reports equal, rows within
  float rounding of gs_tpu's in every slot, and the port's own one-device
  ``densify_and_prune`` on the same noise in the same sorted rows; a full
  state reports its local overflow drops;
- ``TestShardRebalance`` and ``TestRebalanceLoop``: one round and the
  loop against gs_tpu's round and fused ``lax.while_loop``, every field of
  every slot bitwise;
- growth under "gauss" (``trainer.maybe_grow_gauss``) against gs_tpu's
  ``_maybe_grow_parallel`` + ``_place_sharded``: the global layout, slot by
  slot.

gs_tpu's results are computed once per module.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_tpu import config as j_config
from gs_tpu.models import densify as j_densify
from gs_tpu.models import gaussians as j_gaussians
from gs_tpu.models import optim as j_optim
from gs_tpu.parallel import densify_sharded as j_dsh
from gs_tpu.parallel import trainer as j_trainer
from gs_tpu.training import TrainState as JTrainState
from gs_tpu_torch import config, interop
from gs_tpu_torch.models import densify
from gs_tpu_torch.parallel import densify_sharded, gauss_sharded, trainer
from gs_tpu_torch.parallel import mesh as mesh_mod
from tests.test_torch_sharding import j_scene, j_submesh
from tests.torch_port_inputs import STATE_FIELDS, one_torch_thread  # noqa: F401

GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


# --- carrying states across ------------------------------------------------------------------


def j_leaves(st, adam, stats):
    """A gs_tpu (state, adam, stats) as numpy."""
    return ({k: np.asarray(getattr(st, k)) for k in STATE_FIELDS},
            ({k: np.asarray(v) for k, v in adam.mu.items()},
             {k: np.asarray(v) for k, v in adam.nu.items()},
             {k: int(v) for k, v in adam.step.items()}),
            [np.asarray(v) for v in stats])


def port_shards(st, adam, stats, n_shard):
    """The same state as the port's {shard index: (state, adam, stats)}."""
    return interop.sharded_from_numpy(*j_leaves(st, adam, stats), n_shard, "cpu")


def split(shards):
    return tuple({s: v[i] for s, v in shards.items()} for i in range(3))


def whole(n_shard, states, adams, stats):
    mesh = mesh_mod.in_process_mesh(1, n_shard, device="cpu")
    return gauss_sharded.gather_rows(mesh, {s: (states[s], adams[s], stats[s]) for s in states})


def assert_same_slots(got, st, adam, stats, exact=True):
    """The port's whole (state, adam, stats) against gs_tpu's, slot by slot:
    bitwise, or within float rounding for computed children."""
    g_state, g_adam, g_stats = got
    tol = {} if exact else dict(rtol=1e-5, atol=1e-6)
    check = np.testing.assert_array_equal if exact else np.testing.assert_allclose
    for k in STATE_FIELDS:
        want = np.asarray(getattr(st, k))
        if k == "alive":
            np.testing.assert_array_equal(g_state.alive.numpy(), want)
        else:
            check(getattr(g_state, k).numpy(), want, err_msg=k, **tol)
    for name in ("mu", "nu"):
        for k in GROUPS:
            check(getattr(g_adam, name)[k].numpy(), np.asarray(getattr(adam, name)[k]),
                  err_msg=f"{name} {k}", **tol)
    for g, w in zip(g_stats, stats):
        check(g.numpy(), np.asarray(w), **tol)


# --- TestShardedDensify ----------------------------------------------------------------------


def split_draw(cap, seed):
    """gs_tpu's split noise of PRNGKey(seed) for global slots 0..cap-1
    (densify.py:176-182)."""
    key = jax.random.PRNGKey(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(cap, dtype=jnp.int32))
    eps = jax.vmap(lambda k: jax.random.normal(k, (2, 3), jnp.float32))(keys)
    return key, torch.from_numpy(np.array(jnp.swapaxes(eps, 0, 1)))


def hot_stats(xyz, alive, round_idx):
    """tests/test_sharding.py:286-297: the densify signal keyed by a row's
    content, so the layouts select the same Gaussians."""
    h = np.sin(np.asarray(xyz).sum(axis=1) * 977.13 + round_idx)
    hot = (h > 0.6) & np.asarray(alive)
    n = hot.shape[0]
    return hot.astype(np.float32), np.ones(n, np.float32), np.zeros(n, np.float32)


def sorted_alive_rows(state):
    alive = state.alive.numpy()
    rows = np.concatenate([state.xyz.numpy()[alive], state.log_scale.numpy()[alive],
                           state.logit_opacity.numpy()[alive]], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def densify_start():
    """test_three_rounds_match_replicated's start: 40 Gaussians of capacity
    128, clone-sized, spread round robin over 8 shards of 16."""
    st, _ = j_scene(n=40, cap=128)
    st = st.replace(log_scale=jnp.full_like(st.log_scale, math.log(0.005)))
    perm = np.argsort([(i % 8) * 16 + i // 8 for i in range(128)])
    return jax.tree.map(lambda a: a[jnp.asarray(perm)], st)


@functools.lru_cache(maxsize=None)
def j_densify_rounds():
    """gs_tpu's sharded densify: three clone rounds (keys 0-2), then the
    split round (big scales, key 99); each round's (state, adam, report)."""
    st = densify_start()
    opt = j_config.OptimizationParams(densify_grad_threshold=2e-4)
    fn = j_dsh.make_sharded_densify(j_submesh(1, 8), opt, 128, 1, use_size_prune=False)
    adam = j_optim.init(st.params())
    out = []
    for rnd, key in ((0, 0), (1, 1), (2, 2), (9, 99)):
        if rnd == 9:
            st = st.replace(log_scale=jnp.full_like(st.log_scale, math.log(0.5)))
        stats = j_densify.DensifyStats(*map(jnp.asarray, hot_stats(st.xyz, st.alive, rnd)))
        st, adam, _, rep = fn(st, adam, stats, jax.random.PRNGKey(key), jnp.float32(10.0))
        out.append((st, adam, tuple(int(v) for v in rep)))
    return out


def test_sharded_densify_matches_gs_tpu_and_one_device():
    """TestShardedDensify::test_three_rounds_match_replicated on 8 shards:
    each round's alive mask, report and rows slot by slot against gs_tpu's
    sharded densify (rows within float rounding: the children are
    computed), and the alive count and sorted rows against the port's
    one-device densify_and_prune on the same noise."""
    st0 = densify_start()
    shards = port_shards(st0, j_optim.init(st0.params()),
                         j_densify.DensifyStats.zeros(128), 8)
    states, adams, _ = split(shards)
    one = densify_start()
    one_state = interop.state_from_numpy({k: np.asarray(getattr(one, k)) for k in STATE_FIELDS},
                                         "cpu")
    one_adam = whole(8, *split(shards))[1]
    opt = config.OptimizationParams(densify_grad_threshold=2e-4)
    fn = densify_sharded.make_sharded_densify(mesh_mod.in_process_mesh(1, 8, device="cpu"),
                                              opt, 128, use_size_prune=False)
    for (rnd, key), (j_st, j_adam, j_rep) in zip(((0, 0), (1, 1), (2, 2), (9, 99)),
                                                 j_densify_rounds()):
        if rnd == 9:
            big = math.log(0.5)
            states = {s: v.replace(log_scale=torch.full_like(v.log_scale, big))
                      for s, v in states.items()}
            one_state = one_state.replace(log_scale=torch.full_like(one_state.log_scale, big))
        _, noise = split_draw(128, key)
        cur = whole(8, states, adams, {s: densify.DensifyStats.zeros(16, "cpu")
                                       for s in states})[0]
        hot = densify.DensifyStats(*map(torch.from_numpy,
                                        hot_stats(cur.xyz.numpy(), cur.alive.numpy(), rnd)))
        stats = {s: gauss_sharded.shard_rows(hot, 8, s) for s in states}
        states, adams, new_stats, rep = fn(states, adams, stats, noise, 10.0)
        assert tuple(int(v) for v in rep) == j_rep, rnd
        got = whole(8, states, adams, new_stats)
        assert_same_slots(got, j_st, j_adam, j_densify.DensifyStats.zeros(128), exact=False)
        assert all(not s.any() for s in got[2])
        one_stats = interop.stats_from_numpy(*hot_stats(one_state.xyz.numpy(),
                                                        one_state.alive.numpy(), rnd), "cpu")
        one_state, one_adam, _, one_rep = densify.densify_and_prune(
            one_state, one_adam, one_stats, noise, max_grad=2e-4, min_opacity=0.005,
            extent=10.0, percent_dense=0.01, use_size_prune=False)
        if rnd < 9:  # every shard has room: the layouts hold the same rows
            assert rep.n_dropped == one_rep.n_dropped == 0
            assert int(got[0].num_alive) == int(one_state.num_alive)
            np.testing.assert_allclose(sorted_alive_rows(got[0]), sorted_alive_rows(one_state),
                                       rtol=1e-5, atol=1e-6)
        else:  # full shards may drop children the one device places: the reports reconcile
            assert int(rep.n_split) == int(one_rep.n_split) > 0
            assert (int(got[0].num_alive) + int(rep.n_dropped)
                    == int(one_state.num_alive) + int(one_rep.n_dropped))


def test_local_overflow_reports_drops():
    """test_local_overflow_reports_drops: every slot of every shard alive and
    hot, so every child drops; the report equals gs_tpu's."""
    st, _ = j_scene(n=64, cap=64)
    ones = (np.ones(64, np.float32), np.ones(64, np.float32), np.zeros(64, np.float32))
    j_fn = j_dsh.make_sharded_densify(j_submesh(1, 8), j_config.OptimizationParams(), 64, 1,
                                      False)
    j_st, _, _, j_rep = j_fn(st, j_optim.init(st.params()),
                             j_densify.DensifyStats(*map(jnp.asarray, ones)),
                             jax.random.PRNGKey(0), jnp.float32(10.0))
    shards = port_shards(st, j_optim.init(st.params()),
                         j_densify.DensifyStats(*map(jnp.asarray, ones)), 8)
    fn = densify_sharded.make_sharded_densify(mesh_mod.in_process_mesh(1, 8, device="cpu"),
                                              config.OptimizationParams(), 64, False)
    states, _, _, rep = fn(*split(shards), split_draw(64, 0)[1], 10.0)
    assert int(rep.n_dropped) > 0 and tuple(int(v) for v in rep) == tuple(map(int, j_rep))
    assert sum(int(s.num_alive) for s in states.values()) == int(j_st.num_alive) == 64


# --- TestShardRebalance / TestRebalanceLoop --------------------------------------------------


def skewed(n_alive, seed, tag_mu=False):
    """test_sharding.py's skewed states: capacity 64 over 8 shards, the first
    ``n_alive`` slots alive; with ``tag_mu`` the xyz moment tags its row."""
    rng = np.random.default_rng(seed)
    st = j_gaussians.empty_state(64, 1)
    alive = np.zeros(64, bool)
    alive[:n_alive] = True
    xyz = rng.normal(size=(64, 3)).astype(np.float32)
    st = st.replace(xyz=jnp.asarray(xyz), alive=jnp.asarray(alive))
    adam = j_optim.init(st.params())
    if tag_mu:
        adam = adam._replace(mu={**adam.mu, "xyz": jnp.asarray(xyz) * 0.5})
    stats = j_densify.DensifyStats(*(jnp.asarray(rng.uniform(size=64).astype(np.float32))
                                     for _ in range(3)))
    return st, adam, stats


@functools.lru_cache(maxsize=None)
def j_rebalanced(case):
    """gs_tpu's rounds (migration budget 4) of each case: (state, adam,
    stats, moved) after every round."""
    n_alive, seed, rounds = {"skew": (16, 0, 4), "intake": (56, 1, 3), "noop": (64, 2, 1)}[case]
    s, a, t = skewed(n_alive, seed, tag_mu=True)
    reb = j_dsh.make_sharded_rebalance(j_submesh(1, 8), 64, 1, migration_budget=4)
    out = []
    for _ in range(rounds):
        s, a, t, moved = reb(s, a, t)
        out.append((s, a, t, int(moved)))
    return out


@pytest.mark.parametrize("case", ["skew", "intake", "noop"])
def test_rebalance_round_matches_gs_tpu(case):
    """TestShardRebalance: each round's state, both Adam moments and the
    statistics bitwise equal to gs_tpu's in every slot, and the rows moved;
    the alive count never changes; "skew" (shards 0-1 full) ends at 2 a
    shard, "intake" (7 senders, 1 receiver) within one of balance, "noop"
    (balanced) moves nothing."""
    n_alive, seed, _ = {"skew": (16, 0, 4), "intake": (56, 1, 3), "noop": (64, 2, 1)}[case]
    mesh = mesh_mod.in_process_mesh(1, 8, device="cpu")
    states, adams, stats = split(port_shards(*skewed(n_alive, seed, tag_mu=True), 8))
    reb = densify_sharded.make_sharded_rebalance(mesh, migration_budget=4)
    for j_s, j_a, j_t, j_moved in j_rebalanced(case):
        states, adams, stats, moved = reb(states, adams, stats)
        assert moved == j_moved
        assert_same_slots(whole(8, states, adams, stats), j_s, j_a, j_t)
        assert sum(densify_sharded.shard_occupancy(mesh, states)) == n_alive
    occ = densify_sharded.shard_occupancy(mesh, states)
    assert max(occ) - min(occ) <= (0 if case != "intake" else 1)
    if case == "noop":
        assert moved == 0


@functools.lru_cache(maxsize=None)
def j_loop(threshold, n_alive):
    s, a, t = skewed(n_alive, 2)
    loop = j_dsh.make_sharded_rebalance_loop(j_submesh(1, 8), 64, 1, migration_budget=4,
                                             max_rounds=8)
    s, a, t, moved = loop(s, a, t, jnp.float32(threshold))
    return s, a, t, int(moved)


@pytest.mark.parametrize("threshold,n_alive", [(1.1, 16), (1.5, 64), (1.1, 56)])
def test_rebalance_loop_matches_gs_tpu(threshold, n_alive):
    """TestRebalanceLoop: the host loop gives gs_tpu's fused loop's state
    bitwise in every slot and the same rows moved (none below the skew
    threshold)."""
    mesh = mesh_mod.in_process_mesh(1, 8, device="cpu")
    loop = densify_sharded.make_sharded_rebalance_loop(mesh, migration_budget=4, max_rounds=8)
    states, adams, stats, moved = loop(*split(port_shards(*skewed(n_alive, 2), 8)), threshold)
    j_s, j_a, j_t, j_moved = j_loop(threshold, n_alive)
    assert moved == j_moved and (moved > 0) == (n_alive != 64)
    assert_same_slots(whole(8, states, adams, stats), j_s, j_a, j_t)


# --- growth under gauss ----------------------------------------------------------------------


def test_gauss_growth_matches_gs_tpu():
    """gs_tpu's _maybe_grow_parallel under "gauss" + _place_sharded on 2
    shards: past the watermark the whole capacity doubles (rounded up to
    4096 x S) with the new slots at its end, cut into shards again; every
    slot of the port's regathered shards equals gs_tpu's global arrays
    (rows of shard 1 move into shard 0); below it nothing changes."""
    st, _ = j_scene()
    j_ts = JTrainState(state=st, adam=j_optim.init(st.params()),
                       stats=j_densify.DensifyStats.zeros(st.capacity))
    mesh = j_submesh(1, 2)
    j_ts = j_trainer._maybe_grow_parallel(j_ts, mesh, True, 4096 * 2, 0.5, 2.0)
    shards = split(port_shards(st, j_optim.init(st.params()),
                               j_densify.DensifyStats.zeros(st.capacity), 2))
    p_mesh = mesh_mod.in_process_mesh(1, 2, device="cpu")
    grown = trainer.maybe_grow_gauss(p_mesh, *shards, 4096 * 2, 0.5, 2.0)
    assert all(v.capacity == 4096 for v in grown[0].values())
    assert j_ts.state.capacity == 8192
    assert_same_slots(whole(2, *grown), j_ts.state, j_ts.adam, j_ts.stats)
    assert int(grown[0][1].num_alive) == 0 and int(grown[0][0].num_alive) == 48
    same = trainer.maybe_grow_gauss(p_mesh, *grown, 4096 * 2, 0.9, 2.0)
    assert same[0][0] is grown[0][0]
