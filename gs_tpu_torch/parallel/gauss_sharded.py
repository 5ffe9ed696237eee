"""The Gaussian-sharded train step (port of ``gs_tpu/parallel/gauss_sharded.py``,
the "gauss" layout).

The layout for Gaussian counts beyond one device's memory: every
``[capacity, ...]`` leaf of the state, Adam and the densify statistics is
cut into ``shard`` row blocks, shard ``s`` holding rows ``[s * L, (s + 1) *
L)`` with ``L = capacity / shard`` (``shard_rows``; ``gather_rows`` puts
them back in shard order, what ``np.asarray`` of gs_tpu's global arrays
gives). Parameters and Adam's moments are 59 + 118 floats a Gaussian at SH
degree 3 against the 11 a step communicates, so this is where the capacity
scales.

gs_tpu writes the step as one ``shard_map``; autodiff through its
``all_gather`` of the splat table gives the backward's ``psum_scatter``.
PyTorch's autograd does not run through ``torch.distributed``, so the port
writes it as per-rank functions with ``mesh.Mesh``'s collectives between
them, on top of the tile layout's (``parallel/sharded.py``):

  1. ``project_local``: each rank projects only its own rows from fresh
     parameter leaves and a zero screen-offset leaf, packing the 11 floats
     the rasterizer needs (attr9 | depth | bin radius); with a
     ``visible_budget``, ``compact_visible`` keeps its visible rows;
  2. the detached tables are gathered over ``shard`` and the gathered
     ``[shard * rows, 11]`` table becomes a leaf;
  3. ``table_strip``: the rank composites its tile-column strip of that
     table through ``sharded.composite_strip`` (gs_tpu's
     ``_render_from_gathered``) and adds the background;
  4. the strips are gathered and ``sharded.band_cotangent`` gives this
     rank's row band's cotangent; summed over ``shard``, the rank keeps its
     strip's slice (the tile layout's functions, unchanged);
  5. backward from the strip to the table leaf; the table's cotangent is
     summed over ``shard`` and the rank keeps its own rows
     (``Mesh.sum_scatter_shard``, gs_tpu's ``psum_scatter``);
  6. backward through the local projection to the local parameter and
     screen-offset gradients;
  7. the parameter gradients and the loss are averaged over ``data``, the
     densify terms summed (``max_radii2d``: maxed) over ``data``;
  8. Adam on the local rows (``sharded.apply_step``), Adam's steps the
     same on every shard.

State, Adam and statistics go in and come out as ``{shard_index: value}``:
a process-group mesh holds its one shard; an in-process mesh holds every
shard once, shared by its data rows, and each shard's reduced update is
applied once (``shard_owners``). The compositing kernels run inside each
strip exactly as in the tile layout (B1 / B2, B3 / B4 under
``KERNEL_MODE="tile"``, B5 / B6 under ``GRAD_REDUCE="cuda"`` or
``PAIR_SOURCE="carry"``); packing, compaction and the collectives are
plain torch. Densify and shard rebalancing on this layout are in
``parallel/densify_sharded.py``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gs_tpu_torch.config import OptimizationParams, RasterizeConfig
from gs_tpu_torch.ops.projection import bin_radii
from gs_tpu_torch.ops.rasterize_tiled import ATTR_W, pack_attributes
from gs_tpu_torch.parallel.sharded import (_flat, _split, apply_step, band_cotangent,
                                           composite_strip, pair_budget_of, strip_static)
from gs_tpu_torch.renderer import project_splats

SPLAT_W = ATTR_W + 2  # attr9 | depth | bin radius


# --- shards of a state -----------------------------------------------------------------------


def map_tensors(fn, tree):
    """``fn`` on every tensor of a state tree (tensors, dicts, tuples,
    NamedTuples, dataclasses); anything else is kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [map_tensors(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: map_tensors(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def row_tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tree that have rows, in ``map_tensors``' order."""
    out = []
    map_tensors(lambda t: out.append(t) if t.dim() >= 1 else None, tree)
    return out


def shard_rows(tree, n_shard: int, s: int):
    """Shard ``s`` of a whole state tree (gs_tpu's ``shard_specs`` placement):
    rows ``[s * L, (s + 1) * L)`` of every tensor with rows, ``L =
    capacity / n_shard``; scalars (Adam's steps) whole. Copies, so the
    whole tree can be freed."""
    capacity = row_tensors(tree)[0].shape[0]
    if capacity % n_shard:
        raise ValueError(f"capacity {capacity} not divisible by shard={n_shard}")
    local = capacity // n_shard
    return map_tensors(lambda t: t[s * local:(s + 1) * local].clone() if t.dim() >= 1 else t, tree)


def shard_owners(mesh) -> dict[int, tuple[int, int]]:
    """{shard index: the rank here that applies its updates}: on an
    in-process mesh the ranks of the first data row (the other rows share
    their shard), on a process-group mesh this rank."""
    row = mesh.ranks[0][0]
    return {r[1]: r for r in mesh.ranks if r[0] == row}


def gather_rows(mesh, shards: dict):
    """The whole tree from ``{shard index: shard tree}``, every shard's rows
    in shard order (``shard_rows``' inverse). A collective over ``shard``:
    on a process-group mesh every rank of the row must call it."""
    owners = shard_owners(mesh)
    first = shards[min(shards)]
    per_shard = {s: row_tensors(t) for s, t in shards.items()}
    whole = []
    for i, leaf in enumerate(per_shard[min(shards)]):
        # gloo has no bool all-gather: masks cross as bytes
        xs = {r: per_shard[s][i].to(torch.uint8) if leaf.dtype == torch.bool else per_shard[s][i]
              for s, r in owners.items()}
        stacked = mesh.gather_shard(xs)[owners[min(owners)]]
        whole.append(stacked.reshape((-1,) + leaf.shape[1:]).to(leaf.dtype))
    it = iter(whole)
    return map_tensors(lambda t: next(it) if t.dim() >= 1 else t, first)


# --- the local projection and the visible-splat table ----------------------------------------


def compact_visible(packed: torch.Tensor, budget: int):
    """The rows of ``packed`` [N, SPLAT_W] with a bin radius > 0, in order,
    in a ``[budget, SPLAT_W]`` table (gs_tpu ``compact_visible``): rows past
    the budget are dropped, the tail rows are zero (radius 0, opacity 0:
    inert in binning). Returns (table, num_visible: the visible rows
    before the cut). A cumsum, a scatter of row indices into the
    table and a gather: no host sync, and the gather's backward adds each
    kept row's gradient once."""
    n = packed.shape[0]
    visible = packed[:, ATTR_W + 1] > 0
    pos = torch.cumsum(visible.to(torch.int64), 0) - 1
    keep = visible & (pos < budget)
    src = torch.full((budget + 1,), n, dtype=torch.int64, device=packed.device)
    src.scatter_(0, torch.where(keep, pos, budget),
                 torch.arange(n, dtype=torch.int64, device=packed.device))
    padded = torch.cat([packed, packed.new_zeros(1, SPLAT_W)])
    return padded[src[:budget]], visible.sum()


def project_local(state, camera, active_sh_degree: int, means2d_offset=None):
    """This rank's rows projected and packed (gs_tpu ``_project_local``):
    ``[L, SPLAT_W]`` rows of [attr9 | depth | bin radius] (dead rows have
    radius 0 and opacity 0) and the screen radii."""
    sp = project_splats(camera, state, active_sh_degree=active_sh_degree,
                        means2d_offset=means2d_offset)
    attr = pack_attributes(sp.means2d, sp.conics, sp.colors, sp.opacities)
    with torch.no_grad():
        brad = bin_radii(sp.radii, sp.opacities).to(torch.float32)
    return torch.cat([attr, sp.depths[:, None], brad[:, None]], dim=1), sp.radii


class Local(NamedTuple):
    """One rank's projected rows and what their backward needs."""

    packed: torch.Tensor  # [rows, SPLAT_W], compacted under a visible budget
    radii: torch.Tensor  # [L] int32
    num_visible: torch.Tensor
    params: dict  # the leaves the graph starts from
    offset: torch.Tensor  # [L, 2] screen-offset leaf


def local_forward(state, camera, active_sh_degree: int, visible_budget: int | None) -> Local:
    """Step 1: ``project_local`` from fresh leaves of the parameters and a
    zero screen offset, keeping the graph; compacted to ``visible_budget``
    rows when one is set."""
    params = {k: v.detach().requires_grad_() for k, v in state.params().items()}
    offset = torch.zeros((state.capacity, 2), dtype=torch.float32, device=state.device,
                         requires_grad=True)
    with torch.enable_grad():
        packed, radii = project_local(state.with_params(params), camera, active_sh_degree,
                                      offset)
        if visible_budget is not None:
            packed, num_vis = compact_visible(packed, visible_budget)
        else:
            num_vis = (packed[:, ATTR_W + 1] > 0).sum()
    return Local(packed, radii, num_vis, params, offset)


class TableStrip(NamedTuple):
    """One rank's strip of the gathered table."""

    tile_color: torch.Tensor  # [T_local, P, 3], background applied
    num_pairs: torch.Tensor
    table: torch.Tensor  # [shard * rows, SPLAT_W] leaf


def table_strip(table, bg, st, n_shard: int, me: int, pair_budget: int,
                truncate: bool) -> TableStrip:
    """Step 3: shard ``me``'s column strip composited from the gathered
    table (gs_tpu ``_render_from_gathered`` before its gather), from a
    leaf of the table."""
    leaf = table.detach().requires_grad_()
    with torch.enable_grad():
        tile_color, tile_t, num_pairs = composite_strip(
            st, leaf[:, 0:2], leaf[:, ATTR_W], leaf[:, ATTR_W + 1].to(torch.int32),
            leaf[:, :ATTR_W], n_shard, me, pair_budget, truncate)
        tile_color = tile_color + tile_t[..., None] * bg[None, None, :]
    return TableStrip(tile_color, num_pairs, leaf)


# --- the step --------------------------------------------------------------------------------


def make_gauss_sharded_train_step(mesh, opt_cfg: OptimizationParams,
                                  raster_cfg: RasterizeConfig, height: int, width: int,
                                  capacity: int, active_sh_degree: int,
                                  pair_budget: int | None = None,
                                  visible_budget: int | None = None):
    """The Gaussian-sharded train step on ``mesh`` (gs_tpu
    ``make_gauss_sharded_train_step``).

    ``step(states, adams, stats, cam_batch, bg, iteration, spatial_lr_scale,
    apply_update)``: ``states`` / ``adams`` / ``stats`` are ``{shard index:
    shard}`` for the shards held here (``capacity / shard`` rows each),
    ``cam_batch`` one camera a data row. Returns the updated shards in the
    same form and ``{"loss", "num_visible_max", "num_pairs_max"}`` (maxima
    over the mesh), alike on every rank.

    ``visible_budget`` (rows a shard) compacts each shard's table to its
    visible rows before the gather, so the gather and the table shrink
    from ``capacity`` to ``shard * visible_budget`` rows; rows past the
    budget are dropped for the step and ``num_visible_max`` reports the
    worst shard's count (None gathers every row: exact).
    """
    n_data, n_shard = mesh.data, mesh.shard
    if capacity % n_shard != 0:
        raise ValueError(f"capacity {capacity} not divisible by shard={n_shard}")
    budget = pair_budget_of(raster_cfg, capacity, pair_budget)
    st = strip_static(raster_cfg, height, width)
    truncate = raster_cfg.truncate_tiles
    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32, device=mesh.device)
    owners = shard_owners(mesh)

    def step(states, adams, stats, cam_batch, bg, iteration, spatial_lr_scale, apply_update):
        ranks = mesh.ranks
        bg = torch.as_tensor(bg, dtype=torch.float32, device=mesh.device)
        local = {r: local_forward(states[r[1]], cam_batch[r[0]], active_sh_degree,
                                  visible_budget) for r in ranks}
        tables = mesh.gather_shard({r: loc.packed.detach() for r, loc in local.items()})
        strips = {r: table_strip(tables[r].reshape(-1, SPLAT_W), bg, st, n_shard, r[1],
                                 budget, truncate) for r in ranks}
        del tables
        gathered = mesh.gather_shard({r: s.tile_color.detach() for r, s in strips.items()})
        band = {r: band_cotangent(st, n_shard, r[1], gathered[r], cam_batch[r[0]].image,
                                  opt_cfg.lambda_dssim) for r in ranks}
        del gathered
        g_image = mesh.sum_shard({r: g for r, (_, g) in band.items()})
        # depth and bin radius feed binning only: their columns' cotangent is 0
        g_table = {r: torch.autograd.grad(strips[r].tile_color, strips[r].table,
                                          grad_outputs=g_image[r][r[1]], allow_unused=True,
                                          materialize_grads=True)[0] for r in ranks}
        del g_image
        g_rows = mesh.sum_scatter_shard(g_table)
        del g_table
        grads = {r: torch.autograd.grad(local[r].packed, [*local[r].params.values(),
                                                          local[r].offset],
                                        grad_outputs=g_rows[r], allow_unused=True,
                                        materialize_grads=True) for r in ranks}
        del g_rows
        contrib = mesh.sum_shard({r: band[r][0].reshape(1) for r in ranks})
        data_terms, r_terms = {}, {}
        for r in ranks:
            *g_params, g_offset = grads[r]
            vis = local[r].radii > 0
            norm = torch.linalg.norm(g_offset * scale, dim=-1)
            data_terms[r] = _flat([*g_params, contrib[r] + opt_cfg.lambda_dssim,
                                   torch.where(vis, norm, 0.0), vis.to(torch.float32)])
            r_terms[r] = torch.where(vis, local[r].radii.to(torch.float32), 0.0)
        data_terms = mesh.sum_data(data_terms)
        r_max = mesh.max_data(r_terms)
        maxima = mesh.max_all({r: torch.stack([local[r].num_visible.to(torch.int64),
                                               strips[r].num_pairs.to(torch.int64)])
                               for r in ranks})
        # every rank of a shard column now holds the same reduced numbers:
        # each shard's update is applied once
        out_states, out_adams, out_stats = {}, {}, {}
        for s, r in owners.items():
            like = grads[r]
            *g_params, loss, d_accum, d_denom = _split(
                data_terms[r], [*like[:-1], like[-1].new_empty(1), like[-1][:, 0],
                                like[-1][:, 0]])
            g_params = {k: g / n_data for k, g in zip(states[s].params(), g_params)}
            out_states[s], out_adams[s], out_stats[s] = apply_step(
                states[s], adams[s], stats[s], g_params, (d_accum, d_denom, r_max[r]),
                iteration, spatial_lr_scale, apply_update, opt_cfg)
        r0 = ranks[0]
        return out_states, out_adams, out_stats, {
            "loss": loss[0] / n_data, "num_visible_max": maxima[r0][0],
            "num_pairs_max": maxima[r0][1]}

    return step
