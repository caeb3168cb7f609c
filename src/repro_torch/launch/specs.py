"""Meta-tensor stand-ins and placements for every (arch × shape) dry-run cell.

The port's counterpart of the JAX package's ``launch/specs.py``: where the
reference has ``ShapeDtypeStruct`` trees, the port has tensors on the
``meta`` device (shapes and dtypes, no data), so that no device memory is
allocated anywhere on the dry-run path; where it has ``NamedSharding``s,
the port has DTensor placements on a DeviceMesh.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import Replicate

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import model as MDL
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train import sharding as SH


def cell_plan(cfg: ModelConfig, shape_name: str, n_dp: int) -> Dict[str, Any]:
    """Per-cell execution plan (microbatch accumulation policy).

    Napkin: with full remat, live activations ≈ layer-boundary residuals
    = n_layers × rows/device × S × d_model × 2B. Target ≤ ~4 GB a
    device, leaving room for params+optimizer. Bigger d_model ⇒ more
    accumulation.
    """
    shp = SHAPES[shape_name]
    accum = 1
    if shp["kind"] == "train":
        resid_bytes_per_row = cfg.n_layers * shp["seq_len"] * cfg.d_model * 2
        rows_per_dev = max(shp["global_batch"] // n_dp, 1)
        budget = 4 << 30
        while (accum < rows_per_dev
               and rows_per_dev // accum * resid_bytes_per_row > budget):
            accum *= 2
        accum = min(accum, rows_per_dev)
    return dict(accum=accum, **shp)


def input_specs(arch: str, shape_name: str,
                cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """Meta tensors for the *data* inputs of one cell (excluding
    params/opt; a decode cell's state is here)."""
    cfg = cfg if cfg is not None else get_config(arch)
    shp = SHAPES[shape_name]
    GB, S, kind = shp["global_batch"], shp["seq_len"], shp["kind"]

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out: Dict[str, Any] = {"kind": kind}
    if kind in ("train", "prefill"):
        text_len = S - cfg.num_patches if cfg.num_patches else S
        out["tokens"] = meta((GB, text_len), torch.int32)
        if kind == "train":
            out["targets"] = meta((GB, text_len), torch.int32)
        if cfg.num_patches:
            out["frontend"] = meta((GB, cfg.num_patches, cfg.d_model),
                                   torch.float32)
        if cfg.enc_layers:
            out["frontend"] = meta((GB, cfg.enc_seq, cfg.d_model),
                                   torch.float32)
    else:  # decode: one new token against a seq_len-deep cache
        out["token"] = meta((GB,), torch.int32)
        out["state"] = MDL.init_decode_state(
            cfg, GB, S, dtype=torch.bfloat16, device="meta",
            with_xkv=bool(cfg.enc_layers))
    return out


def model_state_specs(cfg: ModelConfig, opt: bool = True):
    """A model on ``meta`` (and its optimizer state)."""
    params = MDL.init_model(cfg, device="meta")
    if not opt:
        return params, None
    opt_cfg = adamw.OptConfig(moment_dtype=cfg.param_dtype)
    return params, adamw.init(params, opt_cfg)


def _fit_spec(spec, leaf, mesh):
    """Downgrade spec dims that don't divide evenly to replicated.

    (DTensor shards unevenly, but the reference's jit in_shardings require
    exact divisibility: vocab padding handles the hot tables, this guard
    catches everything else — e.g. 14-head archs.) ``mesh``: a DeviceMesh
    or {axis: size}."""
    sizes = axis_sizes(mesh)
    dims = []
    for i, ax in enumerate(spec):
        if ax is None:
            dims.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = 1
        for a in axes:
            size *= sizes[a]
        dims.append(ax if leaf.shape[i] % size == 0 else None)
    return tuple(dims)


def cell_shardings(cfg: ModelConfig, shape_name: str, mesh, *,
                   fsdp: bool = True, layout: str = "tp"):
    """The placements of one cell's inputs on ``mesh``: ``params`` and
    (train) ``opt`` moments keyed by parameter name, the data inputs,
    (decode) the ``state`` tree, and the cell's ``batch_axes`` and
    ``n_dp``.

    layout="tp" (default): model axis does tensor parallelism, batch over
    data(+pod), weights 2-D sharded (TP × fsdp).
    layout="dp": no tensor parallelism — batch over EVERY mesh axis,
    weights ZeRO-3 sharded over all axes.
    """
    if layout == "dp":
        batch_axes = tuple(mesh.mesh_dim_names)
        model_axis = None
        fsdp_axes = batch_axes
    else:
        batch_axes = tuple(a for a in mesh.mesh_dim_names
                           if a in ("pod", "data"))
        model_axis = "model"
        fsdp_axes = batch_axes if fsdp else None
    sizes = axis_sizes(mesh)
    shp = SHAPES[shape_name]
    GB = shp["global_batch"]
    n_dp = 1
    for a in batch_axes:
        n_dp *= sizes[a]
    shard_batch = GB % n_dp == 0 and GB >= n_dp

    def pl(spec):
        return SH.to_placements(spec, mesh)

    params, _ = model_state_specs(cfg, opt=False)
    named = dict(params.named_parameters())
    p_specs = {n: _fit_spec(s, named[n], mesh)
               for n, s in SH.param_specs(params, model=model_axis,
                                          fsdp=fsdp_axes).items()}
    p_pl = {n: pl(s) for n, s in p_specs.items()}

    out = {"params": p_pl, "batch_axes": batch_axes, "n_dp": n_dp}
    kind = shp["kind"]
    b_ax = batch_axes if shard_batch else None
    if kind == "train":
        out["opt"] = adamw.OptState(step=(Replicate(),) * mesh.ndim,
                                    m=p_pl, v=p_pl)
        out["tokens"] = pl((b_ax, None))
        out["targets"] = pl((b_ax, None))
        out["frontend"] = pl((b_ax, None, None))
    elif kind == "prefill":
        out["tokens"] = pl((b_ax, None))
        out["frontend"] = pl((b_ax, None, None))
    else:  # decode
        out["token"] = pl((b_ax,))
        state = MDL.init_decode_state(
            cfg, GB, shp["seq_len"], dtype=torch.bfloat16, device="meta",
            with_xkv=bool(cfg.enc_layers))
        c_specs = SH.cache_specs(state, batch_axes=b_ax, model=model_axis,
                                 shard_seq=not shard_batch)
        out["state"] = SH.map_specs(
            lambda s, leaf: pl(_fit_spec(s, leaf, mesh)), c_specs, state)
    return out
