"""Sharding rules: parameter / batch / cache specs per mesh, and the
activation constraints.

The port's counterpart of the JAX package's ``train/sharding.py``, in its
language: a spec has one entry per tensor dim, each a mesh axis name, a
tuple of names (the dim split over several axes, the first outermost) or
``None`` (not split), so that a spec compares equal to the reference's
``PartitionSpec``. :func:`to_placements` turns a spec into DTensor
placements on a :class:`~torch.distributed.device_mesh.DeviceMesh`.

Logical layout (2D "model ∥ fsdp" sharding, as the reference's):

* ``model`` axis: attention heads / d_ff / vocab / d_inner (Megatron TP:
  column-parallel in-projections, row-parallel out-projections).
* ``data`` (+ ``pod``) axes: batch; with ``fsdp`` also the complementary
  dim of every weight matrix (ZeRO-3 style fully sharded parameters and
  optimizer state: DTensor all-gathers a weight where a product needs
  it).
* MoE expert weights are TP-sharded on the expert-ff dim.
* long-context decode (batch=1): KV-cache *sequence* dim sharded on
  ``data``.

The port's layers are unstacked (``layers.3.pos0.attn.wq``), so a spec has
no leading entry for the reference's stacked ``n_periods`` axis.

Activation constraints go through a small context (:func:`mesh_axes`), so
model code stays mesh-agnostic: outside it every ``constrain*`` returns
its argument itself; inside it a DTensor is redistributed to the spec's
placements (on its own mesh) and any other tensor is returned as it is.
Inside the context, plain tensors that meet DTensors in an op (an
``arange`` of positions, a mask) count as replicated
(``implicit_replication``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import (
    DTensor, Replicate, Shard, distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

Spec = Tuple[Any, ...]

# ---------------------------------------------------------------------------
# mesh context for activation constraints
# ---------------------------------------------------------------------------

_CTX: Dict[str, Any] = {
    "batch_axes": None,
    "model_axis": None,
    "seq_parallel": False,
    "model_size": 1,
}


@contextlib.contextmanager
def mesh_axes(batch_axes: Tuple[str, ...], model_axis: str,
              seq_parallel: bool = False, model_size: int = 1):
    old = dict(_CTX)
    _CTX.update(batch_axes=batch_axes, model_axis=model_axis,
                seq_parallel=seq_parallel, model_size=model_size)
    try:
        with implicit_replication():
            yield
    finally:
        _CTX.update(old)


def active() -> bool:
    return _CTX["batch_axes"] is not None


def to_placements(spec: Spec, mesh) -> Tuple:
    """DTensor placements (one per mesh dim) of ``spec``. A tensor dim on
    several axes shards in mesh order, the first axis outermost (JAX's
    order for ``("pod", "data")``); axes out of mesh order raise."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes if a is not None]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: axis {names[i]} used twice")
            out[i] = Shard(dim)
    return tuple(out)


def _apply(x, spec: Spec):
    """``x`` redistributed to ``spec``; a dim that its axes do not divide
    stays whole (GSPMD would pad it; DTensor's views take no uneven
    shards)."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    fitted = []
    for n, entry in zip(x.shape, spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for a in axes:
            size *= sizes[a] if a is not None else 1
        fitted.append(entry if n % size == 0 else None)
    placements = to_placements(tuple(fitted), mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def gather_fsdp(w):
    """A weight as a product takes it: inside ``mesh_axes``, a DTensor
    gathered on the batch axes (the fully sharded dim's all-gather, made
    before the product, as ZeRO-3 does), its shards on other axes kept;
    otherwise ``w`` itself."""
    if not active() or not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    keep = tuple(Replicate() if names[i] in _CTX["batch_axes"] else p
                 for i, p in enumerate(w.placements))
    if keep == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, keep)


class _ReducePartial(torch.autograd.Function):
    """Megatron's operator after a row-parallel product: all-reduce
    forward, identity backward with the gradient pinned to the forward
    output's placements. ``redistribute``'s own backward hands a partial
    gradient on as it came; a product's backward then gathers the
    weight's shard on ``model`` and runs at full width (some torch
    releases' DTensor strategies pick that), where a replicated gradient
    keeps it on the shard."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def reduce_partial(x):
    """Inside ``mesh_axes``, a DTensor's partial sums reduced (the
    all-reduce after a row-parallel product, Megatron's), so that what
    follows sees whole values, and the gradient handed back to the
    product replicated where the sums were partial
    (:class:`_ReducePartial`); otherwise ``x`` itself."""
    if not active() or not isinstance(x, DTensor) or not any(
            p.is_partial() for p in x.placements):
        return x
    return _ReducePartial.apply(x, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def like(t, ref):
    """``t`` (a plain tensor that meets ``ref`` in an op) as a DTensor
    replicated on ``ref``'s mesh when ``ref`` is a DTensor, else ``t``.
    ``implicit_replication`` does the same, but some torch releases give
    its DTensor one placement whatever the mesh's rank."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def replicate(x):
    """A DTensor whole on every rank; any other tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def constrain_acts(h):
    """Constrain (B, S, d) activations per the active policy."""
    if not active():
        return h
    if _CTX["seq_parallel"] and h.shape[1] % max(_CTX["model_size"], 1) == 0:
        # Megatron sequence-parallel between blocks: shard S on `model`
        spec = (_CTX["batch_axes"], _CTX["model_axis"], None)
    else:
        spec = (_CTX["batch_axes"], None, None)
    return _apply(h, spec)


def constrain_attn_q(q):
    """Shard (B, S, H, dh) attention activations.

    Heads shard on ``model`` when the head count divides the axis;
    otherwise the query sequence dim (context-parallel attention), else
    neither.
    """
    if not active():
        return q
    b, m, ms = _CTX["batch_axes"], _CTX["model_axis"], _CTX["model_size"]
    if ms <= 1:  # dp-only layout: the model axis carries batch
        return _apply(q, (b,) + (None,) * (q.ndim - 1))
    if q.shape[2] % max(ms, 1) == 0:
        spec = (b, None, m, None)
    elif q.shape[1] % max(ms, 1) == 0 and q.shape[1] > 1:
        spec = (b, m, None, None)
    else:
        spec = (b, None, None, None)
    return _apply(q, spec)


def constrain_attn_out(o):
    return constrain_attn_q(o)


def constrain(x, dims: Tuple):
    """Generic constraint: dims entries are 'batch' | 'model' | None.
    Dims that don't divide the axis size are replicated."""
    if not active():
        return x
    ms = max(_CTX["model_size"], 1)
    spec = []
    for i, d in enumerate(dims):
        if d == "batch":
            spec.append(_CTX["batch_axes"])
        elif d == "model":
            spec.append(_CTX["model_axis"]
                        if (ms > 1 and x.shape[i] % ms == 0) else None)
        else:
            spec.append(None)
    return _apply(x, tuple(spec))


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

_COL_PARALLEL = {"wq", "wk", "wv", "wz", "wx", "wdt", "w_gate", "w_up"}
_ROW_PARALLEL = {"wo", "w_down", "out_proj"}
_REPLICATED_LEAVES = {
    "scale", "bias", "router", "conv_B", "conv_C", "conv_bB", "conv_bC",
    "wB", "wC",
}
_MODEL_VECTOR = {"A_log", "D", "dt_bias", "norm_scale", "bq", "bk", "bv",
                 "conv_bx"}


def param_spec(name: str, ndim: int, *, model, fsdp) -> Spec:
    """The spec of the parameter called ``name`` (a port parameter name,
    ``layers.3.pos0.attn.wq``; the rule goes by its last component) with
    ``ndim`` dims. fsdp: axis name(s) for the fully-sharded dim, or None."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _REPLICATED_LEAVES:
        if leaf in ("wB", "wC"):  # (d, ds): shard input dim on fsdp only
            return (fsdp, None)
        return (None,) * ndim
    if leaf in _MODEL_VECTOR:
        return (model,)
    if leaf == "embed":
        return (model, fsdp)
    if leaf == "unembed":
        return (fsdp, model)
    if leaf == "patch_proj":
        return (None, model)
    if leaf == "conv_x":  # (K, di)
        return (None, model)
    if leaf in _COL_PARALLEL:
        if ndim == 3:  # MoE stacked experts (E, d, ff): TP on ff
            return (None, fsdp, model)
        return (fsdp, model)
    if leaf in _ROW_PARALLEL:
        if ndim == 3:  # MoE (E, ff, d)
            return (None, model, fsdp)
        return (model, fsdp)
    return (None,) * ndim  # fallback: replicate


def _named(params) -> Mapping[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return params


def param_specs(params, *, model: Optional[str] = "model",
                fsdp=None) -> Dict[str, Spec]:
    """{parameter name: spec} for a model (or tensors keyed by parameter
    names, such as an optimizer's moments)."""
    return {n: param_spec(n, t.ndim, model=model, fsdp=fsdp)
            for n, t in _named(params).items()}


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def batch_specs(batch_axes) -> Dict[str, Spec]:
    return {
        "tokens": (batch_axes, None),
        "targets": (batch_axes, None),
        "frontend": (batch_axes, None, None),
    }


def cache_specs(state, *, batch_axes, model: Optional[str],
                shard_seq: bool):
    """Specs for a decode state (:func:`~repro_torch.models.model.
    init_decode_state`), in its structure with a spec at each tensor.

    shard_seq: shard the KV-cache sequence dim on ``data`` (long_500k,
    batch=1).
    """

    def spec_for(name: str, leaf: torch.Tensor) -> Spec:
        if name in ("k", "v"):  # (B, T, Hkv, dh)
            if shard_seq:
                return (None, "data", None, None)
            return (batch_axes, None, None, None)
        if name == "pos":
            return ()
        if name == "ssm":  # (B, nh, ds, hd)
            b = None if shard_seq else batch_axes
            return (b, model, None, None)
        if name.startswith("conv_"):  # (B, K-1, ch)
            b = None if shard_seq else batch_axes
            return (b, None, model if name == "conv_x" else None)
        return (None,) * leaf.ndim

    def walk(node, name):
        if torch.is_tensor(node):
            return spec_for(name, node)
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        return node  # None: no cross K/V yet

    out = {k: walk(v, k) for k, v in state.items() if k != "xkv"}
    if "xkv" in state:  # per period: {"pos<i>": (k, v)}, each (B, Skv, Hkv, dh)
        xkv = state["xkv"]
        out["xkv"] = None if xkv is None else [
            {k: ((batch_axes, None, None, None),) * len(kv)
             for k, kv in per.items()} for per in xkv]
    return out


def map_specs(fn, specs, tensors):
    """``fn(spec, tensor)`` at each tensor of a tree (dicts, lists, tuples)
    and its spec tree of the same structure."""
    if torch.is_tensor(tensors):
        return fn(specs, tensors)
    if isinstance(tensors, dict):
        return {k: map_specs(fn, specs[k], v) for k, v in tensors.items()}
    if isinstance(tensors, (list, tuple)):
        return type(tensors)(map_specs(fn, s, t)
                             for s, t in zip(specs, tensors))
    return tensors


# ---------------------------------------------------------------------------
# placing tensors on a mesh
# ---------------------------------------------------------------------------

def distribute(t: torch.Tensor, mesh, placements) -> DTensor:
    """``t`` (the whole tensor, the same on every rank) as a DTensor of
    ``placements``: each rank keeps its own shard, with no communication
    (on ``meta``, a shard of shapes alone)."""
    return distribute_tensor(t.detach(), mesh, list(placements),
                             src_data_rank=None)


def place_params(model: torch.nn.Module, placements: Mapping[str, Tuple],
                 mesh) -> torch.nn.Module:
    """Each parameter of ``model`` replaced in place by a DTensor parameter
    of its ``placements`` (keyed by parameter name), its ``requires_grad``
    kept. Returns the model."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        module._parameters[leaf] = torch.nn.Parameter(
            distribute(p, mesh, placements[name]),
            requires_grad=p.requires_grad)
    return model
