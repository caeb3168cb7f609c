"""Checkpoint manager: atomic, async, in the JAX package's file format.

The PyTorch counterpart of the JAX package's ``checkpoint/manager.py``:

* **Atomic**: written to ``<dir>/tmp.<step>.npz``, then ``os.replace``d to
  ``ckpt_<step:010d>.npz``; a crash mid-write never corrupts the latest
  checkpoint.
* **Async**: ``save_async`` copies the tree to host memory at once and
  writes it on a background thread.
* **The reference's format and keys**: one ``.npz`` of global arrays
  keyed by the ``|``-joined path of each leaf in the reference's tree
  (``0|layers|pos0|attn|wq`` for ``(params, opt_state)``, each layer leaf
  stacked on its ``n_periods`` axis; ``1|step``, ``1|m|...``, ``1|v|...``),
  bfloat16 stored as float32, and the metadata as JSON under
  ``__meta__``. A checkpoint written by either package restores in the
  other.

A tree is any nesting of dicts, tuples and lists over tensors, numpy
arrays and numbers, where a model (:class:`torch.nn.Module`) stands for
the reference's parameter tree and an :class:`~repro_torch.optim.adamw.
OptState` for its optimizer state. :meth:`CheckpointManager.restore`
fills a template of that shape: a model's parameters are replaced in
place, every other leaf is a new tensor with the template's dtype and
device. A DTensor is saved as its global array (every rank gathers it;
pass the same ``step`` on every rank, and let one write) and restored
under the current mesh, the reference's elastic restore.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.convert import jax_path, jax_tree
from repro_torch.optim.adamw import OptState
from repro_torch.train.sharding import distribute

SEP = "|"


def _host(x) -> np.ndarray:
    """A leaf as a numpy array on the host, bfloat16 as float32 (a DTensor
    as its global array)."""
    if torch.is_tensor(x):
        x = x.detach()
        if isinstance(x, DTensor):
            x = x.full_tensor()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _as_tree(obj):
    """The reference's structure of a model or an optimizer state, with
    host arrays at its leaves; other nodes as they are."""
    if isinstance(obj, torch.nn.Module):
        return jax_tree({n: _host(p) for n, p in obj.named_parameters()})
    if isinstance(obj, OptState):
        return {"step": obj.step,
                "m": jax_tree({n: _host(t) for n, t in obj.m.items()}),
                "v": jax_tree({n: _host(t) for n, t in obj.v.items()})}
    return obj


def _flatten(tree, prefix=()) -> Dict[str, np.ndarray]:
    tree = _as_tree(tree)
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {SEP.join(prefix): _host(tree)}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, prefix + (str(k),)))
    return flat


def _get(flat, key: str):
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key}")
    return flat[key]


def _like(arr, template, place=None, mesh=None):
    """A stored array as a tensor of ``template``'s dtype and device; a
    DTensor of ``place`` on ``mesh`` when given, else of the template's
    own placements when it is a DTensor (each rank keeps its shard of the
    global array)."""
    arr = np.asarray(arr)
    t = torch.as_tensor(arr.astype(np.float32) if template.is_floating_point()
                        else arr).to(dtype=template.dtype,
                                     device=template.device)
    if place is None and isinstance(template, DTensor):
        place, mesh = template.placements, template.device_mesh
    return t if place is None else distribute(t, mesh, place)


def _leaf(flat, key: str, template, place=None, mesh=None):
    """The stored array at ``key`` as a tensor like ``template``."""
    arr = _get(flat, key)
    if torch.is_tensor(template):
        return _like(arr, template, place, mesh)
    return np.asarray(arr).astype(np.asarray(template).dtype)


def _named_leaf(flat, prefix, name: str):
    """The stored slice of the stacked leaf a port parameter name maps to."""
    path, idx = jax_path(name)
    arr = _get(flat, SEP.join(prefix + path))
    return arr if idx is None else arr[idx]


def _unflatten_like(template, flat, prefix=(), place=None, mesh=None):
    """``template``'s structure filled from ``flat``; ``place``: None or a
    tree of placements of the same structure (a model's and the
    moments' keyed by parameter name)."""
    if isinstance(template, torch.nn.Module):
        for name, p in list(template.named_parameters()):
            arr = _named_leaf(flat, prefix, name)
            if tuple(np.shape(arr)) != tuple(p.shape):
                raise ValueError(f"{name}: stored {np.shape(arr)}, "
                                 f"model {tuple(p.shape)}")
            t = _like(arr, p, None if place is None else place[name], mesh)
            owner, _, leaf = name.rpartition(".")
            module = template.get_submodule(owner) if owner else template
            module._parameters[leaf] = torch.nn.Parameter(
                t, requires_grad=p.requires_grad)
        return template
    if isinstance(template, OptState):
        def moments(which, named):
            sub = None if place is None else getattr(place, which)
            return {n: _like(_named_leaf(flat, prefix + (which,), n), t,
                             None if sub is None else sub[n], mesh)
                    for n, t in named.items()}

        return OptState(step=_leaf(flat, SEP.join(prefix + ("step",)),
                                   template.step,
                                   None if place is None else place.step,
                                   mesh),
                        m=moments("m", template.m), v=moments("v", template.v))
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, prefix + (str(k),),
                                   None if place is None else place[k], mesh)
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(
            _unflatten_like(v, flat, prefix + (str(i),),
                            None if place is None else place[i], mesh)
            for i, v in enumerate(template))
    return _leaf(flat, SEP.join(prefix), template, place, mesh)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -------------------- write --------------------
    def _write(self, step: int, host_flat: Dict[str, np.ndarray], meta: Dict):
        tmp = os.path.join(self.dir, f"tmp.{step}.npz")
        final = os.path.join(self.dir, f"ckpt_{step:010d}.npz")
        np.savez(tmp, __meta__=json.dumps(meta), **host_flat)
        os.replace(tmp, final)
        self._gc()

    def save(self, step: int, tree, meta: Optional[Dict] = None,
             block: bool = True):
        """Snapshot ``tree`` at ``step`` (copied to the host before this
        returns, also when the write is left to a thread). In a process
        group every rank calls it (a DTensor's global array is gathered
        by all) and rank 0 writes."""
        self.wait()
        host = _flatten(tree)
        if dist.is_initialized() and dist.get_rank() != 0:
            return  # every rank gathered its DTensors; rank 0 writes
        meta = dict(meta or {}, step=step)
        if block:
            self._write(step, host, meta)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True)
            self._thread.start()

    def save_async(self, step: int, tree, meta: Optional[Dict] = None):
        self.save(step, tree, meta, block=False)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        ckpts = sorted(f for f in os.listdir(self.dir) if f.startswith("ckpt_"))
        for f in ckpts[: -self.keep] if self.keep else []:
            os.remove(os.path.join(self.dir, f))

    # -------------------- read --------------------
    def latest_step(self) -> Optional[int]:
        self.wait()
        ckpts = sorted(f for f in os.listdir(self.dir) if f.startswith("ckpt_"))
        if not ckpts:
            return None
        return int(ckpts[-1][len("ckpt_"): -len(".npz")])

    def restore(self, step: int, template, placements=None,
                mesh=None) -> Tuple[Any, Dict]:
        """The checkpoint of ``step`` in the shape of ``template`` (see the
        module note), and its metadata.

        placements: optional tree of DTensor placements like the
        template's (``launch.specs.cell_shardings``' ``params`` for a
        model, an ``OptState`` of them for its optimizer state) on
        ``mesh``: the elastic restore, each rank taking its shards of the
        stored global arrays under the *current* mesh, whatever mesh
        wrote them. Without it, a template's DTensor is restored with its
        own placements.
        """
        self.wait()
        path = os.path.join(self.dir, f"ckpt_{step:010d}.npz")
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            flat = {k: z[k] for k in z.files if k != "__meta__"}
        return _unflatten_like(template, flat, place=placements,
                               mesh=mesh), meta
