"""Checkpointing: pytree <-> npz with topology metadata, async save,
MDSS-versioned URIs, and elastic restore onto a different mesh
(``repro.checkpoint.checkpointer``).

  * every save records the step and the topology it was written for;
    leaves are keyed ``a/b/c`` by their path, the keys the reference's
    ``jax.tree`` paths give for the same tree; a DTensor leaf (a sharded
    tree) is saved as its full tensor, gathered on every process and
    written by rank 0, synchronously,
  * restore re-shards: with ``shardings`` (``Model.param_shardings`` on
    the target mesh) each leaf becomes a DTensor placed by its sharding,
    so a checkpoint written on one mesh restores onto another,
  * saves are published through MDSS (``ckpt://<name>/latest``) so
    residency and versioning are tracked like workflow data,
  * async mode hands serialization to a background thread; the device to
    host copy happens in ``save``, before that thread starts, so the
    training loop may go on with its tensors,
  * atomic rename-on-complete: a crash mid-save never corrupts the latest
    checkpoint (a restart skips partial files).

bfloat16 leaves are stored as their 16-bit pattern (numpy has no
bfloat16) and restored to the template's dtype.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import _tree


def _paths(tree, prefix=()):
    """(key path, leaf) pairs in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [pl for k, v in items for pl in _paths(v, prefix + (k,))]


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _host_array(x) -> np.ndarray:
    """A host numpy copy sharing no storage with ``x``; bfloat16 as its
    16-bit pattern."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t
                ).numpy()
    return np.array(x)


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    return {_key(path): _host_array(leaf) for path, leaf in _paths(tree)}


def _unflatten_like(template, arrays: Dict[str, np.ndarray]):
    leaves = []
    for path, leaf in _paths(template):
        key = _key(path)
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                             f"{tuple(leaf.shape)}")
        t = torch.from_numpy(np.array(arr))
        if leaf.dtype == torch.bfloat16 and t.dtype == torch.int16:
            t = t.view(torch.bfloat16)
        leaves.append(t.to(leaf.dtype))
    return _tree.unflatten_like(template, leaves)


class Checkpointer:
    def __init__(self, directory: str, *, mdss=None, async_save: bool = False):
        self.dir = directory
        self.mdss = mdss
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, name: str, step: int, tree, *, topology: Dict[str, Any]):
        """A tree of DTensors is saved by every process of the process
        group together and synchronously, whatever ``async_save`` says:
        each leaf's full tensor is gathered on every process (a
        collective), only rank 0 copies it to the host and writes, and
        every process returns once the file is in place, so any of them
        may restore it next."""
        if any(hasattr(x, "full_tensor") for x in _tree.tree_leaves(tree)):
            import torch.distributed as dist
            rank0 = dist.get_rank() == 0
            arrays = {}
            for path, leaf in _paths(tree):
                if hasattr(leaf, "full_tensor"):
                    leaf = leaf.full_tensor()
                if rank0:
                    arrays[_key(path)] = _host_array(leaf)
            if rank0:
                self.wait()
                self._write(name, step, arrays, topology)
            dist.barrier()
            return
        arrays = _flatten_with_paths(tree)   # device -> host copy happens here
        if self.async_save:
            self.wait()
            t = threading.Thread(
                target=self._write, args=(name, step, arrays, topology))
            t.start()
            self._pending = t
        else:
            self._write(name, step, arrays, topology)

    def _write(self, name, step, arrays, topology):
        path = os.path.join(self.dir, f"{name}-{step:08d}.npz")
        tmp = path + ".tmp.npz"   # .npz suffix so np.savez writes exactly here
        meta = dict(topology=topology, step=step, time=time.time())
        np.savez(tmp, __meta__=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8), **arrays)
        os.replace(tmp, path)
        with open(os.path.join(self.dir, f"{name}-latest"), "w") as f:
            f.write(str(step))
        if self.mdss is not None:
            self.mdss.put(f"ckpt://{name}/latest", {"path": path, "step": step},
                          tier="local")

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    # --------------------------------------------------------------- restore
    def latest_step(self, name: str) -> Optional[int]:
        p = os.path.join(self.dir, f"{name}-latest")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def restore(self, name: str, template, *, step: Optional[int] = None,
                shardings=None) -> Tuple[Any, Dict[str, Any]]:
        """Host tensors of ``template``'s structure, shapes and dtypes
        (``template``'s leaves need only ``shape`` and ``dtype``: meta
        tensors will do); with ``shardings`` (a tree of
        ``parallel.sharding.NamedSharding``, possibly of a *different*
        mesh than the save's: elastic), DTensors placed by them, which
        every process of that mesh must restore together."""
        self.wait()
        if step is None:
            step = self.latest_step(name)
            if step is None:
                raise FileNotFoundError(f"no checkpoint for {name} in {self.dir}")
        path = os.path.join(self.dir, f"{name}-{step:08d}.npz")
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
        tree = _unflatten_like(template, arrays)
        if shardings is not None:
            from repro_torch.parallel.sharding import distribute_tree
            tree = distribute_tree(tree, shardings)
        return tree, meta
