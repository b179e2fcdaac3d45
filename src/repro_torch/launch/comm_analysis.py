"""Per-device cost accounting of one step: collectives, FLOPs, bytes and
memory, the counterpart of ``repro.launch.hlo_analysis``.

The reference reads XLA's post-SPMD HLO text: ``cost_analysis`` for FLOPs
and bytes, ``memory_analysis`` for memory, and a regex pass over the
collective instructions for link bytes. The port has no HLO. It runs the
step once (in the dry run on fake tensors over a fake process group) under
:class:`Recorder`, a ``TorchDispatchMode`` that sees every op one process
runs on its local shards:

  * collectives at the functional level (``_c10d_functional.*`` and
    DTensor's ``_dtensor.shard_dim_alltoall``, which DTensor issues) and
    the ``c10d`` ops that ``parallel._collectives`` issues, each kept as a
    :class:`Collective` (kind, result shape, dtype, replica groups). A
    collective is counted as the program asked for it: the fake CPU group
    has no all-to-all and runs one as an all-gather plus a chunk, which
    is not counted again;
  * FLOPs of the local ops by ``torch.utils.flop_counter``'s formulas (the
    kernels' custom ops register theirs). Ops on DTensors are not counted:
    their local ops are, so the count is per device;
  * ``bytes``: each local op's input and output bytes, views and
    metadata ops aside. XLA's "bytes accessed" is taken after fusion;
    this is the unfused sum, an upper bound of the traffic;
  * memory: the peak of the bytes of the storages the step's ops made
    that are alive at once (``temp_bytes``), above the arguments alive
    before the step, reachable ones only (the collector runs before each
    new high). DTensor's shape inference on global shapes is not counted
    (see ``Recorder``).

Link bytes per collective use the reference's ring accounting
(``collective_bytes``, ``hlo_analysis.py:61-92``) and its intra/cross
split (``collective_bytes_by_span``, ``:115-158``), here by node of
``NODE_SIZE`` ranks.
"""
from __future__ import annotations

import functools
import gc
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.launch.roofline import NODE_SIZE

@dataclass(frozen=True)
class Collective:
    """One collective one process issued: the per-process result's shape
    and dtype, and the replica groups (global ranks) it ran over: every
    group of the mesh dim when known, else this process's own.
    ``pairs``: a permute's (source, target) ranks."""
    kind: str
    shape: Tuple[int, ...]
    dtype: str
    groups: Tuple[Tuple[int, ...], ...] = ()
    pairs: Tuple[Tuple[int, int], ...] = ()

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * torch.empty(
            (), dtype=getattr(torch, self.dtype)).element_size()

    @property
    def group_size(self) -> int:
        return len(self.groups[0]) if self.groups else 1


def moved_bytes(c: Collective) -> float:
    """Per-device link bytes of one collective, ring accounting:

      all-gather          (g-1)/g * result
      all-reduce          2 (g-1)/g * result
      reduce-scatter      (g-1) * result           (operand = g * result)
      all-to-all          (g-1)/g * result
      collective-permute  result
    """
    g, n = c.group_size, c.nbytes
    if g <= 1 and c.kind != "collective-permute":
        return 0.0
    if c.kind == "all-gather":
        return n * (g - 1) / g
    if c.kind == "all-reduce":
        return 2.0 * n * (g - 1) / g
    if c.kind == "reduce-scatter":
        return float(n) * (g - 1)
    if c.kind == "all-to-all":
        return n * (g - 1) / g
    return float(n)


def collective_bytes(records: Sequence[Collective]) -> Dict[str, float]:
    """Per-device link bytes by collective kind, and their ``total``."""
    out: Dict[str, float] = {}
    for c in records:
        moved = moved_bytes(c)
        if moved or c.group_size > 1:
            out[c.kind] = out.get(c.kind, 0.0) + moved
    out["total"] = sum(out.values())
    return out


def crosses(c: Collective, span: int) -> bool:
    """Whether the collective's groups (or a permute's pairs) mix ranks of
    two blocks of ``span`` consecutive ranks."""
    if c.kind == "collective-permute":
        return any(a // span != b // span for a, b in c.pairs)
    if not c.groups:
        return False
    blocks = np.asarray(c.groups) // span
    return bool(np.any(blocks != blocks[:, :1]))


def collective_bytes_by_span(records: Sequence[Collective],
                             span: int = NODE_SIZE) -> Dict[str, float]:
    """Per-device collective bytes split into those inside a block of
    ``span`` ranks (``intra``: a node's NVLink) and those that cross one
    (``cross``: the inter-node links)."""
    out = {"intra": 0.0, "cross": 0.0}
    for c in records:
        out["cross" if crosses(c, span) else "intra"] += moved_bytes(c)
    return out


# ---------------------------------------------------------------------------
# The recorder.
# ---------------------------------------------------------------------------

def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def mesh_groups(device_mesh) -> Dict[str, Tuple[Tuple[int, ...], ...]]:
    """{process group name: every group of that mesh dim, global ranks}
    for each dim of ``device_mesh``."""
    ranks = np.asarray(device_mesh.mesh.tolist())
    out = {}
    for d in range(device_mesh.ndim):
        rows = np.moveaxis(ranks, d, -1).reshape(-1, ranks.shape[d])
        out[device_mesh.get_group(d).group_name] = tuple(
            tuple(int(r) for r in row) for row in rows)
    return out


def _group_ranks(group_name: str, known) -> Tuple[Tuple[int, ...], ...]:
    """The groups ``known`` holds for ``group_name``, else this process's
    group."""
    if group_name in known:
        return known[group_name]
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    return (tuple(dist.get_process_group_ranks(
        _resolve_process_group(group_name))),)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _on_meta(*trees) -> bool:
    """Whether any tensor in ``trees`` is on the meta device: shape
    inference (DTensor traces some ops' decompositions on meta tensors of
    the global shapes to find a layout), never the step's own work, whose
    tensors are on the step's device."""
    return any(isinstance(t, torch.Tensor) and t.device.type == "meta"
               for t in tree_flatten(trees)[0])


def _storage_key(t) -> int:
    """The identity of ``t``'s storage while it lives."""
    return StorageWeakRef(t.untyped_storage()).cdata


_METADATA = {"aten.empty", "aten.empty_strided", "aten.empty_like",
             "aten.lift_fresh", "prim.device", "aten.sym_size",
             "aten.sym_stride", "aten.sym_numel", "aten.detach",
             "aten._local_scalar_dense", "_c10d_functional.wait_tensor",
             "aten.alias", "aten.is_same_size", "aten.new_empty",
             "aten.new_empty_strided"}


class _Uncounted:
    """A context in which ``recorder`` counts nothing."""

    def __init__(self, recorder):
        self.recorder = recorder

    def __enter__(self):
        self.recorder._inside += 1

    def __exit__(self, *exc):
        self.recorder._inside -= 1


class Recorder(TorchDispatchMode):
    """Counts what one process runs while it is active (see the module's
    note). ``meshes``: the device meshes whose dims name the replica
    groups (read when the recorder is made, outside any fake mode);
    ``fake_mode``: the step's fake mode, if its tensors are fake. ``stage``: the key the counts also go to (``by_stage``), set
    by :meth:`observe_stage` around each repeat of a model stage."""

    def __init__(self, meshes=(), fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.groups = {k: v for dm in meshes
                       for k, v in mesh_groups(dm).items()}
        self.collectives = []
        self.flops = 0
        self.kernel_flops: Dict[str, int] = {}    # the kernels' custom ops
        self.bytes = 0
        self.by_stage: Dict[str, Dict[str, float]] = {}
        self.stage: Optional[str] = None
        self._storages: Dict[int, Tuple[StorageWeakRef, int]] = {}
        self.live = 0           # bytes of the counted storages alive
        self.peak = 0
        self._collected_at = 0
        self._inside = 0

    # ---------------------------------------------------------- counting
    def _add(self, key, n):
        if self.stage is not None:
            st = self.by_stage.setdefault(self.stage, {
                "flops": 0, "bytes": 0, "collective_bytes": 0.0})
            st[key] += n

    def _collective(self, kind, out, group_name, pairs=()):
        outs = out if isinstance(out, (list, tuple)) else [out]
        groups = _group_ranks(group_name, self.groups)
        for t in outs:
            c = Collective(kind, tuple(t.shape), _dtype_name(t), groups,
                           tuple(pairs))
            self.collectives.append(c)
            self._add("collective_bytes", moved_bytes(c))

    def _allocated(self, outs, ins):
        """Count the storages ``outs`` hold that are new: not an input's
        (in place), not one already counted. Memory is tracked by storage,
        as the allocator holds it: a tensor object can die while a view of
        its storage lives on (the layer inputs a checkpoint keeps)."""
        own = {_storage_key(a) for a in ins if isinstance(a, torch.Tensor)}
        for t in outs:
            key = _storage_key(t)
            if key in own or (key in self._storages
                              and not self._storages[key][0].expired()):
                continue
            st = t.untyped_storage()
            self._storages[key] = (StorageWeakRef(st), st.nbytes())
            self.live += st.nbytes()
        if self.live > self.peak:
            self._prune()
            # storages held only by reference cycles (autograd's and the
            # DTensor wrappers') wait for the collector: collect before a
            # new high is taken, so the peak counts reachable storages
            if self.live > self.peak and \
                    self.live > 1.05 * self._collected_at:
                gc.collect()
                self._prune()
                self._collected_at = self.live
            self.peak = max(self.peak, self.live)

    def _prune(self):
        """Drop the storages that have been freed."""
        for key in [k for k, (ref, _) in self._storages.items()
                    if ref.expired()]:
            self.live -= self._storages.pop(key)[1]

    # DTensor infers each op's output layout by running it once on fake
    # tensors of the global shapes
    # (``ShardingPropagator._propagate_tensor_meta_non_cached``). Those runs
    # are not the process's work, and they run in the fake mode in use
    # (torch 2.11 and 2.13 alike), so while recording they are marked as
    # uncounted. Without the mark a cell counts global tensors as its own
    # (full tinyllama's 134 GB of f32 logits on a (16, 16) mesh), and only
    # where DTensor's cache of propagations misses, which depends on what
    # ran before in the process. Ops on meta tensors (DTensor's traces of
    # decompositions, 2.13) are not counted either (``_on_meta``).
    #
    # DTensor's all-to-all between two splits of a mesh dim
    # (``placement_types.shard_dim_alltoall``) runs as an all-gather and a
    # chunk on a CPU mesh, whose group has no all-to-all; while recording,
    # it counts as the all-to-all it stands for.
    _HOOKS = (("torch.distributed.tensor._sharding_prop",
               "ShardingPropagator", "_propagate_tensor_meta_non_cached",
               "_uncounted_call", True),
              ("torch.distributed.tensor", "placement_types",
               "shard_dim_alltoall", "_alltoall", False))

    def __enter__(self):
        import importlib
        self._saved = []
        for mod, owner, name, mine, required in self._HOOKS:
            obj = getattr(importlib.import_module(mod), owner, None)
            if obj is None or not hasattr(obj, name):
                if required:
                    raise RuntimeError(
                        f"comm_analysis: {mod}.{owner}.{name} is missing on "
                        f"torch {torch.__version__}: DTensor's shape "
                        f"inference could not be told from the step's ops")
                continue
            self._saved.append((obj, name, getattr(obj, name)))
            setattr(obj, name, getattr(self, mine)(getattr(obj, name)))
        # the collections before each new high then scan only the objects
        # made while recording, not the whole process's heap
        gc.collect()
        gc.freeze()
        return super().__enter__()

    def __exit__(self, *exc):
        gc.unfreeze()
        for obj, name, old in self._saved:
            setattr(obj, name, old)
        return super().__exit__(*exc)

    def _uncounted_call(self, run):
        rec = self

        @functools.wraps(run)
        def call(*args, **kwargs):
            with _Uncounted(rec):
                return run(*args, **kwargs)
        return call

    def _ours(self, flat) -> bool:
        """Whether an op's fake tensors (if any) are the step's."""
        from torch._subclasses.fake_tensor import FakeTensor
        return all(a.fake_mode is self.fake_mode for a in flat
                   if isinstance(a, FakeTensor))

    def _alltoall(self, run):
        return functools.partial(self._alltoall_as_one, run)

    def _alltoall_as_one(self, run, input, gather_dim, shard_dim, mesh,
                         mesh_dim):
        if mesh.device_type != "cpu":       # the op itself is recorded
            return run(input, gather_dim, shard_dim, mesh, mesh_dim)
        with _Uncounted(self):
            out = run(input, gather_dim, shard_dim, mesh, mesh_dim)
        self._collective("all-to-all", out,
                         mesh.get_group(mesh_dim).group_name)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(t is DTensor for t in types):
            # DTensor runs the op as its redistributions and local ops,
            # which come back through here
            return NotImplemented
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if self._inside or not self._ours(flat):
            return func(*args, **kwargs)
        name = str(func.overloadpacket)
        ns = name.split(".")[0]
        if ns in ("_c10d_functional", "_dtensor", "c10d") \
                and name not in _METADATA:
            self._inside += 1
            try:
                out = func(*args, **kwargs)
            finally:
                self._inside -= 1
            self._record_collective(name, args, out)
            self._allocated([t for t in tree_flatten(out)[0]
                             if isinstance(t, torch.Tensor)], flat)
            return out
        out = func(*args, **kwargs)
        if name in _METADATA or func.is_view or _on_meta(flat, out):
            return out
        from torch.utils.flop_counter import flop_registry
        if func.overloadpacket in flop_registry:
            n = flop_registry[func.overloadpacket](*args, **kwargs,
                                                   out_val=out)
            self.flops += n
            self._add("flops", n)
            if ns == "repro_torch":
                op = name.split(".")[1]
                self.kernel_flops[op] = self.kernel_flops.get(op, 0) + n
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        ins = [t for t in flat if isinstance(t, torch.Tensor)]
        n = sum(map(_nbytes, ins)) + sum(_nbytes(t) for t in outs
                                        if not any(t is a for a in ins))
        self.bytes += n
        self._add("bytes", n)
        self._allocated(outs, ins)
        return out

    def _record_collective(self, name, args, out):
        op = name.split(".")[1]
        if op in ("all_gather_into_tensor", "all_gather_into_tensor_coalesced"):
            self._collective("all-gather", out, args[-1])
        elif op in ("reduce_scatter_tensor",
                    "reduce_scatter_tensor_coalesced"):
            self._collective("reduce-scatter", out, args[-1])
        elif op in ("all_reduce", "all_reduce_coalesced"):
            self._collective("all-reduce", out, args[-1])
        elif op in ("all_to_all_single", "shard_dim_alltoall"):
            self._collective("all-to-all", out, args[-1])
        elif op in ("allreduce_", "allgather_", "alltoall_base_"):
            self._c10d(op, args, out)
        elif op != "wait_tensor":
            raise NotImplementedError(f"collective {name} not accounted")

    def _c10d(self, op, args, out):
        """The in-place ``c10d`` ops (``torch.distributed``'s calls):
        group from their process-group argument."""
        import torch.distributed as dist
        pg = dist.ProcessGroup.unbox(next(      # a ScriptObject here
            a for a in args if isinstance(a, torch.ScriptObject)
            and "ProcessGroup" in str(a._type())))
        ranks = _group_ranks(pg.group_name, self.groups)
        kind = {"allreduce_": "all-reduce", "allgather_": "all-gather",
                "alltoall_base_": "all-to-all"}[op]
        res = tree_flatten(args[0])[0]
        shape = tuple(res[0].shape)
        if kind == "all-gather":        # a list of per-rank outputs
            shape = (len(res) * shape[0],) + shape[1:]
        c = Collective(kind, shape, _dtype_name(res[0]), ranks)
        self.collectives.append(c)
        self._add("collective_bytes", moved_bytes(c))

    # ----------------------------------------------------------- stages
    def observe_stage(self, key, fn):
        """``fn`` (one repeat of stage ``key``: ``x, ... -> (x, ...)``)
        with its counts, forward and backward, also kept under ``key``:
        the backward's from the gradient reaching the repeat's output to
        the one leaving its input."""
        rec = self

        def run(x, *args):
            prev, rec.stage = rec.stage, key
            try:
                out = fn(x, *args)
            finally:
                rec.stage = prev
            y = out[0]
            if torch.is_grad_enabled() and y.requires_grad:
                y.register_hook(lambda g: rec._set_stage(key))
                if x.requires_grad:
                    x.register_hook(lambda g: rec._set_stage(None))
            return out
        return run

    def _set_stage(self, key):
        self.stage = key
