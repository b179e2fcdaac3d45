"""Logical-axis-rule sharding (MaxText-style), with divisibility fallback,
as ``repro.parallel.sharding``, over a ``torch.distributed`` device mesh.

A *rule set* maps logical dim names (declared by ``ParamSpec.axes``, the
cache and batch specs, and activation constraints) to tuples of mesh axis
names. ``resolve(rules, axes, shape, mesh)`` produces a :data:`PSpec`:

  * mesh axes not present in the mesh are dropped,
  * a rule whose mesh-axis product does not divide the dim size is dropped
    (replicate instead), which is what makes one rule set serve every arch,
  * each mesh axis is used at most once per spec (first dim wins).

A ``PSpec`` is a tuple with one entry per dim, trailing ``None``s dropped:
``None``, an axis name, or a tuple of axis names (major first), the
entries of the reference's ``PartitionSpec``.

:class:`Mesh` names the axes and their sizes; a live one also holds the
``DeviceMesh`` over the process group. ``tree_shardings`` turns specs into
DTensor placements on it, ``distribute_tree`` places a tree by them, and
``use_mesh`` makes a mesh the one the model code sees (``get_mesh``), as
``jax.set_mesh`` does.

Presets:
  * ``dp_tp``  — batch over (pod, data); vocab/heads/ff/experts over model;
    params otherwise replicated.
  * ``fsdp``   — dp_tp + parameter/optimizer-state sharding over the data
    axis (ZeRO-3 style), the production default.
  * ``zero_dp`` — the model axis becomes extra batch parallelism; params
    and optimizer state shard over (data, model) on their big dim.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch import _tree

Rules = Dict[str, Tuple[str, ...]]
PSpec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# ---------------------------------------------------------------------------
# Rule presets.  Logical names:
#   params : embed ff heads kv_heads head_dim vocab experts q_lora kv_lora
#            ssm_inner ssm_state dt_rank conv_k layers
#   acts   : act_batch act_seq act_embed act_ff act_heads act_kv_seq act_vocab
# ---------------------------------------------------------------------------


def _mk(d):
    return {k: tuple(v) if isinstance(v, (list, tuple)) else (v,)
            for k, v in d.items()}


DP_TP_RULES: Rules = _mk({
    # parameters
    "vocab": "model",
    "heads": "model",
    "ff": "model",
    "experts": "model",
    "ssm_inner": "model",
    "q_lora": "model",
    # activations
    "act_batch": ("pod", "data"),
    "act_ff": "model",
    "act_heads": "model",
    "act_vocab": "model",
    "act_ssm_inner": "model",
    "act_kv_seq": "model",     # decode KV cache sharded along sequence
    "act_experts": "model",
    "act_moe_group": ("pod", "data"),   # MoE token-group dim
})

FSDP_RULES: Rules = dict(DP_TP_RULES, **_mk({
    # additionally shard the big param matrices over the data axis (ZeRO-3).
    "embed": ("data",),
    "moe_ff": ("model",),
    "kv_lora": ("data",),
}))

ZERO_DP_RULES: Rules = _mk({
    "embed": ("data", "model"),
    "ff": ("data", "model"),
    "vocab": ("data", "model"),
    "moe_ff": ("data", "model"),
    "experts": ("data", "model"),
    "ssm_inner": ("data", "model"),
    "q_lora": ("data", "model"),
    "kv_lora": ("data", "model"),
    "act_batch": ("pod", "data", "model"),
    "act_kv_seq": ("model",),
})

PRESETS: Dict[str, Rules] = {"dp_tp": DP_TP_RULES, "fsdp": FSDP_RULES,
                             "zero_dp": ZERO_DP_RULES}


def get_rules(preset: str, overrides: Sequence[Tuple[str, Tuple[str, ...]]] = ()) -> Rules:
    rules = dict(PRESETS[preset])
    for k, v in overrides:
        if v is None or v == ():
            rules.pop(k, None)
        else:
            rules[k] = tuple(v) if isinstance(v, (list, tuple)) else (v,)
    return rules


# ---------------------------------------------------------------------------
# The mesh.
# ---------------------------------------------------------------------------

class Mesh:
    """Mesh axes by name and size, in order (``shape``, a mapping, is all
    ``resolve`` reads). A live mesh also holds ``device_mesh``, the
    ``DeviceMesh`` over the process group, one process per device; an
    abstract one (``launch.mesh.make_production_mesh``) holds ``None``."""

    def __init__(self, shape: Dict[str, int], device_mesh=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.device_mesh = device_mesh
        self._groups: Dict[Tuple[str, ...], object] = {}

    @property
    def empty(self) -> bool:
        return not self.shape

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in axes if a in self.shape)

    def axis_size(self, axes) -> int:
        """The product of the sizes of ``axes`` (one name or several) that
        the mesh has."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def coord(self, axes) -> int:
        """This process's index along ``axes``, row-major over several (the
        first one major), 0 over axes the mesh lacks."""
        c = dict(zip(self.axis_names, self._live().get_coordinate()))
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def group(self, axes):
        """The process group over ``axes`` that holds this process. Groups
        over several axes are made the first time they are asked for: every
        process of the mesh must ask at the same point, as for any
        collective."""
        axes = self._axes(axes)
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"axes {axes} out of the mesh's order "
                             f"{self.axis_names}")
        dm = self._live()
        if len(axes) == 1:
            return dm.get_group(axes[0])
        if axes not in self._groups:
            import torch.distributed as dist
            ranks = dm.mesh.movedim(order, list(range(-len(order), 0)))
            ranks = ranks.reshape(-1, math.prod(self.shape[a] for a in axes))
            me = dist.get_rank()
            for row in ranks.tolist():       # every process makes every one
                g = dist.new_group(row)
                if me in row:
                    self._groups[axes] = g
        return self._groups[axes]

    def _live(self):
        if self.device_mesh is None:
            raise ValueError("an abstract mesh has no processes")
        return self.device_mesh

    def __repr__(self):
        kind = "live" if self.device_mesh is not None else "abstract"
        return f"Mesh({self.shape}, {kind})"


# ---------------------------------------------------------------------------
# Resolution.
# ---------------------------------------------------------------------------

def resolve(rules: Rules, axes: Tuple[Optional[str], ...],
            shape: Tuple[int, ...], mesh) -> PSpec:
    """Logical axes + dim sizes -> PSpec, with fallbacks. ``mesh`` is
    anything with a ``shape`` mapping of axis name -> size."""
    used = set()
    parts = []
    for name, size in zip(axes, shape):
        entry: Tuple[str, ...] = rules.get(name, ()) if name else ()
        picked = []
        prod = 1
        for ax in entry:
            if ax not in mesh.shape or ax in used:
                continue
            nax = mesh.shape[ax]
            if size % (prod * nax) != 0:
                continue
            picked.append(ax)
            prod *= nax
        for ax in picked:
            used.add(ax)
        if not picked:
            parts.append(None)
        elif len(picked) == 1:
            parts.append(picked[0])
        else:
            parts.append(tuple(picked))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def is_axes(x) -> bool:
    """A logical-axes tuple (a leaf of an axes tree)."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def tree_pspecs(rules: Rules, axes_tree, abstract_tree, mesh):
    """Tree of logical-axes tuples + tree of tensors (meta will do) ->
    tree of PSpec."""
    return _tree.tree_map(lambda axes, t: resolve(rules, axes, t.shape, mesh),
                          axes_tree, abstract_tree, is_leaf=is_axes)


@dataclass(frozen=True)
class NamedSharding:
    """Where a tensor lives on a live mesh: the ``DeviceMesh`` and one
    DTensor placement per mesh dim (``spec`` is the PSpec they come
    from)."""
    device_mesh: object
    placements: tuple
    spec: PSpec


def placements(spec: PSpec, mesh: Mesh) -> tuple:
    """PSpec -> one DTensor placement per mesh dim: ``Shard(d)`` on each
    mesh axis that splits dim ``d``, ``Replicate()`` on the others. Where
    one dim is split over several axes, DTensor nests the shards in mesh
    order (the earlier mesh dim major), which is the PSpec's layout when
    its axes come in mesh order, as every preset's do; an axis that the
    PSpec puts inside an axis later in the mesh takes ``_StridedShard``,
    whose split factor is the size of those later, more major, axes."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.axis_names)
    for dim, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        for i, ax in enumerate(names):
            j = mesh.axis_names.index(ax)
            sf = math.prod(mesh.shape[b] for b in names[:i]
                           if mesh.axis_names.index(b) > j)
            if sf == 1:
                out[j] = Shard(dim)
            else:
                from torch.distributed.tensor.placement_types import \
                    _StridedShard
                out[j] = _StridedShard(dim, split_factor=sf)
    return tuple(out)


def tree_shardings(rules: Rules, axes_tree, abstract_tree, mesh: Mesh):
    """Tree of :class:`NamedSharding` on the live ``mesh``."""
    dm = mesh._live()
    return _tree.tree_map(
        lambda s: NamedSharding(dm, placements(s, mesh), s),
        tree_pspecs(rules, axes_tree, abstract_tree, mesh), is_leaf=is_axes)


def distribute_tree(tree, shardings):
    """Place each tensor of ``tree`` by its :class:`NamedSharding` (a
    DTensor per leaf). Every process of the mesh must call it with the
    same full tensors: ``distribute_tensor`` sends each process its shard
    of the first process's copy."""
    from torch.distributed.tensor import distribute_tensor
    return _tree.tree_map(lambda x, s: distribute_tensor(
        x, s.device_mesh, list(s.placements)), tree, shardings)


# ---------------------------------------------------------------------------
# The active mesh.
# ---------------------------------------------------------------------------

_ACTIVE = []        # the meshes in use; the last one is the model code's


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the one the model code sees until the block ends, as
    ``jax.set_mesh``."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def get_mesh() -> Optional[Mesh]:
    return _ACTIVE[-1] if _ACTIVE else None


def constrain(x, rules: Rules, *names: Optional[str]):
    """Sharding-constrain an activation by logical dim names: a no-op
    without a mesh, and on a mesh whose ``model`` axis has size 1 (the
    batch axes are split by the step that runs the model). Nothing in the
    port calls it yet: the model's activation sites go through it with
    tensor parallelism over ``model``, which the steps refuse for now
    (``optim.grad_compress.check_mesh``)."""
    mesh = get_mesh()
    if mesh is None or mesh.empty:
        return x
    spec = resolve(rules, tuple(names), tuple(x.shape), mesh)
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            f"tensor parallelism over 'model' (size {mesh.shape['model']}; "
            f"activation {names} -> {spec}) is not in the port yet: the "
            f"port runs a model axis of size 1")
    return x
