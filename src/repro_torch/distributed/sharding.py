"""Logical-axis sharding rules with divisibility-aware fallback (the JAX
package's ``repro.distributed.sharding`` in PyTorch).

Models annotate tensors with *logical* dimension names ("batch", "heads",
"mlp", ...).  ``ShardingRules`` maps logical names to mesh axes and resolves
a concrete ``PartitionSpec`` for a given shape.  A dimension that is not
divisible by its mesh-axes product falls back to replication, so odd head
counts (25) and odd vocabularies (50280, 32001, 256206) never fail.

The port keeps its own ``PartitionSpec``: a tuple of per-dimension entries,
each None, an axis name or a tuple of names, equal to JAX's entry for
entry.  A ``DeviceMesh`` takes DTensor placements, one per *mesh*
dimension, so ``placements`` turns a spec around: a tensor dimension
sharded over two mesh axes becomes ``Shard(d)`` on both.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

Axes = Union[None, str, Tuple[str, ...]]


class PartitionSpec:
    """Per-tensor-dimension mesh axes: ``P(None, "model")``.  It indexes and
    iterates like the tuple of its entries and equals any sequence with the
    same entries; it is not a tuple itself, so a tree of specs keeps each
    spec as one leaf (``repro_torch.tree``)."""

    __slots__ = ("_parts",)

    def __init__(self, *parts: Axes):
        self._parts = tuple(parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        try:
            return self._parts == tuple(other)
        except TypeError:
            return NotImplemented

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return f"P{self._parts!r}"


P = PartitionSpec


def _as_tuple(a: Axes) -> Tuple[str, ...]:
    if a is None:
        return ()
    if isinstance(a, str):
        return (a,)
    return tuple(a)


@dataclass(frozen=True)
class ShardingRules:
    """logical dim name -> mesh axes."""

    mesh_axes: Dict[str, int]  # axis name -> size (from the mesh)
    table: Dict[str, Axes] = field(default_factory=dict)

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.mesh_axes[a] for a in _as_tuple(axes)) or 1

    def resolve_dim(self, dim_size: int, logical: Optional[str]) -> Axes:
        if logical is None:
            return None
        axes = self.table.get(logical)
        if axes is None:
            return None
        n = self.axis_size(axes)
        if n <= 1 or dim_size % n != 0:
            return None  # divisibility fallback -> replicate this dim
        t = _as_tuple(axes)
        return t[0] if len(t) == 1 else t

    def spec(self, shape: Sequence[int], logical_dims: Sequence[Optional[str]]) -> P:
        assert len(shape) == len(logical_dims), (shape, logical_dims)
        used: set = set()
        parts = []
        for dim, name in zip(shape, logical_dims):
            ax = self.resolve_dim(dim, name)
            # one mesh axis may appear at most once in a spec
            t = _as_tuple(ax)
            if any(a in used for a in t):
                ax = None
                t = ()
            used.update(t)
            parts.append(ax)
        return P(*parts)

    def with_overrides(self, **table_updates: Axes) -> "ShardingRules":
        new = dict(self.table)
        new.update(table_updates)
        return replace(self, table=new)


def rules_for_mesh(mesh, overrides: Optional[Dict[str, Axes]] = None) -> ShardingRules:
    """Default production rules for a ``DeviceMesh``.

    batch  -> all data-like axes ("pod", "data")
    model-parallel dims ("heads", "kv_heads", "mlp", "vocab", "expert",
    "dinner") -> "model".  "seq" is unsharded by default.
    """
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    data_axes = tuple(a for a in ("pod", "data") if a in axes)
    model = "model" if "model" in axes else None
    table: Dict[str, Axes] = {
        "batch": data_axes if data_axes else None,
        "seq": None,
        "embed": None,
        "heads": model,
        "kv_heads": model,
        "qkv_flat": model,
        "mlp": model,
        "expert_ff": model,
        "vocab": model,
        "embed_alt": model,  # fallback for odd vocab
        "expert": model,
        "dinner": model,
        "dstate": None,
        "opt": None,  # ZeRO-1: override to data axes to shard optimizer state
    }
    if overrides:
        table.update(overrides)
    return ShardingRules(mesh_axes=axes, table=table)


def placements(mesh, spec: Sequence[Axes]) -> List[Any]:
    """DTensor placements on ``mesh`` for a spec: ``Shard(d)`` on each mesh
    dimension that shards tensor dimension d, ``Replicate()`` elsewhere.  A
    tensor dimension sharded over several axes must name them in the
    mesh's order (major to minor), as DTensor splits it."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _as_tuple(entry)
        at = [names.index(a) for a in axes]
        if at != sorted(at):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order {names}")
        for i in at:
            out[i] = Shard(d)
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> List[Any]:
        return placements(self.mesh, self.spec)


def named_sharding(mesh, rules: ShardingRules, shape, logical_dims) -> NamedSharding:
    return NamedSharding(mesh, rules.spec(shape, logical_dims))


def place(x, sharding: NamedSharding):
    """``x`` as a DTensor laid out by ``sharding``.  A tensor is the full
    (global) value, the same on every rank: each rank keeps its own shard
    and nothing moves.  A DTensor is redistributed.  Differentiable."""
    return _to_placements(x, sharding.mesh, sharding.placements)


def place_like(x, like):
    """``x`` laid out as ``like`` is: a ``NamedSharding``'s layout, a
    DTensor's placements, or, for anything else, as it is."""
    from torch.distributed.tensor import DTensor

    if isinstance(like, NamedSharding):
        return place(x, like)
    if isinstance(like, DTensor):
        return _to_placements(x, like.device_mesh, list(like.placements))
    return x


def _to_placements(x, mesh, pl):
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return x if list(x.placements) == pl else x.redistribute(mesh, pl)
