"""Path-pattern -> logical-dims mapping for parameter / cache / batch trees
(the JAX package's ``repro.distributed.params`` in PyTorch).

Names are assigned by the model code; dims are padded on the left with None
for stacked (scanned) prefixes.  The fallback chain for embeddings
(vocab-shard -> d_model-shard -> replicate) is resolved here against the
actual shapes, so odd vocabs (50280, 32001, 256206) never fail.

A leaf's names are its path as JAX names it: dict keys in sorted order,
``[i]`` for a list or tuple index, nothing for a NamedTuple field (JAX's
``GetAttrKey``), so ``names[-1]`` and the ``"moe" in names`` test see
what the reference sees.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch import tree as _tree
from repro_torch.distributed.sharding import (
    NamedSharding,
    P,
    ShardingRules,
    _as_tuple,
)

# name -> trailing logical dims
_BASE = {
    "wq": (None, "qkv_flat"),
    "wk": (None, "qkv_flat"),
    "wv": (None, "qkv_flat"),
    "wo": ("qkv_flat", None),
    "w1": (None, "mlp"),
    "w3": (None, "mlp"),
    "w2": ("mlp", None),
    "shared_w1": (None, "mlp"),
    "shared_w3": (None, "mlp"),
    "shared_w2": ("mlp", None),
    "router": (None, None),
    "in_proj": (None, "dinner"),
    "out_proj": ("dinner", None),
    "conv_w": (None, None),
    "conv_b": (None,),
    "dt_bias": (None,),
    "A_log": (None,),
    "D": (None,),
    "out_norm": (None,),
    "meta_tokens": (None, None),
    # caches
    "k": ("batch", "seq", "kv_heads", None),
    "v": ("batch", "seq", "kv_heads", None),
    "cross_k": ("batch", None, "kv_heads", None),
    "cross_v": ("batch", None, "kv_heads", None),
    "pos": ("batch", None),
    "ssm_state": ("batch", "dinner", None, None),
    "conv_state": ("batch", None, None),
    "lengths": ("batch",),
    # batches
    "tokens": ("batch", None),
    "labels": ("batch", None),
    "loss_mask": ("batch", None),
    "patch_embeds": ("batch", None, "embed"),
    "positions_thw": (None, "batch", None),
    "frame_embeds": ("batch", None, "embed"),
}

_MOE_OVERRIDES = {
    # "fsdp" resolves to the data axes only when a cell's rules enable it;
    # otherwise it is absent from the table -> None.  "expert_ff" defaults
    # to the same axis as "mlp" but can be remapped on its own.
    "w1": ("expert", "fsdp", "expert_ff"),
    "w3": ("expert", "fsdp", "expert_ff"),
    "w2": ("expert", "expert_ff", "fsdp"),
}


def _named_map(fn, tree: Any, names: Tuple[str, ...] = ()) -> Any:
    """``fn(names, leaf)`` over the leaves, keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _named_map(fn, v, names + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(_named_map(fn, v, names) for v in tree))
    if isinstance(tree, (list, tuple)):
        out = [_named_map(fn, v, names + (f"[{i}]",)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(names, tree)


def logical_dims(names: Tuple[str, ...], leaf, rules: ShardingRules) -> Tuple[Optional[str], ...]:
    name = names[-1] if names else ""
    ndim = len(leaf.shape)
    tp = rules.axis_size(rules.table.get("vocab"))

    if name == "embed":
        V = leaf.shape[-2]
        base = ("vocab", None) if tp > 1 and V % tp == 0 else (None, "embed_alt")
    elif name == "unembed":
        V = leaf.shape[-1]
        base = (None, "vocab") if tp > 1 and V % tp == 0 else ("embed_alt", None)
    elif name in _MOE_OVERRIDES and "moe" in names:
        base = _MOE_OVERRIDES[name]
    elif name in _BASE:
        base = _BASE[name]
    else:
        base = ()  # norms / unknowns -> replicate

    if len(base) > ndim:
        base = base[-ndim:]
    return (None,) * (ndim - len(base)) + tuple(base)


def tree_pspecs(tree: Any, rules: ShardingRules) -> Any:
    """Same-structure tree of PartitionSpec."""
    return _named_map(lambda names, leaf: rules.spec(leaf.shape, logical_dims(names, leaf, rules)),
                      tree)


def tree_shardings(tree: Any, mesh, rules: ShardingRules) -> Any:
    return _tree.tree_map(lambda s: NamedSharding(mesh, s), tree_pspecs(tree, rules))


def zero1_pspec(param_spec: P, shape: Tuple[int, ...], rules: ShardingRules) -> P:
    """ZeRO-1: additionally shard one replicated dim of the optimizer moment
    over the data axes (the master copy of the param stays as-is).  Falls
    back to the param's spec when no dim is divisible."""
    data_axes = rules.table.get("batch")
    if data_axes is None:
        return param_spec
    n = rules.axis_size(data_axes)
    if n <= 1:
        return param_spec
    parts = list(param_spec) + [None] * (len(shape) - len(param_spec))
    used = {a for p in parts if p is not None for a in _as_tuple(p)}
    da = _as_tuple(data_axes)
    if any(a in used for a in da):
        return param_spec
    # pick the largest divisible unsharded dim
    best, best_size = -1, 0
    for i, (d, p) in enumerate(zip(shape, parts)):
        if p is None and d % n == 0 and d > best_size:
            best, best_size = i, d
    if best < 0:
        return param_spec
    parts[best] = da[0] if len(da) == 1 else tuple(da)
    return P(*parts)


def opt_state_shardings(opt_state_abs, params_abs, mesh, rules: ShardingRules,
                        zero1: bool = True):
    """Shardings for AdamWState(step, m, v) given the params (or any tree
    of leaves with their shapes)."""
    from repro_torch.optim.adamw import AdamWState

    p_specs = tree_pspecs(params_abs, rules)

    def moment():
        def f(spec, p):
            return NamedSharding(mesh, zero1_pspec(spec, p.shape, rules) if zero1 else spec)

        return _tree.tree_map(f, p_specs, params_abs)

    return AdamWState(step=NamedSharding(mesh, P()), m=moment(), v=moment())
