"""Op-level cost of one eager step, counted as it runs (the port's
counterpart of the JAX package's ``repro.roofline.hlo_cost``).

The reference re-walks XLA's optimized HLO text.  The port runs eagerly
and has no HLO, so this module replaces the HLO walk: ``OpCounter``, a
``TorchDispatchMode``, records every aten op and every collective a step
dispatches on ONE RANK's local tensors, and the cost model below turns the
records into the reference's ``Cost`` (flops, bytes, coll_bytes,
coll_ops):

* FLOPs: ``2 * numel(out) * contracted`` for mm / bmm / addmm / baddbmm /
  convolution and the attention ops, from ``torch.utils.flop_counter``'s
  formula table (the reference's ``_dot_flops`` / ``_conv_flops``);
* bytes: eager PyTorch fuses nothing, so every op reads its tensor inputs
  and writes its outputs, the reference's rule for an op outside a fusion
  (``_op_bytes``).  Views, aliases and metadata ops are free, as bitcast /
  get-tuple-element are; gathers count 2x the result (read the rows, write
  them); the in-place index_put_ / scatter / index_add_ / index_copy_ count
  2x the update (their out-of-place forms copy the whole tensor in eager
  PyTorch, and count it); ``copy_`` reads its source and writes its
  destination; ``fill_`` / ``zero_`` only write; other in-place ops count
  what they read and write;
* collectives: the ``_c10d_functional.*`` and ``c10d.*`` ops, with the
  result's bytes and the group size g from the process group, through the
  reference's ring formulas (``analysis.collective_bytes_from_log``; a
  group of one moves nothing and is not listed);
* an opaque kernel (the port's ctypes CUDA launches) dispatches no aten op
  and counts 0, as the reference's custom-call does.

DTensor: the counter lets DTensor run first (it returns ``NotImplemented``
for a DTensor op) and sees the local ops DTensor runs on the rank's shards,
so the FLOPs and bytes are one rank's and replicated compute counts whole
on every rank.  DTensor's sharding propagation runs ops on global-shape
fake tensors to learn an output's shape: they are not the step's work and
are not recorded.

The counter works under ``FakeTensorMode`` (the dry run: no memory) and on
real tensors (a step on the card), with the same records for the same step.
It also tracks the peak of live storages the step allocates
(``peak_bytes``), for the dry run's ``temp_bytes``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
import weakref
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.roofline.analysis import collective_bytes_from_log


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_ops: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: {"count": 0.0, "bytes": 0.0})
    )

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.coll_bytes += other.coll_bytes * mult
        for k, v in other.coll_ops.items():
            self.coll_ops[k]["count"] += v["count"] * mult
            self.coll_ops[k]["bytes"] += v["bytes"] * mult


# --------------------------------------------------------------------------- the cost model
#: ops that move no data: allocation without a write, metadata, aliases the
#: schema does not mark as views, and the wait on a collective
_FREE_OPS = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_unsafe_view", "lift_fresh", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "record_stream", "wait_tensor",
    "_has_compatible_shallow_copy_type", "set_", "resize_",
}
#: reads of selected rows: 2x the result (read the rows, write the result)
_GATHER_OPS = {"index", "index_select", "gather", "embedding", "take", "narrow_copy",
               "slice_copy", "select_copy", "masked_select"}
#: in-place writes of an update: 2x the update (read it, write the region);
#: the value is the update's position among the arguments
_SCATTER_OPS = {"index_put_": 2, "_index_put_impl_": 2, "scatter_": 3, "scatter_add_": 3,
                "scatter_reduce_": 3, "index_add_": 3, "index_copy_": 3}
#: writes only
_WRITE_OPS = {"fill_", "zero_", "normal_", "uniform_", "random_", "bernoulli_"}

#: collective op name -> the reference's (XLA's) kind
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d")


@functools.lru_cache(maxsize=None)
def _itemsize(dtype: str) -> int:
    return getattr(torch, dtype).itemsize


def _tensor_bytes(meta) -> int:
    shape, dtype = meta["s"], meta["d"]
    n = 1
    for d in shape:
        n *= d
    return n * _itemsize(dtype)


def _tensors(skel) -> Iterable[dict]:
    """The tensor metas in a recorded argument skeleton, in order."""
    if isinstance(skel, dict):
        if "s" in skel and "d" in skel:
            yield skel
        else:
            for v in skel.values():
                yield from _tensors(v)
    elif isinstance(skel, list):
        for v in skel:
            yield from _tensors(v)


def _shapes(skel):
    """The skeleton with each tensor meta as its ``torch.Size`` (what the
    flop formulas take)."""
    if isinstance(skel, dict):
        if "s" in skel and "d" in skel:
            return torch.Size(skel["s"])
        return {k: _shapes(v) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_shapes(v) for v in skel]
    return skel


@functools.lru_cache(maxsize=None)
def _flop_formula(op: str):
    from torch.utils.flop_counter import flop_registry

    ns, name = op.split(".")[:2]
    packet = getattr(getattr(torch.ops, ns, None), name, None)
    return flop_registry.get(packet) if packet is not None else None


def op_flops(rec: dict) -> float:
    formula = _flop_formula(rec["op"])
    if formula is None:
        return 0.0
    out = _shapes(rec["out"])
    return float(formula(*_shapes(rec["args"]), **_shapes(rec.get("kwargs", {})),
                         out_val=out[0] if len(out) == 1 else out))


def op_bytes(rec: dict) -> float:
    """HBM bytes one recorded op moves (the rules in the module docstring)."""
    if rec.get("view"):
        return 0.0
    name = rec["op"].split(".")[1]
    if name in _FREE_OPS:
        return 0.0
    outs = sum(_tensor_bytes(t) for t in rec["out"])
    if name in _GATHER_OPS:
        return 2.0 * outs
    if name in _SCATTER_OPS:
        args = rec["args"]
        at = _SCATTER_OPS[name]
        upd = list(_tensors(args[at])) if len(args) > at else []
        if upd:
            return 2.0 * sum(_tensor_bytes(t) for t in upd)
        # scatter_ of a scalar: one element of self per index
        idx = list(_tensors(args[2])) if len(args) > 2 else []
        item = _itemsize(rec["out"][0]["d"]) if rec["out"] else 4
        return 2.0 * sum(_tensor_bytes(t) // _itemsize(t["d"]) * item for t in idx)
    if name in _WRITE_OPS:
        return float(outs)
    if name == "copy_":
        src = list(_tensors(rec["args"][1:2]))
        return float(outs + sum(_tensor_bytes(t) for t in src))
    ins = sum(_tensor_bytes(t) for t in _tensors([rec["args"], rec.get("kwargs", {})]))
    return float(ins + outs)


def op_cost(rec: dict) -> Cost:
    """One record's FLOPs and HBM bytes (its collective bytes come from
    ``collective_bytes_from_log``)."""
    return Cost(flops=op_flops(rec), bytes=op_bytes(rec))


def analyze_log(records: Iterable[dict]) -> Cost:
    """The reference's ``analyze_hlo``, over the counter's records."""
    records = list(records)
    total = Cost()
    for rec in records:
        total.add(op_cost(rec), rec.get("n", 1))
    total.coll_bytes, coll_ops = collective_bytes_from_log(records)
    total.coll_ops.update(coll_ops)
    return total


def _kind_of(rec: dict) -> str:
    if rec.get("collective"):
        return "collective"
    return "dot" if _flop_formula(rec["op"]) is not None else "op"


def top_sites(records: Iterable[dict], kind: str = "collective", k: int = 15):
    """Largest cost sites, for perf investigation.

    kind: "collective" (bytes moved) | "dot" (flops) | "op" (HBM bytes of
    every other op; the reference's "fusion").  A site is one op at one
    place in the port's code (``models/layers.py:attention``, with the
    autograd node for backward work); its count plays the part of the
    reference's loop multiplier.  Returns
    [(total, count, per_call, op, site), ...]."""
    if kind not in ("collective", "dot", "op"):
        raise ValueError(f"kind must be collective, dot or op, not {kind!r}")
    sums: Dict[Tuple[str, str], List[float]] = defaultdict(lambda: [0.0, 0])
    for rec in records:
        if _kind_of(rec) != kind:
            continue
        n = rec.get("n", 1)
        if kind == "collective":
            v = collective_bytes_from_log([dict(rec, n=1)])[0]
        else:
            c = op_cost(rec)
            v = c.flops if kind == "dot" else c.bytes
        s = sums[(rec["op"], rec["site"])]
        s[0] += v * n
        s[1] += n
    sites = [(tot, n, tot / n, op, site) for (op, site), (tot, n) in sums.items()]
    sites.sort(reverse=True)
    return sites[:k]


# --------------------------------------------------------------------------- the counter
def _meta(t: torch.Tensor) -> dict:
    return {"s": list(t.shape), "d": str(t.dtype).replace("torch.", "")}


def _skeleton(x):
    """An op argument as JSON: a tensor as its shape and dtype, numbers,
    strings and None as they are, sequences element by element, anything
    else (dtypes, devices, process groups) as its name."""
    if isinstance(x, torch.Tensor):
        return _meta(x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (list, tuple)):
        return [_skeleton(v) for v in x]
    if isinstance(x, torch.SymInt):
        return int(x)
    return str(x)


def _outputs(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _outputs(o)]
    return []


@functools.lru_cache(maxsize=None)
def _op_info(func) -> Tuple[str, bool, bool, Optional[str]]:
    """(name as recorded, an alias of an input?, new storage?, collective
    kind or None) of an op overload."""
    ns, name = func.namespace, func._schema.name.split("::")[-1]
    rets = func._schema.returns
    view = bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)
    fresh = all(r.alias_info is None for r in rets) and name not in _FREE_OPS
    coll = _COLLECTIVE_OPS.get(name) if ns in _COLLECTIVE_NS else None
    return f"{ns}.{func._opname}.{func._overloadname}", view, fresh, coll


def _group_size(func, args, kwargs) -> int:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    named = dict(kwargs)
    for a, v in zip(func._schema.arguments, args):
        named[a.name] = v
    if "group_size" in named:
        return int(named["group_size"])
    for v in named.values():
        if isinstance(v, dist.ProcessGroup):
            return v.size()
        if (isinstance(v, torch.ScriptObject)
                and v._type().qualified_name().endswith("c10d.ProcessGroup")):
            return dist.ProcessGroup.unbox(v).size()
    if "group_name" in named:
        return _resolve_process_group(named["group_name"]).size()
    raise ValueError(f"no process group among {func}'s arguments")


_PKG = os.sep + "repro_torch" + os.sep
#: the port's plumbing: a site is named by the model or optimizer code
#: that called it
_PLUMBING = tuple(_PKG + d for d in ("roofline" + os.sep, "distributed" + os.sep, "tree.py"))
_SKIP, _PASS = 0, 1


@functools.lru_cache(maxsize=None)
def _frame_kind(code):
    """_SKIP for DTensor's sharding propagation (ops on global-shape fake
    tensors), the site's name for a function of the port's own code, _PASS
    for anything else."""
    fn = code.co_filename
    if fn.endswith(os.sep + "_sharding_prop.py"):
        return _SKIP
    i = fn.rfind(_PKG)
    if i >= 0 and not any(p in fn[i:] for p in _PLUMBING):
        return f"{fn[i + len(_PKG):]}:{code.co_name}"
    return _PASS


def _site() -> Optional[str]:
    """The innermost frame of the port's own code, as ``dir/file.py:function``
    (with the autograd node for backward work), or None for an op of
    DTensor's sharding propagation."""
    f = sys._getframe(2)
    name = "<outside repro_torch>"
    while f is not None:
        kind = _frame_kind(f.f_code)
        if kind is _SKIP:
            return None
        if kind is not _PASS:
            name = kind
            break
        f = f.f_back
    node = torch._C._current_autograd_node()
    return name if node is None else f"{name} < {node.name()}"


class OpCounter(TorchDispatchMode):
    """Records the ops one rank runs while it is entered::

        with OpCounter() as oc:
            step(...)
        oc.records, oc.cost(), oc.peak_bytes

    Each record is JSON: ``op``, ``args`` / ``kwargs`` (tensors as shape and
    dtype), ``out``, ``site``, ``view`` for an alias, for a collective its
    ``collective`` kind, ``group`` size and ``result_bytes``, and ``n``, the
    times the step ran that same op at that site on those shapes (a loop's
    trip count, as the reference multiplies a while body by its trips).
    ``peak_bytes`` is the largest sum of live storages the counted ops
    allocated, at any point while entered."""

    def __init__(self):
        super().__init__()
        self.records: List[dict] = []
        self._index: Dict[str, int] = {}  # a record's JSON -> its place in records
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages = {}  # id -> weakref of each live storage counted

    def cost(self) -> Cost:
        return analyze_log(self.records)

    def _freed(self, key, nbytes, _ref):
        if self._storages.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def _track(self, outs: List[torch.Tensor]) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            ref = self._storages.get(key)
            if ref is not None and ref() is st:
                continue
            nbytes = st.nbytes()
            self._storages[key] = weakref.ref(st, functools.partial(self._freed, key, nbytes))
            self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs first; its local ops come back here
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            return out  # metadata (``prim.device``), asked by fake tensors only
        site = _site()
        if site is None:
            return out
        op, view, fresh, coll = _op_info(func)
        outs = _outputs(out)
        rec = {"op": op, "args": _skeleton(list(args)), "out": [_meta(t) for t in outs],
               "site": site}
        if kwargs:
            rec["kwargs"] = {k: _skeleton(v) for k, v in kwargs.items()}
        if view:
            rec["view"] = True
        if coll:
            result = outs or _outputs(args[0])
            rec.update(collective=coll, group=_group_size(func, args, kwargs),
                       result_bytes=sum(t.numel() * t.element_size() for t in result))
        key = json.dumps(rec)
        at = self._index.get(key)
        if at is None:
            self._index[key] = len(self.records)
            rec["n"] = 1
            self.records.append(rec)
        else:
            self.records[at]["n"] += 1
        if fresh:
            self._track(outs)
        return out
