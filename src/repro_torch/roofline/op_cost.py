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

Loops (the reference's trip-count walk): the model's Python loops that
stand for the reference's ``lax.scan``s (a segment's layers, the
encoder-decoder's layers, the micro-steps) iterate ``counted_range(n)``.
Under ``OpCounter(loops="all")``, and with no counter, that is
``range(n)``: every trip runs and is counted.  Under
``OpCounter(loops="once")`` it runs one trip and every op that trip
records counts ``n`` times, as ``hlo_cost`` multiplies a ``while`` body by
its trip count; nested loops multiply.  The backward pays the multiplier
too: ``counted_range.enter`` / ``exit`` put identity markers around a
trip's carry, whose backward raises the multiplier while autograd runs
that trip's backward (its remat replay included).  What the skipped trips
would have left behind is made up so that the totals are the full run's:
the one trip's per-trip outputs stand for all n (``repeat``), a stacked
[n, ...] parameter's gradient pays the n - 1 accumulations of its layer
views' gradients (``stacked``), and the storages a trip leaves live at
its exit (a prefill's cache, the layer input a remat replay keeps) count
n times for as long as they live, so ``peak_bytes`` follows the full run's
(held to it in ``tests/test_torch_dryrun_loops.py``).
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

    def __init__(self, loops: str = "all"):
        super().__init__()
        if loops not in ("all", "once"):
            raise ValueError(f"loops must be 'all' or 'once', not {loops!r}")
        self.loops = loops
        self.records: List[dict] = []
        self._index: Dict[str, int] = {}  # a record's JSON -> its place in records
        self.live_bytes = 0
        self.peak_bytes = 0
        #: id -> [weakref, bytes it counts for (its size times the trips it
        #: stands for), allocation number] of each live storage counted
        self._storages: Dict[int, list] = {}
        self._allocated = 0
        self._high = 0  # the high-water mark of live bytes in the trip being counted
        self._mult = 1  # the product of the trip counts of the loops being counted
        self._outer = None

    def __enter__(self):
        global _LOOPING
        self._outer, _LOOPING = _LOOPING, (self if self.loops == "once" else None)
        return super().__enter__()

    def __exit__(self, *exc):
        global _LOOPING
        _LOOPING = self._outer
        return super().__exit__(*exc)

    def cost(self) -> Cost:
        return analyze_log(self.records)

    def _freed(self, key, _ref):
        entry = self._storages.pop(key, None)
        if entry is not None:
            self.live_bytes -= entry[1]

    def _track(self, outs: List[torch.Tensor]) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            entry = self._storages.get(key)
            if entry is not None and entry[0]() is st:
                continue
            nbytes = st.nbytes()
            ref = weakref.ref(st, functools.partial(self._freed, key))
            self._storages[key] = [ref, nbytes, self._allocated]
            self._allocated += 1
            self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        self._high = max(self._high, self.live_bytes)

    def _end_trip(self, n: int, first: int, carry_in, carry_out,
                                 outer_high: int) -> None:
        """At the end of a counted trip: each storage the trip allocated that
        is still live, but for those the trip hands on to the next
        (``carry_out``), and each storage of a carried-in value that
        autograd keeps for the backward (``carry_in`` with requires_grad: a
        replay's layer input), is one of n in the full run, whose last trip
        reaches this trip's high-water mark with the other n - 1 trips'
        live."""
        handed_on = {id(_local(t).untyped_storage()) for t in carry_out}
        kept = {id(st): st for st in (_local(t).untyped_storage() for t in carry_in
                                      if t.requires_grad)}
        left = 0
        for key, entry in self._storages.items():
            if (entry[2] >= first and key not in handed_on) or key in kept:
                left += entry[1]
                entry[1] *= n
        for key, st in kept.items():
            if key not in self._storages:  # allocated before the count began
                left += st.nbytes()
                ref = weakref.ref(st, functools.partial(self._freed, key))
                self._storages[key] = [ref, (n - 1) * st.nbytes(), self._allocated]
                self._allocated += 1
        self.live_bytes += (n - 1) * left
        self._high = max(outer_high, self._high + (n - 1) * left, self.live_bytes)
        self.peak_bytes = max(self.peak_bytes, self._high)

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
            rec["n"] = self._mult
            self.records.append(rec)
        else:
            self.records[at]["n"] += self._mult
        if fresh:
            self._track(outs)
        return out


# --------------------------------------------------------------------------- counted loops
#: the OpCounter(loops="once") entered, if any
_LOOPING: Optional[OpCounter] = None


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


class _Mult:
    """The counter's multiplier times ``k`` while entered."""

    def __init__(self, counter: OpCounter, k: int):
        self.counter, self.k = counter, k

    def __enter__(self):
        self.counter._mult *= self.k

    def __exit__(self, *exc):
        self.counter._mult //= self.k


class _TripEnd(torch.autograd.Function):
    """Identity on a trip's carry out; its backward, the first of the
    trip's, raises the multiplier to the trip count."""

    @staticmethod
    def forward(ctx, loop, *xs):
        ctx.loop = loop
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        loop = ctx.loop
        loop._backward = _Mult(loop._counter, loop.n - loop.peel)
        loop._backward.__enter__()
        return (None,) + grads


class _TripStart(torch.autograd.Function):
    """Identity on a trip's carry in and on what every trip reads (the
    stacked [n, ...] parameters whose layer views it takes, the encoder's
    output); its backward, the last of the trip's (it waits for those
    gradients too), lowers the multiplier again.

    In the full run autograd adds the n trips' gradients of a shared
    tensor into one: n - 1 adds (of [n, ...] for a stacked parameter, each
    layer view's gradient being a [n, ...] ``select_backward``), of which
    the counted trip runs ``uses_per_trip - 1`` (times its count, n - peel)
    and a peeled trip's gradient meets the counted trip's in one add of its
    own.  The backward counts the rest: one add of the shared tensor's
    gradient, n - peel - 1 times."""

    @staticmethod
    def forward(ctx, loop, n_shared, *xs):
        ctx.loop, ctx.n_shared = loop, n_shared
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        loop = ctx.loop
        loop._backward.__exit__()
        c = loop._counter
        with _Mult(c, loop.n - loop.peel - 1):
            for g in grads[len(grads) - ctx.n_shared:]:
                if g is not None:
                    # the full run's add meets the running sum and a new
                    # gradient: one more live tensor of g's size meanwhile
                    nbytes = _local(g).untyped_storage().nbytes()
                    c.live_bytes += nbytes
                    torch.add(g, g)
                    c.live_bytes -= nbytes
        return (None, None) + grads


class counted_range:
    """``range(n)`` for a Python loop that stands for one of the reference's
    ``lax.scan``s, whose trips run the same ops on the same shapes::

        loop = counted_range(n)
        for i in loop:
            (x,), p = loop.enter((x,), stacked_params)
            ...  # trip i, on p's layer-i views
            x, = loop.exit(x)
        outs = loop.repeat(outs)

    With no counter, or under ``OpCounter(loops="all")``, it runs every
    trip and ``enter`` / ``exit`` / ``repeat`` hand their arguments back.
    Under ``OpCounter(loops="once")`` it runs trip ``peel`` only, counted
    n - peel times, after the first ``peel`` trips, each run and counted on
    its own (trips that differ from the rest: the carry comes in with no
    gradient, or in another layout).  ``enter`` and ``exit`` take the
    carry into and out of the counted trip, and pass what carries a
    gradient (with what ``enter`` is told every trip reads) through the
    backward's markers; ``repeat`` stands the counted trip's outputs for
    its n - peel.  ``scan=False`` makes a plain range of it (an unrolled
    segment)."""

    def __init__(self, n: int, scan: bool = True, peel: int = 0):
        self.n, self.peel = n, peel
        self._counter = _LOOPING if scan and n - peel > 1 else None
        self._counting = False  # in the counted trip
        self._carry_in: tuple = ()
        self._carry_out: tuple = ()
        self._backward: Optional[_Mult] = None

    @property
    def once(self) -> bool:
        """Whether the loop runs one counted trip (a loop-aware count)."""
        return self._counter is not None

    def __iter__(self):
        c = self._counter
        if c is None:
            yield from range(self.n)
            return
        yield from range(self.peel)
        m = self.n - self.peel
        high, c._high = c._high, c.live_bytes
        first = c._allocated
        self._counting = True
        with _Mult(c, m):
            yield self.peel
        self._counting = False
        c._end_trip(m, first, self._carry_in, self._carry_out, high)
        self._carry_in = self._carry_out = ()  # no longer kept alive here

    def _grad(self) -> bool:
        return self._counting and torch.is_grad_enabled()

    def enter(self, carry: tuple, shared=None):
        """(carry, shared) into a trip, handed back: ``carry`` the tensors
        the last trip handed on, ``shared`` a tree of the tensors every
        trip reads (the stacked [n, ...] parameters whose layer views it
        takes; None for none)."""
        from repro_torch import tree as ttree

        if self._counting:
            self._carry_in = carry
        if not self._grad():
            return carry, shared
        flat, treedef = ttree.flatten(shared)
        marked = [x for x in carry if x.requires_grad]
        s_marked = [x for x in flat if isinstance(x, torch.Tensor) and x.requires_grad]
        if not marked and not s_marked:
            return carry, shared
        it = iter(_TripStart.apply(self, len(s_marked), *marked, *s_marked))
        carry = tuple(next(it) if x.requires_grad else x for x in carry)
        flat = [next(it) if isinstance(x, torch.Tensor) and x.requires_grad else x
                for x in flat]
        return carry, ttree.unflatten(treedef, flat)

    def exit(self, *carry):
        """The carry out of a trip (tensors), handed back."""
        if self._counting:
            self._carry_out = carry
        if not self._grad() or not any(x.requires_grad for x in carry):
            return carry
        it = iter(_TripEnd.apply(self, *[x for x in carry if x.requires_grad]))
        return tuple(next(it) if x.requires_grad else x for x in carry)

    def repeat(self, outs: list) -> list:
        """The trips' outputs in trip order (as many for each trip): the
        counted trip's stand for its n - peel."""
        if not self.once:
            return outs
        k = len(outs) * self.peel // (self.peel + 1)
        return outs[:k] + outs[k:] * (self.n - self.peel)
