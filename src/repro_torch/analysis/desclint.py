"""Descriptor validity checking (paper §3.2: the 64-byte contract).

A DSA work descriptor is a fixed-layout record; a malformed one (missing
operand, wrong flags, bad transfer size) fails LATE — inside the engine,
as an opaque completion error — and once descriptor chaining takes the CPU
out of the datapath such failures become host-invisible.  ``desclint``
enforces each op's operand contract at submit time instead:

  DESC101  missing-operand       required operand absent (FILL without a
                                 pattern / n_words, DELTA without src2,
                                 BATCH_COPY without dst_pool/indices, ...)
  DESC102  operand-mismatch      operands disagree (COMPARE shape/dtype,
                                 DELTA ref vs src, DIF word dtype/framing,
                                 BATCH_COPY row shape vs dst_pool, bad cap)
  DESC103  index-shape           index operands malformed (BATCH_COPY
                                 src_idx/dst_idx shape disagreement or not
                                 1-D, DELTA_APPLY offsets vs data length)
  DESC104  locality              src_node/dst_node hints outside the
                                 device topology, or conflicting with the
                                 buffer-locality registry's registered home
  DESC105  batch-inhomogeneous   (warn) a near-fusable F2 copy batch whose
                                 members disagree on flags/shape — legal,
                                 but silently falls back to per-descriptor
                                 execution, losing the batch amortization
  DESC106  degenerate-size       (warn) descriptor moves zero bytes (empty
                                 BATCH_COPY, operand without dtype/size)

Wiring: ``make_device(validate="strict"|"warn"|"off")``.  strict raises
the typed :class:`DescriptorError` taxonomy below from ``Device.submit``;
warn bumps the device's ``desclint_warnings`` counter; off skips the checks
entirely.

Operands are torch tensors: a dtype is a ``torch.dtype``, read as a numpy
kind letter and an item size so the rules (and their codes) stay those of
the JAX package's desclint.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from repro_torch.core.descriptor import BatchDescriptor, OpType, WorkDescriptor


# --------------------------------------------------------------------------- taxonomy
class DescriptorError(ValueError):
    """Base of the typed malformed-descriptor taxonomy (strict mode).
    Carries the rule ``code`` and the full diagnostic list so callers can
    branch on the failure family without parsing messages."""

    code = "DESC100"

    def __init__(self, message: str,
                 diagnostics: Optional[Sequence["Diagnostic"]] = None,
                 desc: Any = None):
        super().__init__(message)
        self.diagnostics = list(diagnostics or ())
        self.desc = desc


class MissingOperandError(DescriptorError):
    code = "DESC101"


class OperandMismatchError(DescriptorError):
    code = "DESC102"


class IndexShapeError(DescriptorError):
    code = "DESC103"


class LocalityError(DescriptorError):
    code = "DESC104"


ERROR_TYPES: Dict[str, Type[DescriptorError]] = {
    cls.code: cls
    for cls in (DescriptorError, MissingOperandError, OperandMismatchError,
                IndexShapeError, LocalityError)
}

#: rule code -> one-line description (the docs/analysis.md catalogue)
RULES: Dict[str, str] = {
    "DESC100": "generic malformed descriptor",
    "DESC101": "missing-operand: a required operand is absent",
    "DESC102": "operand-mismatch: operand shapes/dtypes/values disagree",
    "DESC103": "index-shape: index operands malformed or inconsistent",
    "DESC104": "locality: node hints outside the topology or conflicting "
               "with the buffer-locality registry",
    "DESC105": "batch-inhomogeneous (warn): near-fusable F2 batch falls "
               "back to per-descriptor execution",
    "DESC106": "degenerate-size (warn): descriptor moves zero bytes",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: a rule code, error|warn severity, and the message."""

    code: str
    severity: str  # "error" | "warn"
    message: str

    def __str__(self) -> str:
        return f"{self.code} [{self.severity}] {self.message}"


def _err(code: str, msg: str) -> Diagnostic:
    return Diagnostic(code, "error", msg)


def _warn(code: str, msg: str) -> Diagnostic:
    return Diagnostic(code, "warn", msg)


# --------------------------------------------------------------------------- helpers
def _shape(x: Any) -> Optional[Tuple[int, ...]]:
    s = getattr(x, "shape", None)
    return tuple(s) if s is not None else None


_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def _dtype(x: Any) -> Optional[torch.dtype]:
    dt = getattr(x, "dtype", None)
    return dt if isinstance(dt, torch.dtype) else None


def _kind(dt: torch.dtype) -> str:
    """numpy's kind letter for a torch dtype: b, u, i, f or c."""
    if dt == torch.bool:
        return "b"
    if dt.is_complex:
        return "c"
    if dt.is_floating_point:
        return "f"
    return "u" if dt in _UNSIGNED else "i"


def _is_arrayish(x: Any) -> bool:
    return _shape(x) is not None and _dtype(x) is not None


def _size(x: Any) -> Optional[int]:
    numel = getattr(x, "numel", None)
    return int(numel()) if callable(numel) else None


def _require(d: WorkDescriptor, field: str, what: str,
             out: List[Diagnostic]) -> Any:
    v = getattr(d, field, None)
    if v is None:
        out.append(_err("DESC101",
                        f"{d.op.value}: required operand {field!r} ({what}) "
                        f"is missing"))
    return v


def _require_array(d: WorkDescriptor, field: str, what: str,
                   out: List[Diagnostic]) -> Any:
    v = _require(d, field, what, out)
    if v is not None and not _is_arrayish(v):
        out.append(_err("DESC102",
                        f"{d.op.value}: operand {field!r} ({what}) is not "
                        f"array-like (no shape/dtype: "
                        f"{type(v).__name__})"))
        return None
    return v


def _agree(d: WorkDescriptor, a: Any, b: Any, a_name: str, b_name: str,
           out: List[Diagnostic]) -> None:
    """Shape AND dtype agreement between two operands."""
    if a is None or b is None:
        return
    sa, sb = _shape(a), _shape(b)
    if sa != sb:
        out.append(_err("DESC102",
                        f"{d.op.value}: {a_name} shape {sa} != {b_name} "
                        f"shape {sb}"))
    da, db = _dtype(a), _dtype(b)
    if da is not None and db is not None and da != db:
        out.append(_err("DESC102",
                        f"{d.op.value}: {a_name} dtype {da} != {b_name} "
                        f"dtype {db}"))


def _word_dtype_ok(x: Any) -> bool:
    """DIF/fill word streams are 4-byte integer words (the kernels reshape
    and CRC them as u32 grids)."""
    dt = _dtype(x)
    return dt is not None and _kind(dt) in "iu" and dt.itemsize == 4


# --------------------------------------------------------------------------- per-op checks
def _check_fill(d: WorkDescriptor, out: List[Diagnostic]) -> None:
    if d.pattern is None:
        out.append(_err("DESC101",
                        f"{d.op.value}: required operand 'pattern' is "
                        f"missing"))
    n = getattr(d, "n_words", None)
    if not isinstance(n, (int, np.integer)) or n < 1:
        out.append(_err("DESC101",
                        f"{d.op.value}: 'n_words' must be a positive int "
                        f"(transfer size), got {n!r}"))


def _check_compare(d: WorkDescriptor, out: List[Diagnostic]) -> None:
    a = _require_array(d, "src", "left operand", out)
    b = _require_array(d, "src2", "right operand", out)
    _agree(d, a, b, "src", "src2", out)


def _check_compare_pattern(d: WorkDescriptor, out: List[Diagnostic]) -> None:
    _require_array(d, "src", "buffer", out)
    if d.pattern is None:
        out.append(_err("DESC101",
                        "compare_pattern: required operand 'pattern' is "
                        "missing"))


def _check_delta_create(d: WorkDescriptor, out: List[Diagnostic]) -> None:
    src = _require_array(d, "src", "new data", out)
    ref = _require_array(d, "src2", "reference", out)
    _agree(d, src, ref, "src", "src2 (reference)", out)
    cap = getattr(d, "cap", None)
    if not isinstance(cap, (int, np.integer)) or cap < 1:
        out.append(_err("DESC102",
                        f"delta_create: 'cap' (delta record capacity) must "
                        f"be >= 1, got {cap!r}"))


def _check_delta_apply(d: WorkDescriptor, out: List[Diagnostic]) -> None:
    _require_array(d, "src", "reference", out)
    offsets = _require_array(d, "src_idx", "delta offsets", out)
    data = _require_array(d, "src2", "delta data", out)
    if offsets is not None and data is not None:
        so, sd = _shape(offsets), _shape(data)
        if so and sd and so[0] != sd[0]:
            out.append(_err("DESC103",
                            f"delta_apply: offsets length {so[0]} != data "
                            f"length {sd[0]}"))


def _check_dif(d: WorkDescriptor, out: List[Diagnostic]) -> None:
    src = _require_array(d, "src", "word stream", out)
    if src is None:
        return
    if not _word_dtype_ok(src):
        out.append(_err("DESC102",
                        f"{d.op.value}: DIF operates on 4-byte integer "
                        f"words, got dtype {_dtype(src)}"))
    s = _shape(src)
    if d.op == OpType.DIF_INSERT:
        if s is not None and len(s) != 1:
            out.append(_err("DESC102",
                            f"dif_insert: expects a flat word stream "
                            f"[n_words], got shape {s}"))
    else:  # DIF_CHECK / DIF_STRIP consume framed [n_blocks, words+2] grids
        if s is not None and (len(s) != 2 or s[1] < 3):
            out.append(_err("DESC102",
                            f"{d.op.value}: expects framed blocks "
                            f"[n_blocks, block_words+2], got shape {s}"))


def _check_batch_copy(d: WorkDescriptor, out: List[Diagnostic]) -> None:
    src = _require_array(d, "src", "source pool", out)
    dst = _require_array(d, "dst_pool", "destination pool", out)
    sidx = _require_array(d, "src_idx", "source page indices", out)
    didx = _require_array(d, "dst_idx", "destination page indices", out)
    si, di = _shape(sidx), _shape(didx)
    if si is not None and len(si) != 1:
        out.append(_err("DESC103",
                        f"batch_copy: src_idx must be 1-D, got shape {si}"))
    if di is not None and len(di) != 1:
        out.append(_err("DESC103",
                        f"batch_copy: dst_idx must be 1-D, got shape {di}"))
    if si is not None and di is not None and si != di:
        out.append(_err("DESC103",
                        f"batch_copy: src_idx shape {si} != dst_idx shape "
                        f"{di} (one destination page per source page)"))
    ss, ds = _shape(src), _shape(dst)
    if ss is not None and ds is not None and ss[1:] != ds[1:]:
        out.append(_err("DESC102",
                        f"batch_copy: per-page shape disagreement: src rows "
                        f"{ss[1:]} vs dst_pool rows {ds[1:]}"))
    if ss is not None and len(ss) and ss[0] == 0:
        out.append(_warn("DESC106",
                         "batch_copy: empty source pool (shape[0] == 0) — "
                         "descriptor moves zero bytes"))
    elif si == (0,):
        out.append(_warn("DESC106",
                         "batch_copy: empty index set — descriptor moves "
                         "zero bytes"))


def _check_src_only(d: WorkDescriptor, out: List[Diagnostic]) -> None:
    src = _require_array(d, "src", "source buffer", out)
    if src is not None and _size(src) == 0:
        out.append(_warn("DESC106",
                         f"{d.op.value}: source buffer is empty — "
                         f"descriptor moves zero bytes"))


_OP_CHECKS = {
    OpType.MEMCPY: _check_src_only,
    OpType.DUALCAST: _check_src_only,
    OpType.CRC32: _check_src_only,
    OpType.FILL: _check_fill,
    OpType.COMPARE: _check_compare,
    OpType.COMPARE_PATTERN: _check_compare_pattern,
    OpType.DELTA_CREATE: _check_delta_create,
    OpType.DELTA_APPLY: _check_delta_apply,
    OpType.DIF_INSERT: _check_dif,
    OpType.DIF_CHECK: _check_dif,
    OpType.DIF_STRIP: _check_dif,
    OpType.BATCH_COPY: _check_batch_copy,
    OpType.CACHE_FLUSH: lambda d, out: None,  # modeled only, no operands
    # fused pairs share the operand contracts of their unfused halves:
    # copy_crc reads one source buffer (memcpy + crc32), fill_verify takes
    # the fill contract (pattern + n_words) and emits the verify record
    OpType.COPY_CRC: _check_src_only,
    OpType.FILL_VERIFY: _check_fill,
}


# --------------------------------------------------------------------------- locality
def _check_locality(d: Any, device: Any, out: List[Diagnostic]) -> None:
    """Node hints must fall inside the device topology, and an explicit
    hint must not contradict the registry's registered home — the engine
    charges links from these stamps, so a wrong one silently mis-bills
    (or mis-places, under numa_local) every byte."""
    topo = getattr(device, "topology", None)
    n_nodes = getattr(topo, "n_nodes", None)
    for field in ("src_node", "dst_node"):
        node = getattr(d, field, None)
        if node is None:
            continue
        if n_nodes is not None and not 0 <= node < n_nodes:
            out.append(_err("DESC104",
                            f"{field}={node} outside the {n_nodes}-node "
                            f"topology"))
    home = getattr(device, "home", None)
    if home is None or not isinstance(d, WorkDescriptor):
        return
    for field, operand in (("src_node", d.src), ("dst_node", d.dst_pool)):
        node = getattr(d, field, None)
        if node is None or operand is None:
            continue
        registered = home(operand)
        if registered is not None and registered != node:
            out.append(_err("DESC104",
                            f"{field}={node} contradicts the locality "
                            f"registry (operand registered on node "
                            f"{registered})"))


# --------------------------------------------------------------------------- batches
def _check_batch(b: BatchDescriptor, device: Any,
                 out: List[Diagnostic]) -> None:
    members = list(b.descriptors)
    if not members:
        out.append(_warn("DESC106", "batch: no member descriptors — the "
                                    "submission moves zero bytes"))
        return
    for i, d in enumerate(members):
        for diag in check_descriptor(d, device=device):
            out.append(Diagnostic(diag.code, diag.severity,
                                  f"batch[{i}]: {diag.message}"))
    # F2 homogeneity: an all-MEMCPY batch is the fusable family — if flags
    # or shapes disagree the engine silently falls back to per-descriptor
    # execution (one launch per member), losing the amortization the batch
    # was presumably built for (paper Fig. 3 / G1).
    if len(members) > 1 and all(d.op == OpType.MEMCPY for d in members):
        hints = {d.cache_hint for d in members}
        shapes = {(_shape(d.src), str(_dtype(d.src))) for d in members}
        pools = any(d.dst_pool is not None for d in members)
        reasons = []
        if len(hints) > 1:
            reasons.append("mixed cache hints")
        if len(shapes) > 1:
            reasons.append("mixed member shapes/dtypes")
        if pools:
            reasons.append("explicit dst_pool on a member")
        if reasons:
            out.append(_warn("DESC105",
                             f"near-fusable copy batch falls back to "
                             f"per-descriptor execution "
                             f"({'; '.join(reasons)})"))


# --------------------------------------------------------------------------- entry points
def check_descriptor(d: WorkDescriptor,
                     device: Any = None) -> List[Diagnostic]:
    """Validate one WorkDescriptor; returns diagnostics (possibly empty).
    Never raises and never reads tensor data (no device sync): safe on the
    submit path in warn mode."""
    out: List[Diagnostic] = []
    op = getattr(d, "op", None)
    checker = _OP_CHECKS.get(op)
    if checker is None:
        out.append(_err("DESC100", f"unknown op {op!r}"))
        return out
    checker(d, out)
    if device is not None:
        _check_locality(d, device, out)
    return out


def check(desc: Any, device: Any = None) -> List[Diagnostic]:
    """Validate any submittable (WorkDescriptor or BatchDescriptor)."""
    out: List[Diagnostic] = []
    if isinstance(desc, BatchDescriptor):
        _check_batch(desc, device, out)
        if device is not None:
            _check_locality(desc, device, out)
    else:
        out.extend(check_descriptor(desc, device=device))
    return out


def error_for(diagnostics: Sequence[Diagnostic],
              desc: Any = None) -> DescriptorError:
    """Build the typed error for a diagnostic list: the first error-severity
    finding picks the exception class; the message carries every finding."""
    errors = [d for d in diagnostics if d.severity == "error"]
    first = errors[0] if errors else diagnostics[0]
    cls = ERROR_TYPES.get(first.code, DescriptorError)
    msg = "; ".join(str(d) for d in diagnostics)
    return cls(msg, diagnostics=diagnostics, desc=desc)
