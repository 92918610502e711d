"""Work descriptors and completion records (paper §3.2).

A DSA work descriptor is a 64-byte record naming the operation, source /
destination, transfer size, and flags; completion is reported through a
completion record the engine writes when done.  The port keeps the same
programming model: descriptors are small records over torch tensors (SVM
analogue: no staging or pinning, the engine reads the tensors the
application already holds), and completion records carry result tensors
plus the modeled device timing.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Any, Optional, Sequence


class OpType(enum.Enum):
    MEMCPY = "memcpy"
    DUALCAST = "dualcast"
    FILL = "fill"
    COMPARE = "compare"
    COMPARE_PATTERN = "compare_pattern"
    CRC32 = "crc32"
    DELTA_CREATE = "delta_create"
    DELTA_APPLY = "delta_apply"
    DIF_INSERT = "dif_insert"
    DIF_CHECK = "dif_check"
    DIF_STRIP = "dif_strip"
    BATCH_COPY = "batch_copy"  # paged batch-descriptor copy
    CACHE_FLUSH = "cache_flush"  # modeled only (no device analogue)
    # fused pairs (one kernel launch, one descriptor): the hot-path ops that
    # otherwise always travel together (copy-then-checksum, fill-then-verify)
    COPY_CRC = "copy_crc"  # memcpy + CRC32 in one pass
    FILL_VERIFY = "fill_verify"  # fill + compare_pattern readback in one pass


class Status(enum.Enum):
    PENDING = 0
    RUNNING = 1
    SUCCESS = 2
    ERROR = 3
    RETRY = 4  # SWQ full (ENQCMD retry semantics)
    OVERFLOW = 5  # delta record exceeded capacity


class CacheHint(enum.Enum):
    """G3 destination steering: DDIO-style allocate-in-cache vs memory."""

    TO_MEMORY = 0  # non-allocating write (device memory)
    TO_CACHE = 1  # allocate in cache (the card's L2)


_ids = itertools.count()


def tensor_nbytes(x: Any) -> int:
    """Bytes of a tensor operand; 0 for anything without a tensor's
    ``numel()``/``element_size()`` (desclint flags those as DESC106)."""
    numel = getattr(x, "numel", None)
    element_size = getattr(x, "element_size", None)
    if not callable(numel) or not callable(element_size):
        return 0
    return int(numel()) * int(element_size())


@dataclasses.dataclass
class WorkDescriptor:
    op: OpType
    src: Any = None  # torch.Tensor
    src2: Any = None  # second operand (compare/delta ref)
    pattern: Any = None  # fill/compare_pattern pattern words
    n_words: int = 0  # fill length
    cap: int = 1024  # delta record capacity
    cache_hint: CacheHint = CacheHint.TO_MEMORY
    # batch copy:
    dst_pool: Any = None
    src_idx: Any = None
    dst_idx: Any = None
    # buffer locality (paper §4 / Fig. 13): home node of each operand.  None
    # means "wherever the engine runs": the Device stamps registered homes
    # (or a per-submit ``node=`` hint) before placement, and the engine
    # charges the inter-node link for every operand on a foreign node.
    src_node: Optional[int] = None
    dst_node: Optional[int] = None
    # metadata
    desc_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    priority: int = 0
    # fused-submission width: how many descriptors shared this one's
    # doorbell (submit_many / submit ring).  The engine divides the
    # non-posted ENQCMD round trip by this, so a fused batch of N on a
    # shared WQ pays one round trip total instead of N.
    fused_n: int = 1

    @property
    def nbytes(self) -> int:
        # Degenerate operands (empty pools, non-tensor duck types) size to 0
        # rather than raising: desclint flags them as DESC106, and sizing is
        # used on telemetry paths that must never throw.
        if self.op in (OpType.FILL, OpType.FILL_VERIFY):
            return max(self.n_words, 0) * 4
        if self.op == OpType.BATCH_COPY and self.src is not None:
            shape = getattr(self.src, "shape", None)
            idx_shape = getattr(self.src_idx, "shape", None)
            if not shape or shape[0] == 0 or not idx_shape:
                return 0
            per = tensor_nbytes(self.src) // shape[0]
            return per * int(idx_shape[0])
        return tensor_nbytes(self.src)


@dataclasses.dataclass
class BatchDescriptor:
    """F2: one submission carrying many work descriptors.  The engine fuses
    homogeneous copy batches into a single batch-copy kernel launch; mixed
    batches are processed back-to-back under one completion record."""

    descriptors: Sequence[WorkDescriptor]
    # batch-level locality: the dominant home nodes across members (stamped
    # by the Device alongside each member's own src_node/dst_node)
    src_node: Optional[int] = None
    dst_node: Optional[int] = None
    desc_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    priority: int = 0

    @property
    def nbytes(self) -> int:
        return sum(d.nbytes for d in self.descriptors)


@dataclasses.dataclass
class CompletionRecord:
    desc_id: int
    status: Status = Status.PENDING
    op: Optional[str] = None  # op name ("memcpy", "batch", ...) for telemetry
    result: Any = None  # op-specific payload (tensors / scalars)
    bytes_processed: int = 0
    modeled_time_us: float = 0.0  # perfmodel estimate on the target card
    wall_time_us: float = 0.0  # measured host time, launch to retirement
    error: Optional[str] = None
    # WQ QoS attribution (paper Fig. 9 / Fig. 12): which WQ dispatched the
    # descriptor, how long it sat queued, and where completions were steered
    wq: Optional[str] = None
    queue_delay_us: float = 0.0
    steering: Optional[str] = None  # "to_cache" | "to_memory"
    # NUMA placement attribution (paper §4 / Fig. 13): where the servicing
    # engine lives, the operands' home nodes, and how many inter-node link
    # crossings the transfer was charged (0 = fully local)
    engine_node: int = 0
    src_node: int = 0
    dst_node: int = 0
    link_hops: int = 0
    # (stream, event) of the submitter on a CUDA engine, the event recorded
    # on the stream at submit time (None on the CPU).  The PE slot's stream
    # waits on the event before launching, so the kernel reads operands only
    # after the work that produced them; the outputs are recorded on the
    # stream, so the caching allocator does not hand their memory to later
    # kernels while work the submitter queued there still reads it.
    submit_point: Any = dataclasses.field(default=None, repr=False, compare=False)

    def is_done(self) -> bool:
        return self.status in (Status.SUCCESS, Status.ERROR, Status.OVERFLOW)


def op_name(desc) -> str:
    """Telemetry label for a submittable: the op type, or "batch" for a
    multi-descriptor submission."""
    op = getattr(desc, "op", None)
    if op is not None:
        return op.value if isinstance(op, OpType) else str(op)
    return "batch"
