"""The DSA-style descriptor-programmed streaming engine on PyTorch + CUDA.

Entry point: ``Device`` / ``make_device``: policy-driven multi-instance
submission returning ``Future`` objects; completion waiting is pluggable
(``WaitPolicy``: spin / pause / umwait / interrupt) with set-oriented
``wait_any`` / ``wait_all`` / ``as_completed`` on the device.  Engines run
on the GPU unless the caller passes ``device="cpu"``.  ``dto`` /
``dto_enabled`` are the drop-in memcpy/memset/memcmp layer (DTO analogue).

The deprecated ``Stream`` / ``make_stream`` shims were removed."""
from repro_torch.core.api import dto, dto_enabled
from repro_torch.core.completion import (
    WAIT_POLICIES,
    CompletionSet,
    InterruptWait,
    PauseWait,
    SpinWait,
    UmwaitWait,
    WaitPolicy,
    WaitStats,
    WaitTimeout,
    get_wait_policy,
)
from repro_torch.core.descriptor import (
    BatchDescriptor,
    CacheHint,
    CompletionRecord,
    OpType,
    Status,
    WorkDescriptor,
)
from repro_torch.core.device import (
    ChainedFuture,
    Device,
    Future,
    LeastLoadedPolicy,
    NumaLocalPolicy,
    Promise,
    QueueFull,
    RoundRobinPolicy,
    StickyPolicy,
    SubmitPolicy,
    SubmitRing,
    get_policy,
    make_device,
)
from repro_torch.core.engine import DeviceConfig, GroupConfig, StreamEngine
from repro_torch.core.perfmodel import DEFAULT_MODEL, EngineModel, TIERS
from repro_torch.core.queues import TRAFFIC_CLASSES, WorkQueue, WQConfig
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.topology import Link, Node, Topology

__all__ = [
    "BatchDescriptor",
    "CacheHint",
    "ChainedFuture",
    "CompletionRecord",
    "CompletionSet",
    "Device",
    "DeviceConfig",
    "DEFAULT_MODEL",
    "EngineModel",
    "Future",
    "GroupConfig",
    "InterruptWait",
    "LeastLoadedPolicy",
    "Link",
    "Node",
    "NumaLocalPolicy",
    "OpType",
    "PauseWait",
    "Promise",
    "QueueFull",
    "RoundRobinPolicy",
    "SpinWait",
    "Status",
    "StickyPolicy",
    "StreamEngine",
    "SubmitPolicy",
    "SubmitRing",
    "Telemetry",
    "TIERS",
    "Topology",
    "TRAFFIC_CLASSES",
    "UmwaitWait",
    "WAIT_POLICIES",
    "WaitPolicy",
    "WaitStats",
    "WaitTimeout",
    "WorkDescriptor",
    "WorkQueue",
    "WQConfig",
    "dto",
    "dto_enabled",
    "get_policy",
    "get_wait_policy",
    "make_device",
]


def __getattr__(name: str):
    if name in ("Stream", "make_stream"):
        raise AttributeError(
            f"repro_torch.core.{name} was removed: the deprecated Stream shim API "
            "is gone. Use repro_torch.core.make_device / Device; submissions "
            "return Future objects.")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
