"""The DSA-style descriptor-programmed streaming engine on PyTorch + CUDA.

Entry point: ``Device`` / ``make_device``: policy-driven multi-instance
submission returning ``Future`` objects; completion waiting is pluggable
(``WaitPolicy``: spin / pause / umwait / interrupt) with set-oriented
``wait_any`` / ``wait_all`` / ``as_completed`` on the device.  Engines run
on the GPU unless the caller passes ``device="cpu"``."""
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
    "get_policy",
    "get_wait_policy",
    "make_device",
]
