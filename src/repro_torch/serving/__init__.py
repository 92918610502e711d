from repro_torch.serving.kv_pool import PagedKVPool
from repro_torch.serving.nullmodel import NullDecoder
from repro_torch.serving.pipeline import ReorderArray, Request, VhostStyleServer
from repro_torch.serving.slo import (
    DEFAULT_SLO_CLASSES,
    AdmissionController,
    LatencyTracker,
    SLOClass,
)
from repro_torch.serving.traffic import (
    ArrivalProcess,
    BurstyArrivals,
    DiurnalArrivals,
    OpenRequest,
    PoissonArrivals,
    TrafficGenerator,
    ZipfLengths,
)

__all__ = [
    "AdmissionController",
    "ArrivalProcess",
    "BurstyArrivals",
    "DEFAULT_SLO_CLASSES",
    "DiurnalArrivals",
    "LatencyTracker",
    "NullDecoder",
    "OpenRequest",
    "PagedKVPool",
    "PoissonArrivals",
    "ReorderArray",
    "Request",
    "SLOClass",
    "TrafficGenerator",
    "VhostStyleServer",
    "ZipfLengths",
]
