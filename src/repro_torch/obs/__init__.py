"""Live observability over the streaming-engine fabric (paper §5).

``Telemetry`` (core/telemetry.py) answers "what happened" after a run;
this package answers "what is happening" while it runs — the pcm-accel
analogue.  A ``Sampler`` snapshots every engine / WQ / NUMA node / wait
policy at a fixed interval into bounded ring-buffer ``Series`` (delta
sampling over monotonic counters, O(engines) per tick) with CSV/JSONL
export and windowed percentile summaries; ``tools/pcm_repro.py`` renders
the live terminal view.  See docs/observability.md for the metric
glossary and lifecycle.

Descriptor-lifecycle tracing (docs/tracing.md) rides on the same package:
``make_device(trace=...)`` attaches a ``Tracer`` that records a span tree
per sampled descriptor (create -> validate -> submit -> wq_wait ->
engine_dispatch -> pe_exec -> completion_write -> host_wait -> callback),
dependency edges, and WaitPolicy wait spans; ``to_perfetto`` exports the
lot as Chrome/Perfetto trace_event JSON, and ``critical_path`` /
``phase_breakdown`` / ``host_free_fraction`` are the span analyzers
(``tools/trace_view.py`` is the CLI).

Stage spans name what the program itself was doing (a served request's
admission, the decode step's launch and read, a training step's phases,
the model's layer kinds): ``stage(name, mode, req)`` at each site records
into ``STAGES`` while a ``torch.profiler`` session records or inside
``recording()``, on the profiler's clock; ``to_perfetto(..., stages=STAGES.spans())``
draws them on a track of their own.
"""
from repro_torch.obs.export import to_csv, to_jsonl, to_perfetto
from repro_torch.obs.sampler import Sampler
from repro_torch.obs.series import Series, percentile
from repro_torch.obs.spans import (
    HOST_PHASES,
    NULL_STAGE,
    PHASES,
    STAGES,
    DescTrace,
    Span,
    StageRecorder,
    StageSpan,
    recording,
    stage,
)
from repro_torch.obs.trace import (
    TraceConfig,
    Tracer,
    TraceRateError,
    WaitSpan,
    critical_path,
    host_free_fraction,
    make_tracer,
    phase_breakdown,
    slowest,
)

__all__ = [
    "Sampler", "Series", "percentile",
    "to_csv", "to_jsonl", "to_perfetto",
    "PHASES", "HOST_PHASES", "DescTrace", "Span",
    "StageSpan", "StageRecorder", "STAGES", "NULL_STAGE", "stage", "recording",
    "Tracer", "TraceConfig", "TraceRateError", "WaitSpan", "make_tracer",
    "critical_path", "phase_breakdown", "host_free_fraction", "slowest",
]
