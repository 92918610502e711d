"""The latent decode kernel's share of its roofline over the profiled span:
the least time its calls could take (each call's live latent slots, and
its rows' absorbed queries and latent outputs, read or written once at the
HBM peak, or its FLOPs at the bf16 peak, whichever is longer) over the
device time of the kernels named ``mla_decode`` (split and combine), in %.

The live slots of a call are not in the trace: the server counts them on
the host for each decode step (its ``serving.decode.live_slots`` gauge:
every row's [0, length], within the cache), and every layer's call of a
step reads the same slots.  So the bound is the window's mean of that
count times the kernel's calls in the span (its split kernels counted),
not the span's own steps; the rows are the cell's slots."""
from bench.harness.core import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def read(run):
    tr, live = run.device_trace, run.gauges.get("serving.decode.live_slots")
    if tr is None or not live:
        return None
    calls = sum(1 for _, _, name in tr.kernels if "mla_decode_split" in name)
    busy = tr.kernel_seconds("mla_decode")
    if not calls or busy <= 0:
        return None
    ref, cfg = run.cell.reference(), run.cell.config["model"]
    flops, nbytes = ref.mla_decode_call(cfg, run.cell.traffic["slots"], sum(live) / len(live))
    return 100.0 * calls * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) / busy
