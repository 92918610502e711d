"""The flash kernel's share of its roofline over the profiled span: the
least time its calls could take (each layer's causal attention over each
prompt prefilled in the span: the visible pairs' FLOPs at the bf16 peak,
or q, k, v and o once at the HBM peak, whichever is longer) over the
device time of the kernels named ``flash_attention``, in %."""
from bench.harness.core import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def read(run):
    tr, prof = run.device_trace, run.records.get("profiled")
    if tr is None or not prof or not prof["prefills"]:
        return None
    busy = tr.kernel_seconds("flash_attention")
    if busy <= 0:
        return None
    ref, cfg = run.cell.reference(), run.cell.config["model"]
    bound = 0.0
    for n in prof["prefills"]:
        flops, nbytes = ref.attention_call(cfg, n)
        bound += ref.attention_layers(cfg) * max(flops / PEAK_BF16_FLOPS,
                                                 nbytes / PEAK_HBM_BYTES)
    return 100.0 * bound / busy
