"""Roofline terms of one step on the NVIDIA H100 (the JAX package's
``repro.roofline.analysis`` in PyTorch).

Terms per (arch x shape x mesh), all in seconds-per-step on ``H100``:

  compute    = FLOPs_per_rank / peak_flops
  memory     = bytes_per_rank / hbm_bw
  collective = ring-model collective bytes per rank / ici_bw

The reference reads its FLOPs, bytes and collectives from XLA's compiled
HLO.  The port runs eagerly and has no HLO: ``repro_torch.roofline.op_cost``
counts the aten ops and collectives one rank dispatches, and
``collective_bytes_from_log`` applies the reference's ring formulas to the
collectives it recorded (op, result bytes, group size g):

  all-gather          (g-1)/g * result_bytes
  all-reduce          2 * (g-1)/g * result_bytes
  reduce-scatter      (g-1)   * result_bytes       (input = g * result)
  all-to-all          (g-1)/g * result_bytes
  collective-permute  result_bytes
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, Tuple


@dataclasses.dataclass(frozen=True)
class HW:
    """One accelerator's roofline constants.  The field names are the
    reference's, so records and the report read the same keys."""

    # dense bf16 tensor-core FLOP/s of one card
    peak_flops: float
    # HBM bytes/s of one card
    hbm_bw: float
    # bytes/s of the slowest link a collective's ring crosses
    ici_bw: float
    # HBM capacity of one card, bytes
    hbm_bytes: float
    # the on-chip memory a kernel can steer data into: the L2 (its
    # persisting window is the port's ``vmem`` placement)
    vmem_bytes: float
    # one kernel launch + dispatch + completion seen by the host
    launch_overhead_s: float


#: NVIDIA H100 80GB HBM3 (SXM5): NVIDIA's data sheet, dense rates at the
#: 700 W power limit, except ``launch_overhead_s``, which is measured.
H100 = HW(
    peak_flops=989e12,  # bf16 / fp16 dense, tensor cores
    hbm_bw=3.35e12,  # HBM3
    # one 400 Gb/s NDR InfiniBand port per GPU: the slowest link a ring of
    # 256 or 512 ranks crosses.  Within 8 GPUs NVLink 4 moves 450 GB/s a
    # direction; a ring that stays inside one node runs at that rate.
    ici_bw=50e9,
    hbm_bytes=80e9,
    vmem_bytes=50 * 2 ** 20,  # L2
    # a 4 KiB memcpy_words launch -> event -> host, median (calibrate.py on
    # an H100 80GB HBM3 at 700 W; core/perfmodel.py's launch_overhead_s)
    launch_overhead_s=33.2e-6,
)

def ring_bytes(op: str, result_bytes: float, g: int) -> float:
    """Bytes one rank moves for collective ``op`` over a group of ``g``
    (the ring formulas above; a group of one moves nothing)."""
    if g <= 1:
        return 0.0
    if op == "all-gather":
        return result_bytes * (g - 1) / g
    if op == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return result_bytes * (g - 1)
    if op == "all-to-all":
        return result_bytes * (g - 1) / g
    if op == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"unknown collective {op!r}")


def collective_bytes_from_log(records: Iterable[dict]
                              ) -> Tuple[float, Dict[str, Dict[str, float]]]:
    """Returns (total per-rank collective bytes, per-op breakdown) from the
    counter's records: those with a ``"collective"`` kind, each with its
    ``"result_bytes"`` and group size ``"group"``.  Groups of one are left
    out, as the reference leaves out replica groups of one.  A record's
    ``n`` (default 1) counts it that many times."""
    per_op: Dict[str, Dict[str, float]] = defaultdict(lambda: {"count": 0, "bytes": 0.0})
    total = 0.0
    for r in records:
        op = r.get("collective")
        if not op or r["group"] <= 1:
            continue
        n = r.get("n", 1)
        moved = ring_bytes(op, r["result_bytes"], r["group"]) * n
        per_op[op]["count"] += n
        per_op[op]["bytes"] += moved
        total += moved
    return total, dict(per_op)


def roofline_terms(
    flops_per_dev: float,
    bytes_per_dev: float,
    coll_bytes_per_dev: float,
    hw: HW = H100,
) -> Dict[str, float]:
    compute = flops_per_dev / hw.peak_flops
    memory = bytes_per_dev / hw.hbm_bw
    collective = coll_bytes_per_dev / hw.ici_bw
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    bound = max(compute, memory, collective)
    terms["roofline_fraction_compute"] = compute / bound if bound > 0 else 0.0
    return terms


def model_flops_for_cell(cfg, shape, mode: str) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE); decode counts one
    token per sequence, prefill/train count every token."""
    n = cfg.active_params()
    if mode == "decode":
        tokens = shape.global_batch
        return 2.0 * n * tokens  # forward only
    tokens = shape.global_batch * shape.seq_len
    if mode == "prefill":
        return 2.0 * n * tokens
    return 6.0 * n * tokens  # fwd + bwd
