"""Analytical performance model: the paper's §4 quantitative analysis with
the constants of an NVIDIA H100.

The paper's offload-crossover algebra survives the hardware swap; only the
constants change:

  DSA (SPR)                      ->  H100 port
  ENQCMD/MOVDIR64B ~100s ns      ->  kernel launch round trip
  30 GB/s per-instance fabric    ->  HBM3 copy rate of the port's memcpy kernel
  DDR local/remote, CXL tiers    ->  HBM / NVLink peer / pinned host tiers
  PE count per group             ->  PE slots, each with its own CUDA stream
  WQ depth (async in-flight)     ->  kernels in flight on the slot streams

The card's constants were measured by ``python -m repro_torch.calibrate`` on
one "NVIDIA H100 80GB HBM3" with a power limit of 700.00 W (as
``nvidia-smi --query-gpu=name,power.limit`` reports them); the host-side
submission and completion-wait costs are the paper's, and are labelled so.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

# memory tiers: sustained read/write bandwidth (B/s, bytes read plus bytes
# written) + extra one-way latency.  Measured on an NVIDIA H100 80GB HBM3 at
# 700.00 W by repro_torch/calibrate.py unless the line says otherwise.
TIERS: Dict[str, Dict[str, float]] = {
    # the port's memcpy kernel at 1 GiB: 1.434e12 copied B/s, read + write
    "hbm": {"bw": 2.867e12, "wr_bw": 2.867e12, "lat": 0.0},
    # the same kernel at 16 MiB, resident in the 50 MB L2 (the to_cache
    # steer, paper G3): 2.234e12 copied B/s; no latency term was measured
    "vmem": {"bw": 4.467e12, "wr_bw": 4.467e12, "lat": 0.0},
    # NVLink peer: 450 GB/s each way, NVIDIA's H100 data sheet (one card
    # cannot measure it); latency not measured
    "remote": {"bw": 450e9, "wr_bw": 450e9, "lat": 0.0},
    # pinned host memory over PCIe: 256 MiB host->device (read) and
    # device->host (write) copies; latency of one 4-byte host->device copy
    "host": {"bw": 54.05e9, "wr_bw": 55.29e9, "lat": 2.371e-6},
}


@dataclasses.dataclass(frozen=True)
class EngineModel:
    """Mechanisms (all from the paper, constants measured on the card):

    * per-descriptor processing RAMPS with transfer size (address translation
      + read-buffer fill latency): bw(s) = peak * s / (s + ramp_bytes);
    * one PE sustains only ``per_pe_frac`` of the pair bandwidth (finite read
      buffers, §3.4); a GROUP pools PEs, and in-flight descriptors (batch or
      async streaming) spread across them (paper: "a descriptor at the head
      of a WQ is eligible for any free PE");
    * launch overhead amortizes over async depth (G2) and batch size (G1).

    The software baseline is ``Tensor.copy_`` on the same card, which is as
    memory-bound as the port's own kernel, unlike the paper's CPU core at
    ~10 GB/s: the engine's gain on the card lies in overlap and in
    freeing the host, not in a faster copy.

    Card constants: measured by repro_torch/calibrate.py on an NVIDIA H100
    80GB HBM3 at a 700.00 W power limit.  Host-side constants: the paper's.
    """

    # one 4 KiB memcpy_words launch -> event -> host sees it (median)
    launch_overhead_s: float = 33.2e-6
    # paper constant: per-descriptor prep/submit on the host
    submit_overhead_s: float = 0.3e-6
    # paper constant (§3.2): the extra non-posted round trip a SHARED WQ pays
    # per submission (ENQCMD returns a carry flag; MOVDIR64B on a dedicated
    # WQ is posted and pays nothing), ~3x the posted submit cost
    enqcmd_overhead_s: float = 0.9e-6
    # paper constants (Fig. 11, "choose your wait scheme"): a completion-
    # record check; PAUSE keeps the core busy but throttles the poll loop;
    # UMWAIT parks the core (C0.2) and pays an exit latency on the monitored
    # write; an interrupt frees the core but costs delivery + handler +
    # reschedule per (coalesced) completion group
    completion_poll_s: float = 0.2e-6
    pause_poll_s: float = 0.1e-6
    umwait_wake_s: float = 0.5e-6
    irq_cost_s: float = 4e-6
    # the memcpy kernel's copy rate at 1 GiB (copied bytes / s)
    pe_peak_bw: float = 1.434e12
    # half-saturation size from the kernel's rate at 1 MiB against 1 GiB
    pe_ramp_bytes: float = 2.303e6
    # one stream's rate at 64 MiB over the peak, net of the ramp
    per_pe_frac: float = 0.957
    max_pes: int = 4  # per DSA instance (paper Table 2)
    # Tensor.copy_ at 1 GiB, and one 4 KiB Tensor.copy_ -> event -> host
    sw_memcpy_bw: float = 1.513e12
    sw_launch_s: float = 20.5e-6

    # ------------------------------------------------------------------ engine
    def _pair_bw(self, src_tier: str, dst_tier: str,
                 tiers: Optional[Dict[str, Dict[str, float]]] = None) -> float:
        t = TIERS if tiers is None else tiers
        if src_tier == dst_tier == "hbm":
            return self.pe_peak_bw
        return min(t[src_tier]["bw"], t[dst_tier]["wr_bw"])

    def op_time(
        self,
        nbytes: float,
        *,
        batch_size: int = 1,
        n_pe: int = 1,
        async_depth: int = 1,
        src_tier: str = "hbm",
        dst_tier: str = "hbm",
        read_factor: float = 1.0,  # dualcast reads once, writes twice => 1.5x
        tiers: Optional[Dict[str, Dict[str, float]]] = None,  # per-node override
        link: Optional[Any] = None,  # inter-node Link (topology.py): bw + lat_s
        link_hops: int = 0,  # crossings: remote src/dst count 1 each (§4 / Fig. 13)
    ) -> float:
        """Seconds to complete ONE submission of ``batch_size`` descriptors of
        ``nbytes`` each.

        ``tiers`` overrides the global tier table (a NUMA node's local
        memory); ``link``/``link_hops`` charge cross-node placement: each
        crossing caps the pair bandwidth at ``link.bw / hops`` (the shared
        UPI/NVLink analogue: an engine remote from both buffers crosses
        twice) and adds ``link.lat_s`` of one-way latency per hop, so any
        remote placement is strictly slower than all-local at every size.
        """
        t = TIERS if tiers is None else {**TIERS, **tiers}
        base = self._pair_bw(src_tier, dst_tier, t)
        if link is not None and link_hops > 0:
            base = min(base, link.bw / link_hops)
        pair = base / read_factor
        ramp = nbytes / (nbytes + self.pe_ramp_bytes)
        # in-flight descriptors (batch members and async stream) spread over PEs
        concurrent = min(batch_size * max(async_depth, 1), n_pe)
        agg_bw = min(concurrent * self.per_pe_frac * ramp, 1.0) * pair
        lat = max(t[src_tier]["lat"] + t[dst_tier]["lat"], 0.0)
        if link is not None and link_hops > 0:
            lat += link_hops * link.lat_s
        launch = self.launch_overhead_s / max(async_depth, 1) + lat / max(async_depth, 1)
        submit = self.submit_overhead_s * batch_size + self.completion_poll_s
        return launch + submit + batch_size * nbytes / agg_bw

    def throughput(self, nbytes: float, **kw) -> float:
        bs = kw.get("batch_size", 1)
        return bs * nbytes / self.op_time(nbytes, **kw)

    def op_time_default_pes(self, nbytes: float, **kw) -> float:
        """op_time with the default group shape (all 4 PEs pooled)."""
        kw.setdefault("n_pe", self.max_pes)
        return self.op_time(nbytes, **kw)

    # ------------------------------------------------------------------ baseline "core"
    def sw_time(self, nbytes: float, *, src_tier: str = "hbm", dst_tier: str = "hbm") -> float:
        bw = min(self.sw_memcpy_bw, TIERS[src_tier]["bw"], TIERS[dst_tier]["bw"])
        return self.sw_launch_s + nbytes / bw

    def sw_throughput(self, nbytes: float, **kw) -> float:
        return nbytes / self.sw_time(nbytes, **kw)

    def speedup(self, nbytes: float, **kw) -> float:
        return self.throughput(nbytes, **kw) / self.sw_throughput(
            nbytes, src_tier=kw.get("src_tier", "hbm"), dst_tier=kw.get("dst_tier", "hbm")
        )

    def crossover_bytes(self, **kw) -> float:
        """Smallest transfer where engine >= software (paper: ~4KB sync,
        ~256B async on DSA)."""
        lo, hi = 64.0, 1 << 30
        for _ in range(60):
            mid = (lo + hi) / 2
            if self.speedup(mid, **kw) >= 1.0:
                hi = mid
            else:
                lo = mid
        return hi


DEFAULT_MODEL = EngineModel()
