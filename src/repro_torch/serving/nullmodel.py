"""Null decoder: a constant-work model for open-loop datapath experiments.

DPDK benchmarks its datapath against the *null PMD*, a poll-mode device
that accepts every packet and does no per-packet work — so queueing,
admission, and copy behaviour are measured without the workload's own
compute noise.
``NullDecoder`` is that for the Vhost-style server: it satisfies the full
serving model interface (``init`` / ``init_cache`` / ``prefill`` /
``decode_step``) and emits the deterministic token stream
``tok -> (tok + 1) % vocab``, while costing near-zero compute.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.engine import resolve_device


class NullDecoder:
    """Minimal model honouring the serving interface.

    The cache is one stacked segment ``[1, B, 1]`` (so ``_splice_cache``
    exercises the same stacked-leaf path a real scanned decoder hits) plus
    the ``lengths`` vector every cache carries.  ``device``: None means
    CUDA, ``"cpu"`` the CPU."""

    def __init__(self, vocab_size: int = 256, device=None):
        if vocab_size < 2:
            raise ValueError(f"vocab_size must be >= 2, got {vocab_size}")
        self.vocab_size = vocab_size
        self.device = resolve_device(device)

    def init(self, gen) -> dict:
        return {}

    def init_cache(self, batch: int, max_cache_len: int) -> dict:
        return {
            "segments": [{"state": torch.zeros((1, batch, 1), dtype=torch.float32,
                                               device=self.device)}],
            "lengths": torch.zeros((batch,), dtype=torch.int32, device=self.device),
        }

    def _logits(self, last: torch.Tensor) -> torch.Tensor:
        return F.one_hot((last.long() + 1) % self.vocab_size, self.vocab_size).float()

    def prefill(self, params, batch: dict, max_cache_len: int):
        tokens = batch["tokens"]  # [B, S]
        b, s = tokens.shape
        cache = {
            "segments": [{"state": torch.zeros((1, b, 1), dtype=torch.float32,
                                               device=tokens.device)}],
            "lengths": torch.full((b,), s, dtype=torch.int32, device=tokens.device),
        }
        return cache, self._logits(tokens[:, -1]), cache["lengths"]

    def decode_step(self, params, cache: dict, tokens):
        # tokens [B, 1] -> logits [B, V]; the cache only tracks lengths
        cache = {"segments": cache["segments"], "lengths": cache["lengths"] + 1}
        return self._logits(tokens[:, 0]), cache
