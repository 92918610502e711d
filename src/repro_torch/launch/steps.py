"""Prefill and decode step builders for serving.

These close over a model and return plain functions; PyTorch runs them
eagerly (the reference jits them, with the cache donated: here the decode
step updates the cache in place).  ``make_train_step`` waits for the
training slice.
"""
from __future__ import annotations

from typing import Callable

import torch


def make_train_step(*_a, **_k) -> Callable:
    raise NotImplementedError("make_train_step waits for the training slice "
                              "(ROADMAP.md, queue 1: training)")


def make_prefill_step(model, max_cache_len: int) -> Callable:
    """(params, batch) -> (cache, next_token [B, 1] int32, lengths)."""

    def prefill_step(params, batch):
        cache, logits, lengths = model.prefill(params, batch, max_cache_len)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return cache, next_token, lengths

    return prefill_step


def make_decode_step(model, sample: bool = False) -> Callable:
    """(params, cache, tokens) -> (next_tokens [B, 1] int32, cache).  Greedy:
    ties go to the first index, as in the reference."""

    def decode_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_token, cache

    return decode_step
