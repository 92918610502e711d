"""Train, prefill and decode step builders.

These close over a model (and an optimizer) and return plain functions;
PyTorch runs them eagerly (the reference jits them, donating the state: the
decode step here updates the cache in place).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch import tree as _tree
from repro_torch.distributed.sharding import place_like
from repro_torch.obs.spans import stage
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.gradients import GradAccumulator, clip_by_global_norm


def make_train_step(model, optimizer: AdamW, micro_steps: int = 1, clip_norm: float = 1.0,
                    grad_shardings: Optional[Any] = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``grad_shardings`` (ZeRO-2: a tree of ``NamedSharding``, normally the
    optimizer moments', ``opt_state_shardings(...).m``) lays the f32
    gradient tree out like the moments, so the data-parallel sum is a
    reduce-scatter and the whole f32 gradient tree is never held on one
    rank.  Without it the gradients of DTensor parameters take their
    parameters' layout.  The new parameters and optimizer state keep the
    old ones' layout (ZeRO-1 keeps the moments sharded across steps)."""

    def train_step(params, opt_state: AdamWState, batch):
        with stage("train.step", "train"):
            loss, metrics, grads = GradAccumulator.accumulate(model.loss, params, batch,
                                                              micro_steps)
            with stage("train.optimizer", "train"):
                grads = _tree.tree_map(place_like, grads,
                                       params if grad_shardings is None else grad_shardings)
                if clip_norm > 0:
                    grads, gnorm = clip_by_global_norm(grads, clip_norm)
                else:
                    gnorm = torch.zeros((), device=loss.device)
                new_params, new_state = optimizer.update(grads, opt_state, params)
                new_params = _tree.tree_map(place_like, new_params, params)
                new_state = _tree.tree_map(place_like, new_state, opt_state)
            out_metrics = {"loss": loss, "grad_norm": gnorm, **metrics}
        return new_params, new_state, out_metrics

    return train_step


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
