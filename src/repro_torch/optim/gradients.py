"""Gradient utilities: global-norm clipping, microbatch accumulation, and
int8 error-feedback compression (distributed-optimization trick; flagged)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import tree as _tree
from repro_torch.distributed.annotate import unflatten
from repro_torch.obs.spans import stage
from repro_torch.roofline.op_cost import counted_range


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in _tree.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _tree.tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


class GradAccumulator:
    """Microbatch gradient accumulation: a loop over microbatches (a
    ``counted_range``, the reference's ``lax.scan``).

    ``accumulate(loss_fn, params, batch, n)`` splits the leading batch dim of
    every leaf into ``n`` microbatches (a leaf named ``positions_thw`` has
    its batch at axis 1) and averages grads in fp32.  ``loss_fn(params,
    batch)`` returns ``(loss, metrics)`` and is differentiated with
    ``torch.autograd.grad`` over the parameter leaves (not ``torch.func``:
    its transforms refuse the saved-tensor hooks of the model's
    non-reentrant activation checkpointing).  Buffer zeroing between
    macro-steps is the engine's Memory Fill op in the real pipeline (see
    repro_torch.kernels.ops.fill_like).
    """

    @staticmethod
    def accumulate(loss_fn, params, batch, n: int):
        def grad_and_value(params, batch):
            flat, treedef = _tree.flatten(params)
            leaves = [p.detach().requires_grad_(True) for p in flat]
            with torch.enable_grad():
                with stage("train.forward", "train"):
                    loss, metrics = loss_fn(_tree.unflatten(treedef, leaves), batch)
                # the parent of the spans autograd's thread opens: remat
                # replays and the attention backward
                with stage("train.backward", "backward", cross_thread=True):
                    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
            metrics = _tree.tree_map(lambda m: m.detach(), metrics)
            return _tree.unflatten(treedef, grads), (loss.detach(), metrics)

        if n <= 1:
            grads, (loss, metrics) = grad_and_value(params, batch)
            return loss, metrics, grads

        def split(x):
            bsz = x.shape[0] if x.dim() else 1
            return unflatten(x.reshape((bsz,) + tuple(x.shape[1:])), 0, (n, bsz // n))

        def split_leaf(path, x):
            if path and path[-1] == "positions_thw":
                return unflatten(x, 1, (n, x.shape[1] // n)).transpose(0, 1)
            return split(x)

        pairs, treedef = _tree.flatten_with_path(batch)
        micro = [split_leaf(path, x) for path, x in pairs]
        # zeros_like: a DTensor parameter's accumulator is laid out like it
        acc = _tree.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        loss_sum = torch.zeros(())
        # the first add lays each accumulator out as its gradient (a
        # parameter's Replicate becomes the data axes' Partial sum), the
        # later ones add like to like: the first micro-step is counted alone
        loop = counted_range(n, peel=1)
        for i in loop:
            mb = _tree.unflatten(treedef, [x[i] for x in micro])
            grads, (loss, _) = grad_and_value(params, mb)
            acc = _tree.tree_map(lambda a, g: a + g.to(torch.float32), acc, grads)
            loss_sum = loss_sum + loss
            # this micro-step's gradients are dead before the next one's
            # backward, as in the reference's scan body
            del grads
            loop.exit(*_tree.leaves(acc), loss_sum)
        grads = _tree.tree_map(lambda a: a / n, acc)
        loss = loss_sum / n
        return loss, {"ce": loss, "aux": torch.zeros(())}, grads


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization (for gradient all-reduce)."""
    scale = torch.clamp(torch.max(torch.abs(g.to(torch.float32))), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)
