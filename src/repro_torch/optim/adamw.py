"""Functional AdamW with fp32 moments over (possibly) bf16 params.

The moment buffers are where the Memory Fill engine op earns its keep at
init/reset time (paper Table 1: gradient-buffer zeroing is the canonical
ML use of DSA's Fill; see §5 "HPC/ML acceleration").

Functional as in the JAX package: ``update`` returns new params and a new
state and changes nothing in place.  Trees are nested dicts, lists, tuples
and NamedTuples of tensors (repro_torch.tree).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple, Union

import torch

from repro_torch import tree as _tree


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any  # fp32 tree
    v: Any  # fp32 tree


def cosine_schedule(base_lr: float, warmup: int, total: int, min_frac: float = 0.1) -> Callable:
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable, float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params) -> AdamWState:
        """Zero fp32 moments shaped like ``params``, on their devices; the
        step counter goes on the first parameter's device."""
        flat = _tree.leaves(params)
        dev = flat[0].device if flat else torch.device("cpu")
        # zeros_like: a DTensor parameter's moments are DTensors laid out like it
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m=_tree.tree_map(zeros, params),
            v=_tree.tree_map(zeros, params),
        )

    def update(self, grads, state: AdamWState, params) -> Tuple[Any, AdamWState]:
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - b1 ** step.to(torch.float32)
        c2 = 1.0 - b2 ** step.to(torch.float32)

        def upd(g, m, v, p):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mh = m / c1
            vh = v / c2
            delta = mh / (torch.sqrt(vh) + self.eps) + self.weight_decay * p.to(torch.float32)
            return m, v, (p.to(torch.float32) - lr * delta).to(p.dtype)

        flat_g, treedef = _tree.flatten(grads)
        flat_m = _tree.flatten_like(treedef, state.m)
        flat_v = _tree.flatten_like(treedef, state.v)
        flat_p = _tree.flatten_like(treedef, params)
        out = [upd(g, m, v, p) for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p)]
        new_m = _tree.unflatten(treedef, [o[0] for o in out])
        new_v = _tree.unflatten(treedef, [o[1] for o in out])
        new_p = _tree.unflatten(treedef, [o[2] for o in out])
        return new_p, AdamWState(step=step, m=new_m, v=new_v)
