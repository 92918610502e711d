"""Mixture-of-experts block: a top-k router, shared experts and the
capacity-based dense dispatch (the JAX package's ``repro.models.moe`` in
PyTorch).

The router follows deepseek-moe (a softmax gate over the routed experts,
top-k with renormalised weights, a load-balancing aux loss) and is top-1
for llama4-maverick.  Routing and dispatch keep the reference's order,
because which assignments a full expert drops depends on it:

* ties among the router's probabilities go to the lower expert index, as
  ``jax.lax.top_k`` orders them (a stable descending sort; ``torch.topk``
  promises no order among ties);
* an assignment's place in its expert's bucket counts the assignments
  before it in the token-major flattening (token 0's k choices, then
  token 1's); one at or past the capacity is dropped;
* a token's k expert outputs are added in order k = 0 .. k-1 in the
  model's dtype, as the reference's scatter-add does, and never through
  atomics, whose order (and so whose bf16 sum) changes from run to run on
  the card.

The expert-parallel all-to-all dispatch (``dispatch="a2a"``) needs a mesh,
which the port cannot build until ``distributed/`` is ported
(``DecoderModel(mesh=...)`` raises); without one the reference takes the
dense path, and so does the port.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import _act


def router_topk(x: torch.Tensor, w_router: torch.Tensor,
                cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [T, D] -> (weights [T, k] f32, idx [T, k] int64, aux loss f32 scalar)."""
    logits = x.float() @ w_router.float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :cfg.top_k], idx[:, :cfg.top_k]
    if cfg.top_k > 1:
        weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    # switch-style load-balancing loss over the top-1 choices
    E = w_router.shape[-1]
    me = probs.mean(dim=0)  # mean router probability per expert
    ce = F.one_hot(idx[:, 0], E).float().mean(dim=0)  # share of tokens by top-1 choice
    aux = (me * ce).sum() * E * cfg.aux_loss_coef
    return weights, idx, aux


def dispatch_plan(idx: torch.Tensor, cfg: MoEConfig, T: int):
    """Where each of the T * k assignments goes: (flat expert ids [T*k],
    positions in the expert's bucket [T*k] (0 where dropped), keep mask
    [T*k], source token of each assignment [T*k], capacity)."""
    E, k = cfg.num_experts, cfg.top_k
    cap = max(int(cfg.capacity_factor * k * T / E), 1)
    flat_e = idx.reshape(-1)
    onehot = F.one_hot(flat_e, E)
    # 0-based position of each assignment among its expert's, in token-major order
    pos = torch.gather(torch.cumsum(onehot, dim=0), 1, flat_e[:, None])[:, 0] - 1
    keep = pos < cap
    pos_c = torch.where(keep, pos, torch.zeros_like(pos))
    src_tok = torch.arange(T, device=idx.device).repeat_interleave(k)
    return flat_e, pos_c, keep, src_tok, cap


def _moe_dense(xt: torch.Tensor, weights: torch.Tensor, idx: torch.Tensor, p: dict,
               cfg: MoEConfig, act: str) -> torch.Tensor:
    """Capacity-based scatter / gather dispatch.  Tokens go into per-expert
    buckets [E, cap, D], each expert's FFN runs as one batched product, and
    the results come back weighted by the router.  A kept assignment has a
    bucket row of its own, so the scatter writes each row once; the dropped
    ones write a spare row past the buckets, which is cut off."""
    T, D = xt.shape
    E, k = cfg.num_experts, cfg.top_k
    flat_e, pos_c, keep, src_tok, cap = dispatch_plan(idx, cfg, T)
    spare = E * cap
    row = torch.where(keep, flat_e * cap + pos_c, torch.full_like(pos_c, spare))
    buckets = torch.zeros((spare + 1, D), dtype=xt.dtype, device=xt.device)
    buckets[row] = xt[src_tok]
    buckets = buckets[:spare].view(E, cap, D)

    fn = _act(act)
    hh = fn(torch.bmm(buckets, p["w1"])) * torch.bmm(buckets, p["w3"])
    out = torch.bmm(hh, p["w2"])  # [E, cap, D]

    gathered = out.reshape(spare, D)[flat_e * cap + pos_c]  # [T*k, D]
    gathered = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
    terms = (gathered * weights.reshape(-1, 1).to(gathered.dtype)).view(T, k, D)
    y = torch.zeros_like(xt)
    for j in range(k):  # the reference's scatter-add order, in the model's dtype
        y = y + terms[:, j]
    return y


def moe_block(x: torch.Tensor, p: dict, cfg: MoEConfig, act: str = "silu",
              dispatch: str = "dense", mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux loss).

    p = {router [D, E] f32, w1 / w3 [E, D, F], w2 [E, F, D], and with
    shared experts shared_w1 / shared_w3 [D, F * ns], shared_w2 [F * ns, D]}.
    ``dispatch`` and ``mesh`` keep the reference's signature: without a
    mesh both dispatches are the dense one."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    weights, idx, aux = router_topk(xt, p["router"], cfg)
    y = _moe_dense(xt, weights, idx, p, cfg, act)
    if cfg.num_shared_experts > 0:
        fn = _act(act)
        sh = fn(xt @ p["shared_w1"]) * (xt @ p["shared_w3"])
        y = y + sh @ p["shared_w2"]
    return y.reshape(B, S, D), aux


def _normal_stack(gen: torch.Generator, shape, scale: float, dtype, n: Optional[int]):
    """Normal weights times ``scale`` in ``dtype``, [n, *shape] when ``n``
    is given, drawn one layer at a time so no f32 copy of a whole expert
    stack is ever held (deepseek-moe-16b's w1 stack is 19.9 GB in f32)."""
    if n is None:
        return (torch.randn(tuple(shape), generator=gen, device=gen.device) * scale).to(dtype)
    out = torch.empty((n, *shape), dtype=dtype, device=gen.device)
    for i in range(n):
        out[i] = torch.randn(tuple(shape), generator=gen, device=gen.device) * scale
    return out


def init_moe_params(gen: torch.Generator, cfg: MoEConfig, d_model: int, dtype,
                    n: Optional[int] = None) -> dict:
    """The reference's leaves, scales and dtypes (the router in f32), drawn
    from ``gen``; ``n`` stacks that many layers."""
    E, F_ = cfg.num_experts, cfg.d_ff_expert
    s_in, s_out = d_model ** -0.5, F_ ** -0.5
    p = {
        "router": _normal_stack(gen, (d_model, E), s_in, torch.float32, n),
        "w1": _normal_stack(gen, (E, d_model, F_), s_in, dtype, n),
        "w3": _normal_stack(gen, (E, d_model, F_), s_in, dtype, n),
        "w2": _normal_stack(gen, (E, F_, d_model), s_out, dtype, n),
    }
    if cfg.num_shared_experts > 0:
        Fs = F_ * cfg.num_shared_experts
        p["shared_w1"] = _normal_stack(gen, (d_model, Fs), s_in, dtype, n)
        p["shared_w3"] = _normal_stack(gen, (d_model, Fs), s_in, dtype, n)
        p["shared_w2"] = _normal_stack(gen, (Fs, d_model), Fs ** -0.5, dtype, n)
    return p
