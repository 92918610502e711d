"""deepseek-moe-16b (arXiv:2401.06066) in plain float32 PyTorch, and the
benchmark's FLOP counts for it.

A decoder of ``num_layers`` layers: RMS norm, multi-head attention with
rotary embeddings, RMS norm, then a gated MLP in the first
``first_moe_layer`` layers and a mixture of experts in the rest (top-k of
``num_experts`` routed experts over a softmax, the k weights renormalised,
plus ``num_shared_experts`` shared ones); a final norm and an untied
unembedding.  Departures from the published model, as the configuration
is run: the norm gains are ``1 + w``; the top-k weights are renormalised;
the capacity rule of ``layers.moe`` (with this configuration's capacity
factor no assignment is dropped, as none is in the published model).
"""
from __future__ import annotations

from typing import List

import torch

from bench.reference import layers as R


def _layer(x, w: dict, cfg: dict, i: int, prec: R.Precision):
    """One layer over one sequence.  x [1, S, D]."""
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    x = x + R.attn_block(R.rms_norm(x, w["ln1"], cfg["norm_eps"]), w["attn"], cfg, pos,
                         prec=prec)
    h = R.rms_norm(x, w["ln2"], cfg["norm_eps"])
    if i < cfg["moe"]["first_moe_layer"]:
        return x + R.gated_mlp(h, w["mlp"], cfg["act"], prec)
    return x + R.moe(h[0], w["moe"], cfg["moe"], cfg["act"], prec)[None]


def logits(cfg: dict, W, seqs: List[torch.Tensor], starts: List[int],
           prec: R.Precision = R.FP32) -> List[torch.Tensor]:
    """Each sequence's full forward pass (no cache), layer by layer over
    all of them, so that one layer's weights are held at a time; returns
    the float32 logits [len(seq) - start, V] at positions start .. end - 1
    of each."""
    with R.exact(), torch.no_grad():
        embed = W.top("embed")
        xs = [embed[s.long()][None] for s in seqs]
        del embed
        for i in range(W.n_layers):
            w = W.layer(i)
            xs = [_layer(x, w, cfg, i, prec) for x in xs]
            del w
        norm, unembed = W.top("final_norm"), W.top("unembed")
        return [prec.mm(R.rms_norm(x[0, st:], norm, cfg["norm_eps"]), unembed)
                for x, st in zip(xs, starts)]


# --------------------------------------------------------------------------- FLOPs
def matmul_flops_per_token(cfg: dict, layer: int) -> float:
    """Multiply-adds x 2 of one token through ``layer``'s products (the
    attention's projections, the router and the k routed and the shared
    experts, or the dense MLP), without the attention's own products."""
    D, H, KV, hd = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    attn = 2 * D * (H + 2 * KV) * hd + 2 * H * hd * D
    m = cfg["moe"]
    if layer < m["first_moe_layer"]:
        return attn + 6 * D * (m["d_ff_dense"] or cfg["d_ff"])
    experts = m["top_k"] + m.get("num_shared_experts", 0)
    return attn + 2 * D * m["num_experts"] + 6 * D * m["d_ff_expert"] * experts


def forward_flops(cfg: dict, n_tokens: int, pairs: int, logit_rows: int) -> float:
    """A forward pass over ``n_tokens`` tokens whose attention computes
    ``pairs`` (query, key) pairs in each layer, and ``logit_rows`` rows of
    logits."""
    L = cfg["num_layers"]
    per_token = sum(matmul_flops_per_token(cfg, i) for i in range(L))
    attn = 4 * cfg["num_heads"] * cfg["head_dim"] * pairs * L
    return n_tokens * per_token + attn + 2 * cfg["d_model"] * cfg["vocab_size"] * logit_rows


def prefill_flops(cfg: dict, n: int) -> float:
    """The prefill of an n-token prompt: every position, one row of logits."""
    return forward_flops(cfg, n, R.visible_pairs(0, n), 1)


def decode_flops(cfg: dict, position: int) -> float:
    """One decode step of one sequence at 0-based ``position``."""
    return forward_flops(cfg, 1, position + 1, 1)


def attention_call(cfg: dict, n: int):
    """(FLOPs, bytes) of one layer's causal attention over an n-token
    prompt: QK^T and PV over the visible pairs; q, k, v read and o written
    once in bf16."""
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    return 4 * H * hd * R.visible_pairs(0, n), 2 * n * hd * (2 * H + 2 * KV)


def attention_layers(cfg: dict) -> int:
    return cfg["num_layers"]
