"""DeepSeek-V2-Lite (arXiv:2405.04434; the published config.json) in plain
float32 PyTorch, and the benchmark's FLOP and byte counts for it.

A decoder of ``num_layers`` layers: RMS norm, multi-head latent attention,
RMS norm, then a gated MLP in the first ``first_moe_layer`` layers and a
mixture of experts in the rest (top-k of ``num_experts`` routed experts
over a softmax, the k weights as the softmax gives them, plus
``num_shared_experts`` shared ones); a final norm and an untied
unembedding.  The latent attention of one layer, in the expanded form
(the program's decode runs the absorbed one, so the two forms are held
against each other):

* q = x Wq, [H, nope + rope] a token (no q latent: ``q_lora_rank`` null);
  [c_kv | k_pe] = x Wkv_a, c_kv RMS-normalised;
* [k_nope | v] = c_kv Wkv_b, [H, nope + v] a token;
* q's rope dims and k_pe roped with YaRN's frequencies, k_pe one head
  broadcast to all;
* causal softmax attention of [q_nope | q_pe] against [k_nope | k_pe] at
  scale (nope + rope) ** -0.5 x m(mscale_all_dim) ** 2, over v; then Wo.

YaRN: plain frequencies theta ** (-2i / dim) and the same over ``factor``,
blended over the ramp from slot floor(c(beta_fast)) to ceil(c(beta_slow)),
c(n) = dim ln(orig / (2 pi n)) / (2 ln theta); cos and sin times
m(mscale) / m(mscale_all_dim); m(a) = 0.1 a ln(factor) + 1.

Departures from the published model, as the configuration is run: the
norm gains are ``1 + w``; the rope rotates the halves of the rope dims
(DeepSeek's pairs are interleaved: a fixed permutation of the rope columns
of Wq and Wkv_a, which random weights do not see); the capacity rule of
``moe`` (with this configuration's capacity factor no assignment is
dropped, as none is in the published model).  Attention runs in blocks of
query rows, each against the keys up to its last row, so that 16k+
positions fit.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from bench.reference import layers as R


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_range(dim: int, theta: float, sc: dict):
    def c(rotations):
        return (dim * math.log(sc["original_max_position_embeddings"]
                               / (rotations * 2 * math.pi)) / (2 * math.log(theta)))

    return max(math.floor(c(sc["beta_fast"])), 0), min(math.ceil(c(sc["beta_slow"])), dim - 1)


def yarn_inv_freq(dim: int, theta: float, sc: dict) -> torch.Tensor:
    """[dim // 2] float64: YaRN's frequencies."""
    extra = theta ** (-torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    low, high = yarn_range(dim, theta, sc)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low)
            / max(high - low, 1e-3)).clamp(0.0, 1.0)
    return extra / sc["factor"] * ramp + extra * (1.0 - ramp)


def softmax_scale(cfg: dict) -> float:
    m, sc = cfg["mla"], cfg.get("rope_scaling")
    scale = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
    if sc and sc.get("mscale_all_dim"):
        scale *= yarn_mscale(sc["factor"], sc["mscale_all_dim"]) ** 2
    return scale


def rope(x: torch.Tensor, positions: torch.Tensor, cfg: dict) -> torch.Tensor:
    """YaRN rotary embedding of x [..., S, H, dr], halves rotated as pairs."""
    dr, theta, sc = x.shape[-1], cfg["rope_theta"], cfg.get("rope_scaling")
    if sc:
        freqs, mult = yarn_inv_freq(dr, theta, sc), (yarn_mscale(sc["factor"], sc["mscale"])
                                                      / yarn_mscale(sc["factor"],
                                                                    sc["mscale_all_dim"]))
    else:
        freqs, mult = theta ** (-torch.arange(0, dr, 2, dtype=torch.float64) / dr), 1.0
    ang = positions.to(torch.float64)[:, None] * freqs.to(x.device)  # [S, dr // 2]
    c = (torch.cos(ang) * mult).to(x.dtype)[:, None, :]
    s = (torch.sin(ang) * mult).to(x.dtype)[:, None, :]
    x1, x2 = x[..., :dr // 2], x[..., dr // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q, k, v, scale: float, prec: R.Precision = R.FP32, block: int = 1024):
    """Causal softmax attention.  q, k [B, S, H, dq]; v [B, S, H, dv].  Query
    rows in blocks of ``block``, each against the keys up to its last row."""
    S = q.shape[1]
    kk, vv = prec.q(k), prec.q(v)
    out = []
    for lo in range(0, S, block):
        hi = min(lo + block, S)
        s = torch.einsum("bqhd,bkhd->bhqk", prec.q(q[:, lo:hi]), kk[:, :hi]) * scale
        mask = (torch.arange(hi, device=q.device)[None, :]
                <= torch.arange(lo, hi, device=q.device)[:, None])
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out.append(torch.einsum("bhqk,bkhd->bqhd", prec.q(p), vv[:, :hi]))
    return torch.cat(out, dim=1)


def mla(x, p: dict, cfg: dict, positions, prec: R.Precision = R.FP32) -> torch.Tensor:
    """Latent attention, expanded.  x [B, S, D] (normalised)."""
    B, S, _ = x.shape
    m, H = cfg["mla"], cfg["num_heads"]
    dn, dr, dv, r = (m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"],
                     m["kv_lora_rank"])
    q = prec.mm(x, p["wq"]).view(B, S, H, dn + dr)
    kv = prec.mm(x, p["wkv_a"])
    c_kv = R.rms_norm(kv[..., :r], p["kv_norm"], cfg["norm_eps"])
    k_pe = rope(kv[..., None, r:], positions, cfg)
    kv_b = prec.mm(c_kv, p["wkv_b"]).view(B, S, H, dn + dv)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], positions, cfg)], dim=-1)
    k = torch.cat([kv_b[..., :dn], k_pe.expand(B, S, H, dr)], dim=-1)
    o = attention(q, k, kv_b[..., dn:], softmax_scale(cfg), prec)
    return prec.mm(o.reshape(B, S, H * dv), p["wo"])


def moe(x: torch.Tensor, p: dict, mcfg: dict, act_name: str = "silu",
        prec: R.Precision = R.FP32) -> torch.Tensor:
    """Top-k routing over a softmax of the router's logits, the k weights
    renormalised only where ``norm_topk_prob`` (DeepSeek-V2-Lite: false),
    the capacity rule (an assignment whose place among its expert's,
    counted token by token, reaches ``int(capacity_factor * k * T / E)`` is
    dropped), then the shared experts.  x [T, D] -> [T, D]."""
    T = x.shape[0]
    E, k = mcfg["num_experts"], mcfg["top_k"]
    probs = torch.softmax(prec.mm(x, p["router"]), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    if k > 1 and mcfg.get("norm_topk_prob", True):
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = max(int(mcfg["capacity_factor"] * k * T / E), 1)
    flat = idx.reshape(-1)
    place = torch.cumsum(F.one_hot(flat, E), dim=0).gather(1, flat[:, None])[:, 0] - 1
    keep = place < cap
    fn = R.act(act_name)
    y = torch.zeros_like(x)
    weights = w.reshape(-1)
    for e in range(E):
        a = torch.nonzero((flat == e) & keep)[:, 0]
        if a.numel() == 0:
            continue
        tok = a // k
        xe = x[tok]
        h = fn(prec.mm(xe, p["w1"][e])) * prec.mm(xe, p["w3"][e])
        y = y.index_add(0, tok, prec.mm(h, p["w2"][e]) * weights[a, None])
    if mcfg.get("num_shared_experts", 0) > 0:
        y = y + prec.mm(fn(prec.mm(x, p["shared_w1"])) * prec.mm(x, p["shared_w3"]),
                        p["shared_w2"])
    return y


def _layer(x, w: dict, cfg: dict, i: int, prec: R.Precision):
    """One layer over one sequence.  x [1, S, D]."""
    pos = torch.arange(x.shape[1], device=x.device)
    x = x + mla(R.rms_norm(x, w["ln1"], cfg["norm_eps"]), w["attn"], cfg, pos, prec)
    h = R.rms_norm(x, w["ln2"], cfg["norm_eps"])
    if i < cfg["moe"]["first_moe_layer"]:
        return x + R.gated_mlp(h, w["mlp"], cfg["act"], prec)
    return x + moe(h[0], w["moe"], cfg["moe"], cfg["act"], prec)[None]


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


# --------------------------------------------------------------------------- FLOPs and bytes
def _widths(cfg: dict):
    m = cfg["mla"]
    return (cfg["d_model"], cfg["num_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"],
            m["v_head_dim"], m["kv_lora_rank"])


def _q_flops(cfg: dict) -> float:
    D, H, dn, dr, _, _ = _widths(cfg)
    return 2 * D * H * (dn + dr)


def _mlp_flops(cfg: dict, layer: int) -> float:
    D, m = cfg["d_model"], cfg["moe"]
    if layer < m["first_moe_layer"]:
        return 6 * D * (m["d_ff_dense"] or cfg["d_ff"])
    experts = m["top_k"] + m.get("num_shared_experts", 0)
    return 2 * D * m["num_experts"] + 6 * D * m["d_ff_expert"] * experts


def matmul_flops_per_token(cfg: dict, layer: int, absorbed: bool = False) -> float:
    """Multiply-adds x 2 of one token through ``layer``'s products, the
    attention's own products left out: q, Wkv_a and Wo, then Wkv_b over
    the token's latent (expanded: prefill) or the absorption of W_UK into q
    and W_UV out of the latent output (absorbed: decode); the router and
    the k routed and the shared experts, or the dense MLP."""
    D, H, dn, dr, dv, r = _widths(cfg)
    attn = _q_flops(cfg) + 2 * D * (r + dr) + 2 * H * dv * D
    attn += 2 * H * r * (dn + dv) if absorbed else 2 * r * H * (dn + dv)
    return attn + _mlp_flops(cfg, layer)


def prefill_flops(cfg: dict, n: int) -> float:
    """The prefill of an n-token prompt, as the program computes it: the
    expanded form, QK over the visible pairs at nope + rope dims and PV at
    v dims, one row of logits."""
    D, H, dn, dr, dv, _ = _widths(cfg)
    L = cfg["num_layers"]
    per_token = sum(matmul_flops_per_token(cfg, i) for i in range(L))
    attn = 2 * H * (dn + dr + dv) * R.visible_pairs(0, n) * L
    return n * per_token + attn + 2 * D * cfg["vocab_size"]


def decode_flops(cfg: dict, position: int) -> float:
    """One decode step of one sequence at 0-based ``position``, as the
    program computes it: the absorbed form, the scores of the latent and
    the roped key and P.C over the position + 1 live slots."""
    D, H, _, dr, _, r = _widths(cfg)
    L = cfg["num_layers"]
    per_token = sum(matmul_flops_per_token(cfg, i, absorbed=True) for i in range(L))
    return per_token + 2 * H * (2 * r + dr) * (position + 1) * L + 2 * D * cfg["vocab_size"]


def mla_decode_call(cfg: dict, rows: int, live_slots: float):
    """(FLOPs, bytes) of one layer's latent decode over ``rows`` rows that
    hold ``live_slots`` live slots in all: scores and P.C of every head on
    every live slot; each live slot's latent and roped key read once, the
    rows' absorbed queries read and latent outputs written once, in the
    model's type."""
    _, H, _, dr, _, r = _widths(cfg)
    esize = 2 if cfg["dtype"] == "bfloat16" else 4
    flops = 2 * H * (2 * r + dr) * live_slots
    nbytes = esize * (live_slots * (r + dr) + rows * H * (r + dr) + rows * H * r)
    return flops, nbytes
