"""hymba-1.5b (arXiv:2411.13676) in plain float32 PyTorch: its forward
pass, a training step's loss and gradients with AdamW, and the
benchmark's FLOP counts for it.

``num_meta_tokens`` learned tokens go in front of every sequence.  Each
layer normalises its input and runs attention heads (rotary embeddings,
grouped KV heads; a window of ``window_size`` keys plus the meta tokens
except in the global layers) and Mamba-2 heads on it side by side; each
output is RMS-normalised, the two are averaged and added; then a gated MLP.
The loss is the mean next-token cross-entropy of the tokens after the meta
prefix, the last position having no target.  Departures from the
published model, as the configuration is run: norm gains ``1 + w``; the
two heads' outputs averaged after their own norms.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint as ckpt

from bench.reference import layers as R


def layer_types(cfg: dict) -> List[str]:
    glob = set(cfg["hybrid"]["global_layers"])
    return ["global" if i in glob else "local" for i in range(cfg["num_layers"])]


def _layer(x, w: dict, cfg: dict, local: bool, prec: R.Precision):
    """One hybrid layer.  x [B, S, D] with the meta prefix."""
    eps, n_meta = cfg["norm_eps"], cfg["hybrid"]["num_meta_tokens"]
    pos = torch.arange(x.shape[1], device=x.device)
    xn = R.rms_norm(x, w["ln1"], eps)
    att = R.attn_block(xn, w["attn"], cfg, pos, window=cfg["window_size"] if local else 0,
                       n_meta=n_meta, prec=prec)
    ssm = R.mamba2(xn, w["mixer"], cfg["hybrid"]["ssm"], cfg["d_model"], prec)
    x = x + 0.5 * (R.rms_norm(att, w["attn_out_norm"], eps)
                   + R.rms_norm(ssm, w["ssm_out_norm"], eps))
    return x + R.gated_mlp(R.rms_norm(x, w["ln2"], eps), w["mlp"], cfg["act"], prec)


def _embed(tokens: torch.Tensor, embed, meta) -> torch.Tensor:
    x = embed[tokens.long()]
    return torch.cat([meta[None].expand(x.shape[0], -1, -1), x], dim=1)


def logits(cfg: dict, W, seqs: List[torch.Tensor], starts: List[int],
           prec: R.Precision = R.FP32) -> List[torch.Tensor]:
    """Each sequence's full forward pass, layer by layer over all of them;
    the float32 logits [len(seq) - start, V] at token positions start ..
    end - 1 of each (the meta prefix not counted)."""
    n_meta = cfg["hybrid"]["num_meta_tokens"]
    kinds = layer_types(cfg)
    with R.exact(), torch.no_grad():
        embed, meta = W.top("embed"), W.top("meta_tokens")
        xs = [_embed(s[None], embed, meta) for s in seqs]
        del embed
        for i in range(W.n_layers):
            w = W.layer(i)
            xs = [_layer(x, w, cfg, kinds[i] == "local", prec) for x in xs]
            del w
        norm, unembed = W.top("final_norm"), W.top("unembed")
        return [prec.mm(R.rms_norm(x[0, n_meta + st:], norm, cfg["norm_eps"]), unembed)
                for x, st in zip(xs, starts)]


# --------------------------------------------------------------------------- training
Leaves = Dict[Tuple[str, Optional[int]], torch.Tensor]


def _nest(leaves: Leaves, layer: int) -> dict:
    out: dict = {}
    for (path, i), t in leaves.items():
        if i != layer:
            continue
        node = out
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return out


def loss(cfg: dict, P: Leaves, tokens: torch.Tensor, prec: R.Precision = R.FP32):
    """Mean next-token cross-entropy of ``tokens`` [B, S]; each layer
    checkpointed, so the backward holds one layer's activations at a time."""
    n_meta, kinds = cfg["hybrid"]["num_meta_tokens"], layer_types(cfg)
    x = _embed(tokens, P[("embed", None)], P[("meta_tokens", None)])
    for i in range(cfg["num_layers"]):
        x = ckpt.checkpoint(_layer, x, _nest(P, i), cfg, kinds[i] == "local", prec,
                            use_reentrant=False)
    x = R.rms_norm(x[:, n_meta:], P[("final_norm", None)], cfg["norm_eps"])
    lg = prec.mm(x[:, :-1], P[("unembed", None)])
    return torch.nn.functional.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                             tokens[:, 1:].reshape(-1).long())


def train(cfg: dict, W, batches: List[torch.Tensor], opt: dict,
          prec: R.Precision = R.FP32) -> dict:
    """``len(batches)`` AdamW steps from the seed's weights, each on its
    batch, the gradients clipped to a global norm of ``opt["clip_norm"]``.
    Returns each step's loss, the first step's clipped gradient per leaf,
    and the change of each leaf over all the steps."""
    with R.exact():
        P = {k: v.requires_grad_(True) for k, v in W.leaves().items()}
        m = {k: torch.zeros_like(v) for k, v in P.items()}
        v2 = {k: torch.zeros_like(v) for k, v in P.items()}
        p0 = {k: v.detach().clone() for k, v in P.items()}
        b1, b2, eps, wd, lr = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"], opt["lr"]
        losses, first_grad = [], None
        for step, tokens in enumerate(batches, start=1):
            with torch.enable_grad():
                value = loss(cfg, P, tokens, prec)
                grads = torch.autograd.grad(value, list(P.values()))
            losses.append(float(value.detach()))
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.clamp(opt["clip_norm"] / torch.clamp(norm, min=1e-9), max=1.0)
            grads = [g * scale for g in grads]
            if first_grad is None:
                first_grad = {k: g.norm().item() for k, g in zip(P, grads)}
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            with torch.no_grad():
                for (k, p), g in zip(P.items(), grads):
                    m[k].mul_(b1).add_((1 - b1) * g)
                    v2[k].mul_(b2).add_((1 - b2) * g * g)
                    delta = (m[k] / c1) / (torch.sqrt(v2[k] / c2) + eps) + wd * p
                    p.sub_(lr * delta)
            del grads
        change = {k: (p.detach() - p0[k]).norm().item() for k, p in P.items()}
    return {"losses": losses, "grad_norms": first_grad, "change_norms": change}


# --------------------------------------------------------------------------- FLOPs
def matmul_flops_per_token(cfg: dict) -> float:
    """Multiply-adds x 2 of one token through one layer's products: the
    attention's projections, the SSM's input and output projections, its
    convolution and recurrence (the state update and readout, linear
    form), and the MLP."""
    D, H, KV, hd = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    s = cfg["hybrid"]["ssm"]
    di = s["expand"] * D
    Hs, P, G, N = di // s["head_dim"], s["head_dim"], s["n_groups"], s["d_state"]
    attn = 2 * D * (H + 2 * KV) * hd + 2 * H * hd * D
    ssm = (2 * D * (2 * di + 2 * G * N + Hs) + 2 * di * D + 2 * s["d_conv"] * (di + 2 * G * N)
           + 4 * Hs * P * N)
    return attn + ssm + 6 * D * cfg["d_ff"]


def forward_flops(cfg: dict, batch: int, seq: int, logit_rows: int) -> float:
    """A forward pass of ``batch`` sequences of ``seq`` tokens (the meta
    prefix added), the attention over each layer's visible pairs, and
    ``logit_rows`` rows of logits."""
    n_meta, W = cfg["hybrid"]["num_meta_tokens"], cfg["window_size"]
    total = seq + n_meta
    pairs = sum(R.visible_pairs(0, total, W if kind == "local" else 0, n_meta)
                for kind in layer_types(cfg))
    per_seq = (total * cfg["num_layers"] * matmul_flops_per_token(cfg)
               + 4 * cfg["num_heads"] * cfg["head_dim"] * pairs)
    return batch * per_seq + 2 * cfg["d_model"] * cfg["vocab_size"] * logit_rows


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """3 x the forward (the backward counted twice the forward; the
    recomputation of checkpointed layers not counted)."""
    return 3 * forward_flops(cfg, batch, seq, batch * seq)
