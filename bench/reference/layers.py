"""Plain float32 layers for the references: one sequence or batch through
the model's equations, with no kernel, cache or batching of requests, and
nothing of the program.  ``Precision("fp8")`` quantises every matrix
product's inputs to float8 e4m3 (one scale a tensor): the control that the
comparison must reject.  ``exact()`` turns TF32 off while a reference runs.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


class Precision:
    """How a matrix product's inputs are taken: "fp32" as they are, "fp8"
    rounded to float8 e4m3 after scaling each tensor's largest magnitude
    to 448 (the format's largest)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision must be 'fp32' or 'fp8', got {name!r}")
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` rounded; its gradient passes through as it is (the
        backward of a product then runs on the rounded operands)."""
        if self.name == "fp32":
            return t
        d = t.detach()
        s = d.abs().amax().clamp_min(1e-30) / 448.0
        return t + ((d / s).to(torch.float8_e4m3fn).to(torch.float32) * s - d)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


FP32 = Precision("fp32")


@contextlib.contextmanager
def exact():
    """Float32 products in float32, not TF32."""
    mm, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, cudnn


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) times the gain ``1 + w``."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, halves rotated as pairs.  x [..., S, H, hd];
    positions [S]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = positions.to(torch.float64)[:, None] * freqs  # [S, half]
    c = torch.cos(ang).to(x.dtype)[:, None, :]
    s = torch.sin(ang).to(x.dtype)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q, k, v, *, window: int = 0, n_meta: int = 0, prec: Precision = FP32,
              block: int = 1024) -> torch.Tensor:
    """Causal softmax attention.  q [B, S, H, hd]; k, v [B, S, KV, hd]; query
    head h reads KV head h // (H / KV).  With ``window`` a query sees the
    ``window`` latest keys and the first ``n_meta`` always.  Query rows in
    blocks of ``block``."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kk = prec.q(k.repeat_interleave(G, dim=2))
    vv = prec.q(v.repeat_interleave(G, dim=2))
    kp = torch.arange(S, device=q.device)[None, :]
    out = []
    for lo in range(0, S, block):
        qb = prec.q(q[:, lo:lo + block])
        s = torch.einsum("bqhd,bkhd->bhqk", qb, kk) / math.sqrt(hd)
        qp = torch.arange(lo, lo + qb.shape[1], device=q.device)[:, None]
        mask = kp <= qp
        if window > 0:
            mask = mask & (((qp - kp) < window) | (kp < n_meta))
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out.append(torch.einsum("bhqk,bkhd->bqhd", prec.q(p), vv))
    return torch.cat(out, dim=1)


def attn_block(x, p: dict, cfg: dict, positions, *, window: int = 0, n_meta: int = 0,
               prec: Precision = FP32) -> torch.Tensor:
    """Projections, rotary embedding, attention and the output projection.
    x [B, S, D] (already normalised)."""
    B, S, _ = x.shape
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = prec.mm(x, p["wq"]).view(B, S, H, hd)
    k = prec.mm(x, p["wk"]).view(B, S, KV, hd)
    v = prec.mm(x, p["wv"]).view(B, S, KV, hd)
    q, k = rope(q, positions, cfg["rope_theta"]), rope(k, positions, cfg["rope_theta"])
    o = attention(q, k, v, window=window, n_meta=n_meta, prec=prec)
    return prec.mm(o.reshape(B, S, H * hd), p["wo"])


def act(name: str):
    return F.silu if name == "silu" else (lambda t: F.gelu(t, approximate="tanh"))


def gated_mlp(x, p: dict, act_name: str = "silu", prec: Precision = FP32) -> torch.Tensor:
    return prec.mm(act(act_name)(prec.mm(x, p["w1"])) * prec.mm(x, p["w3"]), p["w2"])


def moe(x: torch.Tensor, p: dict, mcfg: dict, act_name: str = "silu",
        prec: Precision = FP32) -> torch.Tensor:
    """Top-k routing over a softmax of the router's logits, the k weights
    renormalised, and the capacity rule: an assignment whose place among its
    expert's assignments, counted token by token, reaches
    ``int(capacity_factor * k * T / E)`` (at least 1) is dropped; then the
    shared experts.  x [T, D] -> [T, D]."""
    T = x.shape[0]
    E, k = mcfg["num_experts"], mcfg["top_k"]
    probs = torch.softmax(prec.mm(x, p["router"]), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    if k > 1:
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = max(int(mcfg["capacity_factor"] * k * T / E), 1)
    flat = idx.reshape(-1)
    place = torch.cumsum(F.one_hot(flat, E), dim=0).gather(1, flat[:, None])[:, 0] - 1
    keep = place < cap
    fn = act(act_name)
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


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution along S.  x [B, S, C]; w [K, C]."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, j:j + S] * w[j] for j in range(K)) + b


def ssd(x, a, b, c, chunk: int = 128, prec: Precision = FP32):
    """The state-space recurrence h_t = exp(a_t) h_{t-1} + x_t b_t^T,
    y_t = h_t c_t, computed exactly a chunk at a time (within a chunk as a
    masked product, across chunks through the carried state).
    x [B, S, H, P]; a [B, S, H]; b, c [B, S, G, N] -> (y [B, S, H, P],
    final state [B, H, P, N])."""
    Bsz, S, H, P = x.shape
    rep = H // b.shape[2]
    b, c = prec.q(b.repeat_interleave(rep, dim=2)), prec.q(c.repeat_interleave(rep, dim=2))
    x = prec.q(x)
    state = x.new_zeros((Bsz, H, P, b.shape[-1]))
    ys = []
    for lo in range(0, S, chunk):
        xs, as_, bs, cs = (t[:, lo:lo + chunk] for t in (x, a, b, c))
        L = xs.shape[1]
        cum = torch.cumsum(as_, dim=1)  # [B, L, H]
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # [B, i, j, H]
        tril = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))[None, :, :, None]
        decay = torch.exp(diff.masked_fill(~tril, float("-inf")))
        scores = torch.einsum("bihn,bjhn->bijh", cs, bs) * decay
        y = torch.einsum("bijh,bjhp->bihp", scores, xs)
        y = y + torch.einsum("bihn,bhpn->bihp", cs, state) * torch.exp(cum)[..., None]
        to_end = torch.exp(cum[:, -1:] - cum)  # [B, L, H]
        state = (state * torch.exp(cum[:, -1])[:, :, None, None]
                 + torch.einsum("bjhp,bjhn->bhpn", xs * to_end[..., None], bs))
        ys.append(y)
    return torch.cat(ys, dim=1), state


def mamba2(x, p: dict, scfg: dict, d_model: int, prec: Precision = FP32) -> torch.Tensor:
    """The Mamba-2 mixer: input projection to (z, x, B, C, dt), causal
    convolution and SiLU over (x, B, C), the SSD recurrence with
    A = -exp(A_log) and dt = softplus(dt + dt_bias), the skip D x, the gated
    RMS norm and the output projection.  x [B, S, D] (normalised)."""
    Bsz, S, _ = x.shape
    di = scfg["expand"] * d_model
    H, P = di // scfg["head_dim"], scfg["head_dim"]
    G, N = scfg["n_groups"], scfg["d_state"]
    z, xs, bc, dt = torch.split(prec.mm(x, p["in_proj"]), [di, di, 2 * G * N, H], dim=-1)
    conv = F.silu(causal_conv(torch.cat([xs, bc], dim=-1), p["conv_w"], p["conv_b"]))
    xs, b, c = torch.split(conv, [di, G * N, G * N], dim=-1)
    dt = torch.logaddexp(dt + p["dt_bias"], torch.zeros_like(dt))  # softplus
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(Bsz, S, H, P)
    y, _ = ssd(xh * dt[..., None], A * dt, b.reshape(Bsz, S, G, N), c.reshape(Bsz, S, G, N),
               prec=prec)
    y = (y + p["D"][:, None] * xh).reshape(Bsz, S, di)
    return prec.mm(rms_norm(y * F.silu(z), p["out_norm"], 1e-6), p["out_proj"])


def visible_pairs(s0: int, s1: int, window: int = 0, n_meta: int = 0) -> int:
    """(query, key) pairs a causal attention computes for the queries at
    positions s0 .. s1 - 1 over keys from 0: all earlier keys, or within a
    ``window`` the latest ``window`` plus the first ``n_meta``."""
    total = 0
    # without a window: sum of (q + 1)
    if window <= 0:
        return (s1 * (s1 + 1) - s0 * (s0 + 1)) // 2
    for qpos in range(s0, s1):
        near = min(qpos + 1, window)
        total += near + max(0, min(n_meta, qpos + 1 - near))
    return total
