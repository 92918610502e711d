"""Mamba-2 / SSD (state-space duality) mixer: the chunked form for training
and prefill, and the O(1)-state decode recurrence (the JAX package's
``repro.models.ssm`` in PyTorch; arXiv:2405.21060).

The SSM state is f32 in every model dtype, and the causal convolution runs
in f32 and is cast back, at the reference's points.  Each 3- and 4-operand
einsum of the reference is written here as explicit pairwise products, so
the CPU and the card contract in the same order (``torch.einsum`` leaves
the order to opt_einsum where it is installed, and to itself where not).
The reference's inter-chunk ``lax.scan`` is a Python loop over chunks.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models.layers import rms_norm


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., T] -> [..., T, T]; out[i, j] = sum_{k=j+1..i} x[k] (i >= j), else -inf."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, torch.tensor(-torch.inf, dtype=out.dtype, device=x.device))


def ssd_chunked(x: torch.Tensor, a_bar: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                chunk: int, initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, H, P] (already times dt), a_bar [B, S, H] (A * dt, negative),
    b, c [B, S, G, N] -> (y [B, S, H, P] f32, final state [B, H, P, N] f32)."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if S % chunk:
        raise ValueError(f"chunk {chunk} does not divide the sequence length {S}")
    nc = S // chunk
    hpg = H // G  # heads per group

    xc = x.reshape(B, nc, chunk, H, P).float()
    ac = a_bar.reshape(B, nc, chunk, H).permute(0, 3, 1, 2).float()  # [B, H, nc, c]
    bh = b.reshape(B, nc, chunk, G, N).float().repeat_interleave(hpg, dim=3)  # [B, nc, c, H, N]
    ch = c.reshape(B, nc, chunk, G, N).float().repeat_interleave(hpg, dim=3)

    a_cum = torch.cumsum(ac, dim=-1)  # [B, H, nc, c]
    L = torch.exp(segsum(ac))  # [B, H, nc, l, s]

    # intra-chunk (the quadratic, attention-like term):
    # "bclhn,bcshn,bhcls,bcshp->bclhp" as (C B^T) * L, then times x
    scores = torch.einsum("bclhn,bcshn->bchls", ch, bh) * L.permute(0, 2, 1, 3, 4)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xc)

    # each chunk's end state: "bcshn,bhcs,bcshp->bchpn" as (x * decay) B^T
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # [B, H, nc, c]
    xd = xc * decay_states.permute(0, 2, 3, 1)[..., None]
    states = torch.einsum("bcshp,bcshn->bchpn", xd, bh)  # [B, nc, H, P, N]

    # inter-chunk recurrence
    chunk_decay = torch.exp(a_cum[..., -1])  # [B, H, nc]
    state = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for i in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, :, i, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)  # [B, nc, H, P, N]

    # the incoming state's share: "bclhn,bchpn,bhcl->bclhp" as C state, then times decay
    state_decay_out = torch.exp(a_cum)  # [B, H, nc, c]
    y_off = (torch.einsum("bclhn,bchpn->bclhp", ch, prev_states)
             * state_decay_out.permute(0, 2, 3, 1)[..., None])
    return (y_diag + y_off).reshape(B, S, H, P), state


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x [B, S, C]; w [K, C]; a causal depthwise convolution along S, in f32,
    cast back to x's type."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(K):
        out = out + xp[:, k:k + S].float() * w[k].float()
    return (out + bias.float()).to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """JAX's softplus, logaddexp(x, 0) (no threshold, unlike F.softplus)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _split(zxbcdt: torch.Tensor, di: int, gn2: int):
    """The input projection's z, x, (B, C) and dt parts."""
    return torch.split(zxbcdt, [di, di, gn2, zxbcdt.shape[-1] - 2 * di - gn2], dim=-1)


def mamba2_mixer(x: torch.Tensor, p: dict, cfg: SSMConfig, d_model: int) -> torch.Tensor:
    """The Mamba-2 mixer for training and prefill (no cache)."""
    return mamba2_mixer_with_state(x, p, cfg, d_model)[0]


def mamba2_mixer_with_state(x: torch.Tensor, p: dict, cfg: SSMConfig, d_model: int):
    """x [B, S, D] -> (y [B, S, D], final SSM state [B, H, P, N] f32, conv
    state [B, d_conv - 1, d_inner + 2 G N] in x's type)."""
    B, S, _ = x.shape
    di, H = cfg.d_inner(d_model), cfg.n_heads(d_model)
    G, N, P = cfg.n_groups, cfg.d_state, cfg.head_dim

    z, xs, bc, dt = _split(x @ p["in_proj"], di, 2 * G * N)
    conv_in = torch.cat([xs, bc], dim=-1)  # [B, S, di + 2GN]
    conv_out = F.silu(_causal_depthwise_conv(conv_in, p["conv_w"], p["conv_b"]))
    xs, b, c = torch.split(conv_out, [di, G * N, G * N], dim=-1)

    dt = _softplus(dt.float() + p["dt_bias"].float())  # [B, S, H]
    A = -torch.exp(p["A_log"].float())  # [H]
    xh = xs.reshape(B, S, H, P)
    chunk = min(cfg.chunk_size, S)
    while S % chunk:
        chunk //= 2
    y, final_state = ssd_chunked(xh.float() * dt[..., None], A[None, None, :] * dt,
                                 b.reshape(B, S, G, N), c.reshape(B, S, G, N), chunk)
    y = y + p["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, S, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["out_norm"], 1e-6)
    K1 = cfg.d_conv - 1
    conv_state = conv_in[:, S - K1:] if S >= K1 else F.pad(conv_in, (0, 0, K1 - S, 0))
    return y @ p["out_proj"], final_state, conv_state


def mamba2_decode_step(x: torch.Tensor, state: torch.Tensor, conv_state: torch.Tensor,
                       p: dict, cfg: SSMConfig, d_model: int):
    """One token's recurrent update.  x [B, D], state [B, H, P, N],
    conv_state [B, d_conv - 1, d_inner + 2 G N] -> (y [B, D], state f32,
    conv_state)."""
    B = x.shape[0]
    di, H = cfg.d_inner(d_model), cfg.n_heads(d_model)
    G, N, P = cfg.n_groups, cfg.d_state, cfg.head_dim

    z, xs, bc, dt = _split(x @ p["in_proj"], di, 2 * G * N)
    conv_in = torch.cat([xs, bc], dim=-1)  # [B, di + 2GN]
    window = torch.cat([conv_state, conv_in[:, None].to(conv_state.dtype)], dim=1)  # [B, K, C]
    w = p["conv_w"].float()  # [K, C]
    conv_out = F.silu((window.float() * w[None]).sum(dim=1) + p["conv_b"].float()).to(x.dtype)
    xs, b, c = torch.split(conv_out, [di, G * N, G * N], dim=-1)

    dt = _softplus(dt.float() + p["dt_bias"].float())  # [B, H]
    A = -torch.exp(p["A_log"].float())  # [H]
    xh = xs.reshape(B, H, P).float()
    bg = b.reshape(B, G, N).repeat_interleave(H // G, dim=1).float()  # [B, H, N]
    cg = c.reshape(B, G, N).repeat_interleave(H // G, dim=1).float()

    decay = torch.exp(A[None] * dt)  # [B, H]
    state = (state.float() * decay[..., None, None]
             + (dt[..., None] * xh)[..., None] * bg[:, :, None, :])
    y = (state * cg[:, :, None, :]).sum(-1) + p["D"].float()[None, :, None] * xh
    y = y.reshape(B, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["out_norm"], 1e-6)
    return y @ p["out_proj"], state, window[:, 1:]


# --------------------------------------------------------------------------- init
#: the reference's fixed leaves as float32 bit patterns, for the head counts
#: of the repo's SSM configs (mamba2-370m: 32, hymba-1.5b: 50, reduced(): 16):
#: dt_bias = log(expm1(linspace(1e-3, 1e-1, H))) and A_log = log(linspace(1,
#: 16, H)).  XLA's log and expm1 on the CPU are not correctly rounded, so no
#: PyTorch expression gives their bits; other head counts are computed in
#: float64 and rounded, a few ulps from XLA's.
_FIXED_BITS = {
    16: ("c0dd083cc09c0697c087eabec077314ec06557c1c0575174c04bc068c041e617c0394f3dc031b0c5"
         "c02ad70dc0249d09c01ee73ec019a0b9c014b925c0102388",
         "000000003f3172183f8c9f543fb172183fce02103fe558603ff9139640051592400c9f5440135d8e"
         "4019771e401f08b6402428224028e651402d50b240317218"),
    32: ("c0dd083cc0af1b87c09cf03bc09163d0c088e5e6c0822c9cc079358dc06fb231c0676412c06004be"
         "c0596366c0535ccfc04dd6bac048bd0cc044000ec03f9339c03b6c65c037833bc033d0d0c0304f4e"
         "c02cf9c3c029cbf7c026c244c023d97dc0210edec01e5ff9c01bcaa8c0194d02c016e553c0149213"
         "c01251e4c0102388",
         "000000003eca101e3f2d48723f6591283f89d6f43f9d5eae3fae4f923fbd44fb3fcaa9563fd6c8b9"
         "3fe1db753fec0c5e3ff57ccb3ffe47324003407740071dbe400ac2ab400e355340117ad9401497a2"
         "40178f76401a659b401d1cee401fb7f1402238dc4024a1a54026f40d402931a5402b5bd6402d73e4"
         "402f7af640317218"),
    50: ("c0dd083cc0b9a096c0a9348fc09e6328c0964d79c08fd79ec08a75a9c085d83bc081cdf2c07c6bf3"
         "c075f2bfc0700ef7c06aa7a6c065a99bc06105c4c05cb018c0589eccc054c9d2c0512a75c04dbb0d"
         "c04a76d0c047599fc0445fecc04186a0c03ecb07c03c2ac2c039a3b6c0373403c034d9fec0329429"
         "c030612ac02e3fccc02c2ef1c02a2d9cc0283ae1c02655ebc0247df7c022b24fc020f24dc01f3d5a"
         "c01d92e8c01bf273c01a5b81c018cda0c0174868c015cb76c014566ec012e8f8c01182c4c0102388",
         "000000003e88bc733ef48b983f26c7083f4cadd63f6dafa33f8575ad3f9293b23f9e795a3fa95bd9"
         "3fb363d83fbcb1223fc55d093fcd7c0a3fd51ef93fdc53d03fe3264e3fe9a0653fefca9d3ff5ac4d"
         "3ffb4bd4400057624002ed02400568f34007cd20400a1b40400c54db400e7b5240108fe4401293b2"
         "401487c140166d004018444a401a0e66401bcc0d401d7de6401f248d4020c0934022527e4023dac9"
         "402559e84026d04540283e464029a447402b02a0402c59a3402da99e402ef2d84030359640317218"),
}


def _f32_from_hex(words: str) -> np.ndarray:
    return np.array([int(words[i:i + 8], 16) for i in range(0, len(words), 8)],
                    np.uint32).view(np.float32)


def fixed_leaves(H: int) -> Tuple[np.ndarray, np.ndarray]:
    """(dt_bias, A_log) [H] float32 for H SSD heads."""
    if H in _FIXED_BITS:
        return tuple(_f32_from_hex(w) for w in _FIXED_BITS[H])
    return (np.log(np.expm1(np.linspace(1e-3, 1e-1, H))).astype(np.float32),
            np.log(np.linspace(1.0, 16.0, H)).astype(np.float32))


def init_mamba2_params(gen: torch.Generator, cfg: SSMConfig, d_model: int, dtype,
                       n: Optional[int] = None) -> dict:
    """The reference's leaves, scales and dtypes, the random ones drawn from
    ``gen``; ``n`` stacks that many layers."""
    di, H = cfg.d_inner(d_model), cfg.n_heads(d_model)
    G, N = cfg.n_groups, cfg.d_state
    dev = gen.device
    lead = () if n is None else (n,)
    proj_out = 2 * di + 2 * G * N + H

    def normal(shape, scale):
        return (torch.randn(lead + shape, generator=gen, device=dev) * scale).to(dtype)

    def fixed(a: np.ndarray):
        return torch.from_numpy(a).to(dev).expand(lead + a.shape).clone()

    dt_bias, a_log = fixed_leaves(H)
    return {
        "in_proj": normal((d_model, proj_out), d_model ** -0.5),
        "conv_w": normal((cfg.d_conv, di + 2 * G * N), 0.1),
        "conv_b": torch.zeros(lead + (di + 2 * G * N,), dtype=dtype, device=dev),
        "dt_bias": fixed(dt_bias),
        "A_log": fixed(a_log),
        "D": torch.ones(lead + (H,), dtype=torch.float32, device=dev),
        "out_norm": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "out_proj": normal((di, d_model), di ** -0.5),
    }
