"""Decoder-stack model assembly: the dense family (llama-style: tinyllama,
deepseek-67b), the JAX package's ``repro.models.decoder`` in PyTorch.

``build_segments`` is the reference's for every family.  A dense config is
one "scan" segment: homogeneous layers with stacked [L, ...] parameters,
walked here by a Python loop.  The other families (gemma3's local windows,
MoE, SSM, hybrid, VLM) raise ``NotImplementedError`` when the model is
built; ROADMAP.md's queue 1 lists them.

Entry points keep the reference's signatures and trees: ``init(gen)``,
``prefill(params, batch, max_cache_len)``, ``init_cache(bsz, max_cache_len)``
and ``decode_step(params, cache, tokens)``, with the cache
``{"segments": [{"k": [L, B, S, KV, hd], "v": ...}], "lengths": [B]}``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class SegmentDef:
    kind: str  # "scan" | "unroll"
    unit: str  # "dense" | "moe" | "ssm" | "hybrid" | "gemma_period" | "moe_period"
    n: int  # units (layers, or periods for gemma_period)
    layer_types: Tuple[str, ...]  # per unit; for gemma_period: per-slot inside period
    d_ff: Optional[int] = None  # override (deepseek-moe leading dense layer)


def build_segments(cfg: ModelConfig) -> List[SegmentDef]:
    lt = cfg.layer_types()
    if cfg.family == "ssm":
        return [SegmentDef("scan", "ssm", cfg.num_layers, ("global",) * cfg.num_layers)]
    if cfg.family == "hybrid":
        # runs of one layer type: long local runs scan, the globals unroll
        segs: List[SegmentDef] = []
        i = 0
        while i < len(lt):
            j = i
            while j < len(lt) and lt[j] == lt[i]:
                j += 1
            kind = "scan" if (j - i) >= 3 else "unroll"
            segs.append(SegmentDef(kind, "hybrid", j - i, lt[i:j]))
            i = j
        return segs
    if cfg.family == "moe":
        if cfg.moe.moe_every == 2:
            # llama4-style interleave: scan over (dense, moe) periods
            if cfg.num_layers % 2 or cfg.moe.first_moe_layer != 1:
                raise ValueError(f"{cfg.name}: a (dense, moe) interleave needs an even depth "
                                 f"and first_moe_layer == 1")
            return [SegmentDef("scan", "moe_period", cfg.num_layers // 2, ("global", "global"))]
        segs = []
        lead = cfg.moe.first_moe_layer
        if lead > 0:
            segs.append(SegmentDef("unroll", "dense", lead, lt[:lead],
                                   d_ff=cfg.moe.d_ff_dense or cfg.d_ff))
        segs.append(SegmentDef("scan", "moe", cfg.num_layers - lead, lt[lead:]))
        return segs
    if cfg.attn_pattern == "gemma3":
        period = cfg.local_per_period + 1
        n_periods = cfg.num_layers // period
        trail = cfg.num_layers - n_periods * period
        segs = []
        if n_periods > 0:
            segs.append(SegmentDef("scan", "gemma_period", n_periods,
                                   ("local",) * cfg.local_per_period + ("global",)))
        if trail:
            segs.append(SegmentDef("unroll", "dense", trail, lt[-trail:]))
        return segs
    # dense / vlm
    return [SegmentDef("scan", "dense", cfg.num_layers, lt)]


def _check_dense(cfg: ModelConfig) -> None:
    """Raise for what only the families not ported yet use."""
    if cfg.family != "dense":
        raise B.not_ported(f"the {cfg.family} family ({cfg.name})")
    if (cfg.attn_pattern != "global" or cfg.qk_norm or cfg.tie_embeddings
            or cfg.rope_theta_global):
        raise B.not_ported(f"gemma3's local windows, qk-norm, tied embeddings and global "
                           f"rope theta ({cfg.name})")


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked [L, ...] parameter or cache dict (views)."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i]) for k, v in tree.items()}


def _stack(trees: List[dict]) -> dict:
    return {k: (_stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                else torch.stack([t[k] for t in trees])) for k in trees[0]}


# --------------------------------------------------------------------------- model
class DecoderModel:
    """``device`` is where the parameters and caches live: None means CUDA
    (raising where no card is present), ``"cpu"`` the CPU.  ``remat``,
    ``moe_dispatch`` and ``remat_group`` are the reference's training and
    MoE knobs, kept for its signature; they change nothing here."""

    def __init__(self, cfg: ModelConfig, mesh=None, moe_dispatch: str = "dense",
                 remat: bool = True, attn_impl: str = "chunked", tp_comm: str = "auto",
                 remat_group: int = 1, device=None):
        if mesh is not None:
            raise B.not_ported("a mesh (distributed/)")
        _check_dense(cfg)
        if attn_impl not in ("chunked", "flash"):
            raise ValueError(f"attn_impl must be 'chunked' or 'flash', got {attn_impl!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.moe_dispatch = moe_dispatch
        self.remat = remat
        self.attn_impl = attn_impl
        self.tp_comm = tp_comm
        self.remat_group = remat_group
        self.segments = build_segments(cfg)  # one dense scan segment
        self.dtype = getattr(torch, cfg.dtype)
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator) -> dict:
        """Random parameters drawn from ``gen`` (on the generator's device),
        placed on the model's device."""
        cfg, dtype = self.cfg, self.dtype
        params: Dict[str, Any] = {
            "embed": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                                  device=gen.device) * 0.02).to(dtype),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device),
            "segments": [B.init_dense_layer(gen, cfg, dtype, n=self.segments[0].n)],
            "unembed": (torch.randn((cfg.d_model, cfg.vocab_size), generator=gen,
                                    device=gen.device) * 0.02).to(dtype),
        }
        return _to(params, self.device)

    # ------------------------------------------------------------------ ctx
    def _make_ctx(self, positions, max_cache_len: int = 0, lengths=None) -> B.Ctx:
        cos, sin = L.rope_cos_sin(positions, self.cfg.head_dim, self.cfg.rope_theta)
        return B.Ctx(cfg=self.cfg, mesh=self.mesh, cos_local=cos, sin_local=sin,
                     lengths=lengths, moe_dispatch=self.moe_dispatch,
                     max_cache_len=max_cache_len, window=self.cfg.window_size,
                     remat=self.remat, attn_impl=self.attn_impl, tp_comm=self.tp_comm)

    def _embed(self, params, tokens) -> torch.Tensor:
        return params["embed"][tokens.long()].to(self.dtype)

    # ------------------------------------------------------------------ stack walk
    def _run_stack(self, params, x, ctx: B.Ctx, mode: str, cache=None):
        """Returns (x, aux_total, new_cache).  Prefill stacks the layers'
        caches into [L, ...]; decode updates each layer's view of the
        stacked cache in place."""
        seg = self.segments[0]
        p_seg = params["segments"][0]
        c_seg = cache["segments"][0] if cache is not None else None
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = []
        for li in range(seg.n):
            c_l = None if c_seg is None else _layer(c_seg, li)
            x, a, nc = B.apply_dense(x, _layer(p_seg, li), ctx, seg.layer_types[li], mode, c_l)
            aux_total = aux_total + a
            caches.append(nc)
        x = L.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return x, aux_total, {"segments": [_stack(caches) if mode == "prefill" else c_seg]}

    def loss(self, params, batch):
        raise B.not_ported("the training loss (the training slice)")

    # ------------------------------------------------------------------ prefill / decode
    def prefill(self, params, batch, max_cache_len: int):
        """batch {"tokens": [B, S] int} -> (cache, last_logits [B, V] f32, lengths [B])."""
        tokens = batch["tokens"]
        bsz, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(bsz, S)
        ctx = self._make_ctx(positions, max_cache_len=max_cache_len)
        x, _, cache = self._run_stack(params, self._embed(params, tokens), ctx, "prefill")
        last_logits = L.unembed(x[:, -1], params["unembed"], False)
        lengths = torch.full((bsz,), S, dtype=torch.int32, device=tokens.device)
        cache["lengths"] = lengths
        return cache, last_logits, lengths

    def init_cache(self, bsz: int, max_cache_len: int) -> dict:
        ctx = B.Ctx(cfg=self.cfg, window=self.cfg.window_size, max_cache_len=max_cache_len)
        seg = self.segments[0]
        c = B.init_block_cache(self.cfg, bsz, seg.layer_types[0], ctx, self.dtype, self.device)
        return {"segments": [{k: torch.stack([a] * seg.n) for k, a in c.items()}],
                "lengths": torch.zeros((bsz,), dtype=torch.int32, device=self.device)}

    def decode_step(self, params, cache, tokens, batch=None):
        """tokens [B, 1]; cache from prefill / init_cache, updated in place.
        Returns (logits [B, V] f32, cache with lengths + 1)."""
        lengths = cache["lengths"]
        ctx = self._make_ctx(lengths[:, None], lengths=lengths)
        x, _, new_cache = self._run_stack(params, self._embed(params, tokens), ctx, "decode",
                                          cache)
        logits = L.unembed(x[:, 0], params["unembed"], False)
        new_cache["lengths"] = lengths + 1
        return logits, new_cache


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)
