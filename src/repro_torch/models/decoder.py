"""Decoder-stack model assembly: the dense family (llama-style: tinyllama,
deepseek-67b), gemma3 (periodic local:global attention, qk-norm, tied
embeddings), the VLM backbone (qwen2-vl: M-RoPE, patch embeddings), MoE
(deepseek-moe's leading dense layer and MoE stack, llama4-maverick's
dense / MoE interleave), the Mamba-2 SSM (attention-free, no RoPE) and
the hybrid (hymba: attention and SSM heads in each layer, learned meta
tokens prepended to every sequence), the JAX package's
``repro.models.decoder`` in PyTorch.

``build_segments`` is the reference's for every family.  The stack is a
list of segments, walked here by Python loops: a "scan" segment holds
homogeneous units with stacked [n, ...] parameters (a dense, MoE or SSM
layer; a gemma3 period of 5 local layers and a global one, whose locals
stack as [n, 5, ...]; a llama4 period of a dense layer and an MoE layer,
{"dense": [n, ...], "moe": [n, ...]}); an "unroll" segment is a list of
per-layer dicts (gemma3's trailing partial period, deepseek-moe's leading
dense layer, hymba's global layers and short local runs).  The
encoder-decoder is ``repro_torch.models.encdec``.

Entry points keep the reference's signatures and trees: ``init(gen)``,
``loss(params, batch)``, ``prefill(params, batch, max_cache_len)``,
``init_cache(bsz, max_cache_len)`` and ``decode_step(params, cache,
tokens)``.  A dense model's cache is
``{"segments": [{"k": [L, B, S, KV, hd], "v": ...}], "lengths": [B]}``;
a gemma3 period's is ``{"locals": {"k": [n, 5, B, W, KV, hd], "v": ...,
"pos": [n, 5, B, W]}, "global": {"k": [n, B, S, KV, hd], "v": ...}}``; a
llama4 period's ``{"dense": {"k", "v"}, "moe": {"k", "v"}}``, each [n, B,
S, KV, hd]; an SSM stack's ``{"ssm_state": [L, B, H, P, N] f32,
"conv_state": [L, B, d_conv - 1, d_inner + 2 G N]}``; a hybrid layer's
``{"attn": {"k", "v"(, "pos")}, "ssm": {"ssm_state", "conv_state"}}``.
With ``n_meta`` meta tokens (hymba: 128) every sequence is ``n_meta``
longer: positions, lengths and full caches count the meta prefix, and the
loss drops its rows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as _ckpt

from repro_torch import tree as ttree
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.distributed.annotate import _current, ann, full, replicate
from repro_torch.distributed.params import tree_shardings
from repro_torch.distributed.sharding import place
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


def _layer(tree: dict, i: int) -> dict:
    """Unit ``i`` of a stacked [n, ...] parameter or cache dict (views)."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i]) for k, v in tree.items()}


def _stack(trees: List[dict]) -> dict:
    return {k: (_stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                else torch.stack([t[k] for t in trees])) for k in trees[0]}


#: the apply function of each one-layer unit
_APPLY = {"dense": B.apply_dense, "moe": B.apply_moe, "ssm": B.apply_ssm,
          "hybrid": B.apply_hybrid}


def _seg_layers(seg: SegmentDef, p_seg, c_seg) -> List[Tuple[Any, dict, str, Optional[dict]]]:
    """(apply function, params, layer type, cache) of each layer of a
    segment, in stack order; the params and caches are views of the
    segment's tensors."""
    if seg.kind == "unroll":
        return [(_APPLY[seg.unit], p_seg[i], seg.layer_types[i],
                 None if c_seg is None else c_seg[i]) for i in range(seg.n)]
    if seg.unit in _APPLY:
        return [(_APPLY[seg.unit], _layer(p_seg, i), seg.layer_types[i],
                 None if c_seg is None else _layer(c_seg, i)) for i in range(seg.n)]
    out = []
    for i in range(seg.n):
        p_u = _layer(p_seg, i)
        c_u = None if c_seg is None else _layer(c_seg, i)
        if seg.unit == "moe_period":  # the dense layer, then the MoE layer
            for sub, apply in (("dense", B.apply_dense), ("moe", B.apply_moe)):
                out.append((apply, p_u[sub], "global", None if c_u is None else c_u[sub]))
            continue
        # gemma_period: the locals, then the global
        for j in range(len(seg.layer_types) - 1):
            out.append((B.apply_dense, _layer(p_u["locals"], j), "local",
                        None if c_u is None else _layer(c_u["locals"], j)))
        out.append((B.apply_dense, p_u["global"], "global",
                    None if c_u is None else c_u["global"]))
    return out


def _seg_cache(seg: SegmentDef, caches: List[dict]):
    """A segment's cache from its layers' caches, in ``_seg_layers``'
    order: a list (unroll), stacked [n, ...] (scan), a gemma3 period's
    {"locals": [n, 5, ...], "global": [n, ...]} or a llama4 period's
    {"dense": [n, ...], "moe": [n, ...]}."""
    if seg.kind == "unroll":
        return caches
    if seg.unit in _APPLY:
        return _stack(caches)
    if seg.unit == "moe_period":
        return _stack([{"dense": caches[2 * i], "moe": caches[2 * i + 1]}
                       for i in range(seg.n)])
    per = len(seg.layer_types)
    return _stack([{"locals": _stack(caches[i * per:(i + 1) * per - 1]),
                    "global": caches[(i + 1) * per - 1]} for i in range(seg.n)])


# --------------------------------------------------------------------------- model
class DecoderModel:
    """``device`` is where the parameters and caches live: None means CUDA
    (raising where no card is present), ``"cpu"`` the CPU.  ``remat``
    checkpoints each layer of the training forward (each group of
    ``remat_group`` layers of a dense scan segment when that divides its
    depth), as the reference's ``jax.checkpoint``; ``moe_dispatch`` is the
    reference's: "a2a" is the expert-parallel dispatch on ``mesh`` (a
    ``DeviceMesh`` with a "model" axis) and the dense one without.

    Under ``repro_torch.distributed.use_rules`` activations and caches are
    DTensors laid out by the rules (parameters may be placed with
    ``distributed.params.tree_shardings``, or left whole); the logits and
    losses come back whole, as tensors, on every rank."""

    def __init__(self, cfg: ModelConfig, mesh=None, moe_dispatch: str = "dense",
                 remat: bool = True, attn_impl: str = "chunked", tp_comm: str = "auto",
                 remat_group: int = 1, device=None):
        if attn_impl not in ("chunked", "flash"):
            raise ValueError(f"attn_impl must be 'chunked' or 'flash', got {attn_impl!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.moe_dispatch = moe_dispatch
        self.remat = remat
        self.attn_impl = attn_impl
        self.tp_comm = tp_comm
        self.remat_group = remat_group
        self.segments = build_segments(cfg)
        self.dtype = getattr(torch, cfg.dtype)
        self.device = resolve_device(device)
        self.n_meta = cfg.hybrid.num_meta_tokens if cfg.hybrid is not None else 0

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator) -> dict:
        """Random parameters drawn from ``gen`` (on the generator's device),
        placed on the model's device."""
        cfg, dtype, dev = self.cfg, self.dtype, gen.device

        def normal(*shape):
            return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

        params: Dict[str, Any] = {
            "embed": normal(cfg.vocab_size, cfg.d_model),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
            "segments": [],
        }
        for seg in self.segments:
            if seg.kind == "unroll" and seg.unit == "hybrid":
                params["segments"].append([B.init_hybrid_layer(gen, cfg, dtype)
                                           for _ in range(seg.n)])
            elif seg.kind == "unroll":  # dense layers
                params["segments"].append([B.init_dense_layer(gen, cfg, dtype, d_ff=seg.d_ff)
                                           for _ in range(seg.n)])
            elif seg.unit == "hybrid":
                params["segments"].append(B.init_hybrid_layer(gen, cfg, dtype, n=seg.n))
            elif seg.unit == "dense":
                params["segments"].append(B.init_dense_layer(gen, cfg, dtype, d_ff=seg.d_ff,
                                                             n=seg.n))
            elif seg.unit == "moe":
                params["segments"].append(B.init_moe_layer(gen, cfg, dtype, n=seg.n))
            elif seg.unit == "ssm":
                params["segments"].append(B.init_ssm_layer(gen, cfg, dtype, n=seg.n))
            elif seg.unit == "moe_period":
                params["segments"].append({
                    "dense": B.init_dense_layer(gen, cfg, dtype,
                                                d_ff=cfg.moe.d_ff_dense or cfg.d_ff, n=seg.n),
                    "moe": B.init_moe_layer(gen, cfg, dtype, n=seg.n)})
            else:  # gemma_period
                nl = len(seg.layer_types) - 1
                params["segments"].append({
                    "locals": B.init_dense_layer(gen, cfg, dtype, n=(seg.n, nl)),
                    "global": B.init_dense_layer(gen, cfg, dtype, n=seg.n)})
        if not cfg.tie_embeddings:
            params["unembed"] = normal(cfg.d_model, cfg.vocab_size)
        if self.n_meta:
            params["meta_tokens"] = normal(self.n_meta, cfg.d_model)
        return _to(params, self.device)

    # ------------------------------------------------------------------ ctx
    def _make_ctx(self, positions, max_cache_len: int = 0, lengths=None,
                  positions_thw=None) -> B.Ctx:
        cfg = self.cfg
        ctx = B.Ctx(cfg=cfg, mesh=self.mesh, lengths=lengths, n_meta=self.n_meta,
                    moe_dispatch=self.moe_dispatch,
                    max_cache_len=max_cache_len, window=cfg.window_size,
                    remat=self.remat, attn_impl=self.attn_impl, tp_comm=self.tp_comm)
        if cfg.family == "ssm":  # attention-free: no rotary tables
            return ctx
        if cfg.vlm is not None and positions_thw is not None:
            cos, sin = L.mrope_cos_sin(positions_thw, cfg.head_dim, cfg.rope_theta,
                                       cfg.vlm.mrope_sections)
        else:
            cos, sin = L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        ctx.cos_local, ctx.sin_local = cos, sin
        if cfg.rope_theta_global:
            ctx.cos_global, ctx.sin_global = L.rope_cos_sin(positions, cfg.head_dim,
                                                            cfg.rope_theta_global)
        return ctx

    # ------------------------------------------------------------------ embedding
    def _embed_tokens(self, params, tokens) -> torch.Tensor:
        # an embedding lookup, not an index: DTensor shards it by vocab rows
        x = F.embedding(tokens.long(), params["embed"]).to(self.dtype)
        if self.cfg.attn_pattern == "gemma3":
            # gemma scales embeddings by sqrt(d_model) rounded to the model's
            # dtype first, as JAX does (33.94 is 34.0 in bf16)
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=self.dtype,
                                 device=x.device)
        return x

    def _embed(self, params, tokens, batch) -> torch.Tensor:
        x = full(self._embed_tokens(params, tokens))
        if self.cfg.vlm is not None and "patch_embeds" in batch:
            # the patch embeddings replace the tokens from position 1 (JAX's
            # dynamic_update_slice, which moves the start back to fit)
            pe = full(batch["patch_embeds"]).to(self.dtype)
            at = max(0, min(1, x.shape[1] - pe.shape[1]))
            x = torch.cat([x[:, :at], pe, x[:, at + pe.shape[1]:]], dim=1)
        if self.n_meta:
            meta = full(params["meta_tokens"])[None].expand(x.shape[0], -1, -1).to(self.dtype)
            x = torch.cat([meta, x], dim=1)
        return ann(x, "batch", None, "embed")

    def _unembed_w(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"], True
        return params["unembed"], False

    # ------------------------------------------------------------------ stack walk
    def _run_stack(self, params, x, ctx: B.Ctx, mode: str, cache=None):
        """Returns (x, aux_total, new_cache).  Train returns no cache and,
        with ``ctx.remat``, keeps only each layer's (or group's) input for
        the backward, which replays the layer (flash kernel included).
        Prefill builds each segment's cache from its layers'; decode updates
        each layer's view of the cache in place."""
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        cache_segs = cache["segments"] if cache is not None else [None] * len(self.segments)
        new_segs = []
        for seg, p_seg, c_seg in zip(self.segments, params["segments"], cache_segs):
            layers = _seg_layers(seg, p_seg, c_seg)
            if mode == "train":
                def run(xx, aux, chunk):
                    for apply, p_l, lt, _ in chunk:
                        xx, a, _ = apply(xx, p_l, ctx, lt, "train", None)
                        aux = aux + a
                    return xx, aux

                group = self.remat_group
                if not (ctx.remat and group > 1 and seg.kind == "scan" and seg.unit == "dense"
                        and seg.n % group == 0):
                    # nested remat (group > 1) saves only every group-th
                    # residual; otherwise one checkpoint per layer
                    group = 1
                for lo in range(0, len(layers), group):
                    chunk = layers[lo:lo + group]
                    if ctx.remat:
                        x, aux_total = _ckpt.checkpoint(run, x, aux_total, chunk,
                                                        use_reentrant=False)
                    else:
                        x, aux_total = run(x, aux_total, chunk)
                new_segs.append(None)
                continue
            caches = []
            for apply, p_l, lt, c_l in layers:
                x, a, nc = apply(x, p_l, ctx, lt, mode, c_l)
                aux_total = aux_total + a
                caches.append(nc)
            new_segs.append(_seg_cache(seg, caches) if mode == "prefill" else c_seg)
        x = L.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return x, aux_total, (None if mode == "train" else {"segments": new_segs})

    def loss(self, params, batch) -> Tuple[torch.Tensor, dict]:
        """batch {"tokens": [B, S] int, "loss_mask": [B, S] (optional), and
        for a VLM "patch_embeds", "positions_thw"} -> (loss, {"ce", "aux"}):
        next-token CE with the last position masked, through ``_chunked_ce``;
        the meta tokens' rows are dropped first."""
        tokens = batch["tokens"]
        bsz, S = tokens.shape
        total = S + self.n_meta
        positions = torch.arange(total, device=tokens.device)[None].expand(bsz, total)
        ctx = self._make_ctx(positions, positions_thw=batch.get("positions_thw"))
        x, aux, _ = self._run_stack(params, self._embed(params, tokens, batch), ctx, "train")
        x = x[:, self.n_meta:]
        labels = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
        mask = batch.get("loss_mask")
        mask = (torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
                if mask is None else mask.to(torch.float32))
        # the last position has no next token; written out of place, since a
        # batch laid out as a DTensor has no rule for an indexed fill
        mask = torch.cat([mask[:, :-1], torch.zeros_like(mask[:, -1:])], dim=1)
        ce = full(_chunked_ce(x, *self._unembed_w(params), labels, mask))
        aux = full(aux)
        loss = ce + aux
        return loss, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------------ prefill / decode
    def prefill(self, params, batch, max_cache_len: int):
        """batch {"tokens": [B, S] int, and for a VLM "patch_embeds",
        "positions_thw"} -> (cache, last_logits [B, V] f32, lengths [B]).
        Lengths and full caches count the meta prefix: S + n_meta tokens
        in caches of max_cache_len + n_meta."""
        tokens = batch["tokens"]
        bsz, S = tokens.shape
        total = S + self.n_meta
        positions = torch.arange(total, device=tokens.device)[None].expand(bsz, total)
        ctx = self._make_ctx(positions, max_cache_len=max_cache_len + self.n_meta,
                             positions_thw=batch.get("positions_thw"))
        x, _, cache = self._run_stack(params, self._embed(params, tokens, batch), ctx,
                                      "prefill")
        last_logits = full(L.unembed(x[:, -1], *self._unembed_w(params)))
        lengths = torch.full((bsz,), total, dtype=torch.int32, device=tokens.device)
        cache["lengths"] = lengths
        return cache, last_logits, lengths

    def init_cache(self, bsz: int, max_cache_len: int) -> dict:
        cfg = self.cfg
        ctx = B.Ctx(cfg=cfg, n_meta=self.n_meta, window=cfg.window_size,
                    max_cache_len=max_cache_len + self.n_meta)

        def layer(lt):
            return B.init_block_cache(cfg, bsz, lt, ctx, self.dtype, self.device)

        segs = []
        for seg in self.segments:
            if seg.kind == "unroll":
                segs.append([layer(lt) for lt in seg.layer_types])
            else:  # one unit's layer types, n times: one layer or a period
                unit = seg.layer_types if seg.unit.endswith("period") else seg.layer_types[:1]
                segs.append(_seg_cache(seg, [layer(lt) for lt in unit * seg.n]))
        return place_cache({"segments": segs,
                            "lengths": torch.zeros((bsz,), dtype=torch.int32,
                                                   device=self.device)})

    def decode_step(self, params, cache, tokens, batch=None):
        """tokens [B, 1]; cache from prefill / init_cache, updated in place.
        Returns (logits [B, V] f32, cache with lengths + 1).  A VLM's
        positions are the sequence index in all three M-RoPE streams, as in
        the reference (not Qwen2-VL's offset after an image)."""
        lengths = cache["lengths"]
        positions = lengths[:, None]
        positions_thw = None
        if self.cfg.vlm is not None:
            positions_thw = positions[None].expand(3, tokens.shape[0], 1)
        ctx = self._make_ctx(positions, lengths=lengths, positions_thw=positions_thw)
        x = ann(full(self._embed_tokens(params, tokens)), "batch", None, "embed")
        x, _, new_cache = self._run_stack(params, x, ctx, "decode", cache)
        logits = full(L.unembed(x[:, 0], *self._unembed_w(params)))
        new_cache["lengths"] = lengths + 1
        return logits, new_cache


def _chunked_ce(x, w, transpose, labels, mask, target_tokens: int = 16384):
    """Cross-entropy without materializing [B, S, V] logits: a loop over
    sequence chunks, each checkpointed, so the backward recomputes a
    chunk's logits instead of keeping them (the reference's scan of
    ``jax.checkpoint(body)``).  One chunk takes the plain path."""
    bsz, S, D = x.shape
    chunk = max(1, min(S, target_tokens // max(bsz, 1)))
    while S % chunk != 0:
        chunk -= 1
    n = S // chunk
    if n <= 1:
        return L.cross_entropy(L.unembed(x, w, transpose), labels, mask)

    def body(xb, lb, mb):
        logits = L.unembed(xb, w, transpose)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(replicate(logits), lb.long()[..., None], dim=-1)[..., 0]
        return ((logz - gold) * mb).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + _ckpt.checkpoint(body, x[:, sl], labels[:, sl], mask[:, sl],
                                         use_reentrant=False)
    return total / torch.clamp_min(mask.sum(), 1.0)


def place_cache(cache):
    """Under a rules context, every cache leaf laid out by its spec
    (``tree_shardings``); otherwise the cache as it is."""
    ctx = _current()
    if ctx is None:
        return cache
    return ttree.tree_map(place, cache, tree_shardings(cache, *ctx))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)
