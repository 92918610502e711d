"""Encoder-decoder model (seamless-m4t): a bidirectional encoder over stub
frame embeddings and a causal decoder with cross-attention, the JAX
package's ``repro.models.encdec`` in PyTorch.

The speech frontend is a STUB: ``frame_embeds`` [B, source_len, d_model]
arrive precomputed.  The decoder is the part that serves: decode updates
its self-attention KV cache in place; the cross-attention K and V are
computed once at prefill and stay as they are.

Attention here is the chunked plain-PyTorch path everywhere: the encoder's
and decoder's self-attention (``Ctx`` keeps ``attn_impl="chunked"``), the
cross-attention in prefill (``layers.attention``, not causal) and in decode
(``layers.decode_attention``).  ``EncDecModel`` takes the reference's
keyword arguments and ignores ``attn_impl``, as the reference does, so the
flash kernel is never on this model's path.

Parameters: ``{"embed": [V, D], "enc_layers": dense layers stacked [Le,
...], "enc_norm": [D], "dec_layers": {"ln1", "lnx", "ln2", "attn", "xattn"
(no q/k norms), "mlp"} stacked [L, ...], "final_norm": [D], "unembed": [D,
V]}``.  Cache: ``{"layers": {"self": {"k", "v"} [L, B, S, KV, hd],
"cross_k", "cross_v" [L, B, source_len, KV, hd]}, "lengths": [B]}``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as _ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.distributed.annotate import ann, full, unflatten
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.decoder import _chunked_ce, _layer, _stack, _to, place_cache


def _init_cross_layer(gen, cfg: ModelConfig, dtype, n: B.Stack = None) -> dict:
    p = {
        "ln1": B._zeros((cfg.d_model,), dtype, n, gen.device),
        "lnx": B._zeros((cfg.d_model,), dtype, n, gen.device),
        "ln2": B._zeros((cfg.d_model,), dtype, n, gen.device),
        "attn": B.init_attn_params(gen, cfg, dtype, n),
        "xattn": B.init_attn_params(gen, cfg, dtype, n),
        "mlp": B.init_mlp_params(gen, cfg.d_model, cfg.d_ff, dtype, n),
    }
    p["xattn"].pop("q_norm", None)
    p["xattn"].pop("k_norm", None)
    return p


def _cross_attend(x, p, cfg: ModelConfig, ck, cv):
    """q from x against precomputed cross K / V (no rope, not causal)."""
    bsz, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    q = ann(unflatten(x @ p["wq"], 2, (H, hd)), "batch", None, "heads", None)
    # per rank on its (batch x head) shard, as the self-attention runs
    o = L.attention_trainable(q, ck, cv, causal=False)
    return _out_proj(o.reshape(bsz, S, H * hd), p["wo"])


def _out_proj(o_flat, wo):
    """The row-parallel output projection, summed at once (``layers._summed``)."""
    return L._summed(ann(o_flat, "batch", None, "qkv_flat") @ wo)


def _cross_kv(enc_out, p, cfg: ModelConfig):
    bsz, Skv, _ = enc_out.shape
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    ck = unflatten(enc_out @ p["wk"], 2, (KV, hd))
    cv = unflatten(enc_out @ p["wv"], 2, (KV, hd))
    return ann(ck, "batch", None, "kv_heads", None), ann(cv, "batch", None, "kv_heads", None)


class EncDecModel:
    """``device`` is where the parameters and caches live: None means CUDA
    (raising where no card is present), ``"cpu"`` the CPU.  ``remat``
    checkpoints each encoder and decoder layer of the training forward.
    ``mesh`` and a rules context work as in ``DecoderModel``."""

    def __init__(self, cfg: ModelConfig, mesh=None, remat: bool = True, device=None, **_):
        if cfg.encoder is None:
            raise ValueError(f"{cfg.name} has no encoder")
        self.cfg = cfg
        self.mesh = mesh
        self.remat = remat
        self.dtype = getattr(torch, cfg.dtype)
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator) -> dict:
        """Random parameters drawn from ``gen`` (on the generator's device),
        placed on the model's device."""
        cfg, dtype, dev = self.cfg, self.dtype, gen.device

        def normal(*shape):
            return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

        params = {
            "embed": normal(cfg.vocab_size, cfg.d_model),
            "enc_layers": B.init_dense_layer(gen, cfg, dtype, n=cfg.encoder.num_layers),
            "enc_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
            "dec_layers": _init_cross_layer(gen, cfg, dtype, n=cfg.num_layers),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
            "unembed": normal(cfg.d_model, cfg.vocab_size),
        }
        return _to(params, self.device)

    def _enc_ctx(self, src_len: int, bsz: int) -> B.Ctx:
        pos = torch.arange(src_len, device=self.device)[None].expand(bsz, src_len)
        cos, sin = L.rope_cos_sin(pos, self.cfg.head_dim, self.cfg.rope_theta)
        return B.Ctx(cfg=self.cfg, mesh=self.mesh, cos_local=cos, sin_local=sin, causal=False,
                     remat=self.remat)

    def _dec_ctx(self, positions, lengths=None, max_cache_len: int = 0) -> B.Ctx:
        cos, sin = L.rope_cos_sin(positions, self.cfg.head_dim, self.cfg.rope_theta)
        return B.Ctx(cfg=self.cfg, mesh=self.mesh, cos_local=cos, sin_local=sin,
                     lengths=lengths, max_cache_len=max_cache_len, remat=self.remat)

    def _embed(self, params, tokens) -> torch.Tensor:
        x = F.embedding(tokens.long(), params["embed"]).to(self.dtype)
        return ann(full(x), "batch", None, "embed")

    # ------------------------------------------------------------------ encoder
    def encode(self, params, frame_embeds) -> torch.Tensor:
        """frame_embeds [B, source_len, D] -> the encoder's output [B,
        source_len, D]: bidirectional dense layers, then ``enc_norm``."""
        x = ann(frame_embeds.to(self.dtype), "batch", None, "embed")
        ctx = self._enc_ctx(x.shape[1], x.shape[0])

        def body(xx, p_l):
            return B.apply_dense(xx, p_l, ctx, "global", "train", None)[0]

        for i in range(self.cfg.encoder.num_layers):
            p_l = _layer(params["enc_layers"], i)
            x = (_ckpt.checkpoint(body, x, p_l, use_reentrant=False) if self.remat
                 else body(x, p_l))
        return L.rms_norm(x, params["enc_norm"], self.cfg.norm_eps)

    # ------------------------------------------------------------------ decoder stack
    def _dec_stack(self, params, x, enc_out, ctx: B.Ctx, mode: str, cache=None):
        """Returns (x, the layers' cache): train none, prefill a new stacked
        cache, decode ``cache`` updated in place."""
        cfg = self.cfg
        eps = cfg.norm_eps

        def self_attn(xx, p_l, c_self):
            h, nc = B.attn_sub(L.rms_norm(xx, p_l["ln1"], eps), p_l["attn"], ctx, "global",
                               mode, c_self)
            return xx + h, nc

        def mlp(xx, p_l):
            xx = xx + L.gated_mlp(L.rms_norm(xx, p_l["ln2"], eps), p_l["mlp"], cfg.act)
            return ann(xx, "batch", None, "embed")

        if mode == "train":

            def body(xx, enc, p_l):
                xx, _ = self_attn(xx, p_l, None)
                ck, cv = _cross_kv(enc, p_l["xattn"], cfg)
                xx = xx + _cross_attend(L.rms_norm(xx, p_l["lnx"], eps), p_l["xattn"], cfg,
                                        ck, cv)
                return mlp(xx, p_l)

            for i in range(cfg.num_layers):
                p_l = _layer(params["dec_layers"], i)
                x = (_ckpt.checkpoint(body, x, enc_out, p_l, use_reentrant=False)
                     if ctx.remat else body(x, enc_out, p_l))
            return x, None

        if mode == "prefill":
            caches = []
            for i in range(cfg.num_layers):
                p_l = _layer(params["dec_layers"], i)
                x, nc_self = self_attn(x, p_l, None)
                ck, cv = _cross_kv(enc_out, p_l["xattn"], cfg)
                x = x + _cross_attend(L.rms_norm(x, p_l["lnx"], eps), p_l["xattn"], cfg, ck, cv)
                x = mlp(x, p_l)
                caches.append({"self": nc_self, "cross_k": ck, "cross_v": cv})
            return x, _stack(caches)

        if mode != "decode":
            raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got {mode!r}")
        H, hd = cfg.num_heads, cfg.head_dim
        for i in range(cfg.num_layers):
            p_l = _layer(params["dec_layers"], i)
            c_l = _layer(cache, i)
            x, _ = self_attn(x, p_l, c_l["self"])
            xq = L.rms_norm(x, p_l["lnx"], eps)
            bsz = xq.shape[0]
            q = unflatten(xq @ p_l["xattn"]["wq"], 2, (H, hd))[:, 0]
            valid = torch.ones(c_l["cross_k"].shape[:2], dtype=torch.bool, device=x.device)
            o = L.decode_attention(q, c_l["cross_k"], c_l["cross_v"], valid)
            x = x + _out_proj(o.reshape(bsz, 1, H * hd), p_l["xattn"]["wo"])
            x = mlp(x, p_l)
        return x, cache

    # ------------------------------------------------------------------ train
    def loss(self, params, batch) -> Tuple[torch.Tensor, dict]:
        """batch {"tokens": [B, S] int, "frame_embeds": [B, source_len, D],
        "loss_mask": [B, S] (optional)} -> (loss, {"ce", "aux"}): next-token
        CE with the last position masked; aux is 0."""
        cfg = self.cfg
        tokens = batch["tokens"]
        bsz, S = tokens.shape
        enc_out = self.encode(params, batch["frame_embeds"])
        positions = torch.arange(S, device=tokens.device)[None].expand(bsz, S)
        x, _ = self._dec_stack(params, self._embed(params, tokens), enc_out,
                               self._dec_ctx(positions), "train")
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        labels = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
        mask = batch.get("loss_mask")
        mask = (torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
                if mask is None else mask.to(torch.float32))
        # out of place, as DecoderModel.loss writes it
        mask = torch.cat([mask[:, :-1], torch.zeros_like(mask[:, -1:])], dim=1)
        ce = full(_chunked_ce(x, params["unembed"], False, labels, mask))
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32, device=ce.device)}

    # ------------------------------------------------------------------ prefill / decode
    def prefill(self, params, batch, max_cache_len: int):
        """batch {"tokens": [B, S] int, "frame_embeds": [B, source_len, D]}
        -> (cache, last_logits [B, V] f32, lengths [B])."""
        cfg = self.cfg
        tokens = batch["tokens"]
        bsz, S = tokens.shape
        enc_out = self.encode(params, batch["frame_embeds"])
        positions = torch.arange(S, device=tokens.device)[None].expand(bsz, S)
        ctx = self._dec_ctx(positions, max_cache_len=max_cache_len)
        x, layers = self._dec_stack(params, self._embed(params, tokens), enc_out, ctx, "prefill")
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = full(L.unembed(x[:, -1], params["unembed"], False))
        lengths = torch.full((bsz,), S, dtype=torch.int32, device=tokens.device)
        return {"layers": layers, "lengths": lengths}, logits, lengths

    def init_cache(self, bsz: int, max_cache_len: int) -> dict:
        cfg = self.cfg
        ctx = B.Ctx(cfg=cfg, max_cache_len=max_cache_len)
        cross = (bsz, cfg.encoder.source_len, cfg.num_kv_heads, cfg.head_dim)

        def layer():
            return {"self": B.init_block_cache(cfg, bsz, "global", ctx, self.dtype, self.device),
                    "cross_k": torch.zeros(cross, dtype=self.dtype, device=self.device),
                    "cross_v": torch.zeros(cross, dtype=self.dtype, device=self.device)}

        return place_cache({"layers": _stack([layer() for _ in range(cfg.num_layers)]),
                            "lengths": torch.zeros((bsz,), dtype=torch.int32,
                                                   device=self.device)})

    def decode_step(self, params, cache, tokens, batch=None):
        """tokens [B, 1]; cache from prefill / init_cache, its self-attention
        K / V updated in place.  Returns (logits [B, V] f32, cache with
        lengths + 1)."""
        cfg = self.cfg
        lengths = cache["lengths"]
        ctx = self._dec_ctx(lengths[:, None], lengths=lengths)
        x, layers = self._dec_stack(params, self._embed(params, tokens), None, ctx, "decode",
                                    cache["layers"])
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = full(L.unembed(x[:, 0], params["unembed"], False))
        return logits, {"layers": layers, "lengths": lengths + 1}
