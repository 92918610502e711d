"""The port's gemma3 and VLM families (repro_torch.models) against the JAX
package's: qk-norm, M-RoPE, the local-window ring cache, gemma3's periods
(5 local layers and a global one), its embedding scale and tied
embeddings, and qwen2-vl's patch embeddings and (t, h, w) positions.
Configs are ``reduced()`` (d_model 128, 4 heads, head_dim 32, vocab 512,
window 16): gemma3 at 4 layers (unrolled, below one 6-layer period) and 8
(one period and 2 trailing locals), qwen2-vl at 4.  The JAX parameters go
across with ``params_from_numpy``, their zero norm gains first moved off
zero so the norms are held too; inputs come from numpy seeds.

Tolerances: f32 atol = rtol = 1e-4 for the models' logits and caches: the
same f32 arithmetic with sums in another order, through up to 8 layers and
a tied unembedding scaled by gemma's sqrt(d_model).  bf16 logits 5e-2, as
``test_torch_models.py`` states.  A bf16 cache leaf holds K and V after up
to 8 layers of bf16 rounding, which alone moves them by up to ~0.08 from
the f32 model's (more than 5e-2 from 6 layers on), so each leaf is held
within 5e-2 or, where larger, twice that noise, measured in the test as
the reference in bf16 against the reference in f32 with the same weights
and tokens (the rule PERF.md states for bf16 on the card).  Loss and gradients rtol 1e-5 with
an atol of 1e-5 times the leaf's largest magnitude, as
``test_torch_train.py``.  Ring-cache writes, positions and validity masks
are bit for bit; layers (qk-norm, M-RoPE) f32 1e-6.

The JAX entry points are jitted once per configuration for the module
(eager JAX compiles a scanned period's body again at every call).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _tree_flatten_with_names as j_names
from repro.configs import get_config as j_get_config
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models.api import build_model as j_build
from repro.serving import pipeline as j_pipe
from repro_torch import tree as ttree
from repro_torch.configs import get_config
from repro_torch.core import make_device
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models.api import build_model, make_batch, params_from_numpy
from repro_torch.models.decoder import build_segments
from repro_torch.optim.gradients import GradAccumulator
from repro_torch.serving import pipeline as t_pipe
from _torch_ref import BF16_NOISE_FACTOR, close_rel, JaxModel, moved_norms, np32, RTOL, same

TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
LAYER_TOL = dict(atol=1e-6, rtol=1e-6)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MAX_CACHE = 48
#: (architecture, depth): gemma3 below one period (4 unrolled layers) and
#: at one period plus 2 trailing locals; qwen2-vl at reduced()'s 4 layers
CASES = [("gemma3-1b", 4), ("gemma3-1b", 8), ("qwen2-vl-2b", 4)]
CASE_IDS = ["gemma3-4L", "gemma3-8L", "qwen2vl"]


def close(got, want, dtype="float32"):
    np.testing.assert_allclose(np32(got), np32(want), **TOL[dtype])


def cfgs(arch, layers, dtype="float32"):
    kw = dict(dtype=dtype, num_layers=layers)
    return (dataclasses.replace(j_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


@functools.lru_cache(maxsize=None)
def jax_model(arch, layers, dtype, impl, remat=False):
    return JaxModel(cfgs(arch, layers, dtype)[0], impl, remat)


def models(arch, layers, dtype, impl, seed=0, remat=False):
    jm = jax_model(arch, layers, dtype, impl, remat)
    jp = moved_norms(jm.init(jax.random.key(seed)), seed)
    tm = build_model(cfgs(arch, layers, dtype)[1], remat=remat, attn_impl=impl, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def grid_batch(cfg, rng, bsz, S, kind):
    """Tokens, and for a VLM patch embeddings at positions 1 .. P laid out
    as a 2 x (P / 2) image grid: patch (r, c) at (t, h, w) = (1, 1 + r,
    1 + c), the text after it at t = h = w = 1 + P / 2 + j (distinct t, h
    and w streams).  Returns numpy arrays."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (bsz, S)).astype(np.int32)}
    if kind == "train":
        batch["loss_mask"] = np.ones((bsz, S), np.float32)
    if cfg.vlm is None:
        return batch
    P = cfg.vlm.num_patches
    batch["patch_embeds"] = (rng.normal(size=(bsz, P, cfg.d_model)) * 0.02).astype(np.float32)
    thw = np.zeros((3, S), np.int32)
    cols = P // 2
    for i in range(P):
        thw[:, 1 + i] = (1, 1 + i // cols, 1 + i % cols)
    text = np.arange(S - 1 - P)
    thw[:, 1 + P:] = 1 + cols + text
    batch["positions_thw"] = np.ascontiguousarray(np.broadcast_to(thw[:, None], (3, bsz, S)))
    if kind == "train":
        batch["loss_mask"][:, 1:1 + P] = 0.0
    return batch


def to_j(batch, dtype="float32"):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    if "patch_embeds" in out:
        out["patch_embeds"] = out["patch_embeds"].astype(jnp.dtype(dtype))
    return out


def to_t(batch, dtype="float32"):
    out = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in batch.items()}
    if "patch_embeds" in out:
        out["patch_embeds"] = out["patch_embeds"].to(TDT[dtype])
    return out


def cache_leaves(cache):
    """(name, leaf) of a cache in JAX's order, for either package."""
    if isinstance(cache["lengths"], torch.Tensor):
        return ttree.flatten_with_names(cache)
    return j_names(cache)


def same_cache_values(tc, jc, dtype, jc32=None):
    """Every leaf: positions and lengths bit for bit; K and V in f32 within
    TOL, in bf16 within TOL widened to BF16_NOISE_FACTOR x the leaf's
    rounding noise (its distance from the f32 reference's cache ``jc32``)
    where that is larger."""
    got, want = cache_leaves(tc), cache_leaves(jc)
    assert [n for n, _ in got] == [n for n, _ in want]
    ref32 = dict(cache_leaves(jc32)) if jc32 is not None else {}
    for (name, t), (_, a) in zip(got, want):
        assert tuple(t.shape) == np.asarray(a).shape, name
        if name.endswith("pos") or name == "lengths":
            same(t, a)
        elif dtype == "float32":
            close(t, a, dtype)
        else:
            noise = float(np.abs(np32(a) - np32(ref32[name])).max())
            np.testing.assert_allclose(np32(t), np32(a), rtol=TOL[dtype]["rtol"],
                                       atol=max(TOL[dtype]["atol"], BF16_NOISE_FACTOR * noise),
                                       err_msg=f"{name}: bf16 noise {noise}")


# --------------------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_qkv_with_qk_norm_matches_the_reference(rng, dtype):
    jcfg, cfg = cfgs("gemma3-1b", 4, dtype)
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = rng.normal(size=(2, 7, D)).astype(np.float32)
    p = {"wq": rng.normal(size=(D, H * hd)), "wk": rng.normal(size=(D, KV * hd)),
         "wv": rng.normal(size=(D, KV * hd)), "q_norm": rng.normal(size=(hd,)) * 0.3,
         "k_norm": rng.normal(size=(hd,)) * 0.3}
    p = {k: (v * (D ** -0.5 if k[0] == "w" else 1.0)).astype(np.float32) for k, v in p.items()}
    jp = {k: jnp.asarray(v).astype(jnp.dtype(dtype)) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(TDT[dtype]) for k, v in p.items()}
    norms = ("q_norm", "k_norm")
    want = JL.project_qkv(jnp.asarray(x).astype(jnp.dtype(dtype)), jp, jcfg,
                          qk_norm_p={k: jp[k] for k in norms})
    got = TL.project_qkv(torch.from_numpy(x).to(TDT[dtype]), tp, cfg,
                         qk_norm_p={k: tp[k] for k in norms})
    plain = TL.project_qkv(torch.from_numpy(x).to(TDT[dtype]), tp, cfg)
    tol = LAYER_TOL if dtype == "float32" else TOL[dtype]
    for g, w, raw in zip(got, want, plain):
        assert g.dtype == TDT[dtype] and tuple(g.shape) == w.shape
        np.testing.assert_allclose(np32(g), np32(w), **tol)
    # the norm changed q and k, not v
    assert not torch.equal(got[0], plain[0]) and torch.equal(got[2], plain[2])


def test_mrope_cos_sin_matches_the_reference(rng):
    """Three distinct position streams (t, h, w), sections (16, 24, 24) of
    qwen2-vl-2b's 64 frequency slots and (4, 6, 6) of reduced()'s 16."""
    for hd, sections in ((128, (16, 24, 24)), (32, (4, 6, 6))):
        thw = rng.integers(0, 300, (3, 2, 11)).astype(np.int32)
        jc, js = JL.mrope_cos_sin(jnp.asarray(thw), hd, 1e6, sections)
        tc, ts = TL.mrope_cos_sin(torch.from_numpy(thw), hd, 1e6, sections)
        assert tc.dtype == torch.float32 and tuple(tc.shape) == jc.shape == (2, 11, hd // 2)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **LAYER_TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **LAYER_TOL)
        # each section follows its own stream: with t = h = w it is rope
        same_thw = np.broadcast_to(thw[:1], thw.shape).copy()
        rc, rs = TL.rope_cos_sin(torch.from_numpy(thw[0]), hd, 1e6)
        mc, ms = TL.mrope_cos_sin(torch.from_numpy(same_thw), hd, 1e6, sections)
        assert torch.equal(mc, rc) and torch.equal(ms, rs)
    with pytest.raises(AssertionError):
        TL.mrope_cos_sin(torch.zeros(3, 1, 1, dtype=torch.int32), 32, 1e6, (4, 6, 5))


# --------------------------------------------------------------------------- the ring cache
def _ring_ctx(cfg, mod, n_meta, window=16):
    return mod.Ctx(cfg=cfg, n_meta=n_meta, window=window, max_cache_len=MAX_CACHE)


@pytest.mark.parametrize("n_meta", [0, 4])
# window 16: S = 16 fills the ring exactly with no meta prefix, S = 20 with 4
@pytest.mark.parametrize("S", [9, 16, 20, 45])
def test_ring_cache_prefill_write_and_decode_update_match_the_reference(rng, n_meta, S):
    """The prefill write (the last min(W, S - n_meta) tokens at slots
    n_meta + (pos - n_meta) % W) and 40 decode updates (the ring wraps
    more than twice), each with its validity mask, bit for bit; a global
    layer's full cache beside it."""
    jcfg, cfg = cfgs("gemma3-1b", 4)
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    jctx, tctx = _ring_ctx(jcfg, JB, n_meta), _ring_ctx(cfg, TB, n_meta)
    k = rng.normal(size=(2, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(2, S, KV, hd)).astype(np.float32)
    for lt in ("local", "global"):
        jc = JB._write_prefill_cache(jcfg, jctx, lt, jnp.asarray(k), jnp.asarray(v))
        tc = TB._write_prefill_cache(cfg, tctx, lt, torch.from_numpy(k), torch.from_numpy(v))
        assert sorted(tc) == sorted(jc) == (["k", "pos", "v"] if lt == "local" else ["k", "v"])
        for key in jc:
            same(tc[key], jc[key])
    assert tc["k"].shape[1] == MAX_CACHE
    # decode from the ring prefill; the two rows at different lengths
    jc = JB._write_prefill_cache(jcfg, jctx, "local", jnp.asarray(k), jnp.asarray(v))
    tc = TB._write_prefill_cache(cfg, tctx, "local", torch.from_numpy(k), torch.from_numpy(v))
    assert tuple(tc["k"].shape) == (2, n_meta + 16, KV, hd)
    lengths = np.asarray([S, max(S - 7, 0)], np.int32)
    for _ in range(40):
        k1 = rng.normal(size=(2, KV, hd)).astype(np.float32)
        v1 = rng.normal(size=(2, KV, hd)).astype(np.float32)
        jctx = dataclasses.replace(jctx, lengths=jnp.asarray(lengths))
        tctx = dataclasses.replace(tctx, lengths=torch.from_numpy(lengths.copy()))
        jc, jk, jv, jvalid = JB._decode_cache_update(jcfg, jctx, "local", jc,
                                                     jnp.asarray(k1), jnp.asarray(v1))
        tc, tk, tv, tvalid = TB._decode_cache_update(cfg, tctx, "local", tc,
                                                     torch.from_numpy(k1), torch.from_numpy(v1))
        for key in ("k", "v", "pos"):
            same(tc[key], jc[key])
        same(tvalid, jvalid)
        assert int(tvalid.sum(1).max()) <= n_meta + 16
        lengths = lengths + 1
    assert tc["pos"].dtype == torch.int32


def test_ring_cache_valid_mask_keeps_meta_tokens_and_drops_expired_slots():
    """After 30 tokens with n_meta 4 and W 8, the meta slots stay valid and
    the ring holds exactly positions 22 .. 29."""
    _, cfg = cfgs("gemma3-1b", 4)
    ctx = _ring_ctx(cfg, TB, 4, window=8)
    k = torch.randn(1, 29, cfg.num_kv_heads, cfg.head_dim, generator=torch.Generator().manual_seed(0))
    cache = TB._write_prefill_cache(cfg, ctx, "local", k, k)
    ctx.lengths = torch.tensor([29], dtype=torch.int32)
    cache, _, _, valid = TB._decode_cache_update(cfg, ctx, "local", cache, k[:, 0], k[:, 0])
    assert sorted(cache["pos"][0].tolist()) == [0, 1, 2, 3] + list(range(22, 30))
    assert valid.all()


# --------------------------------------------------------------------------- init
@pytest.mark.parametrize("arch", ["gemma3-1b", "gemma3-4b", "qwen2-vl-2b"])
def test_init_draws_the_references_tree(arch):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    want = j_names(jax.eval_shape(j_build(jcfg).init, jax.random.key(0)))
    tp = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    got = ttree.flatten_with_names(tp)
    assert [(n, tuple(t.shape)) for n, t in got] == [(n, tuple(a.shape)) for n, a in want]
    assert all(t.dtype == TDT[cfg.dtype] for _, t in got)
    names = [n for n, _ in got]
    if cfg.tie_embeddings:
        assert "unembed" not in names and any(n.endswith("q_norm") for n in names)
    else:
        assert "unembed" in names


def test_gemma3_segments_at_full_depth():
    """gemma3-1b's 26 layers: 4 periods of (5 local, 1 global), then 2
    unrolled locals; the init_cache tree matches the reference's."""
    segs = build_segments(get_config("gemma3-1b"))
    assert [(s.kind, s.unit, s.n) for s in segs] == [("scan", "gemma_period", 4),
                                                     ("unroll", "dense", 2)]
    jcfg, cfg = cfgs("gemma3-1b", 8)
    jc = j_build(jcfg).init_cache(3, MAX_CACHE)
    tc = build_model(cfg, device="cpu").init_cache(3, MAX_CACHE)
    got, want = cache_leaves(tc), cache_leaves(jc)
    assert [(n, tuple(t.shape), str(t.dtype)) for n, t in got] == [
        (n, a.shape, "torch." + str(a.dtype)) for n, a in want]
    for (name, t), (_, a) in zip(got, want):
        same(t, a)
    assert tuple(tc["segments"][0]["locals"]["pos"].shape) == (1, 5, 3, 16)


# --------------------------------------------------------------------------- the whole model
@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,layers", CASES, ids=CASE_IDS)
def test_prefill_and_teacher_forced_decode_match_the_reference(rng, arch, layers, dtype, impl):
    """Prefill two 24-token prompts (past gemma's 16-token window; qwen2-vl
    with 8 patches on a 2 x 4 grid), then decode 12 steps feeding both
    models the reference's greedy tokens (the ring wraps): the logits and
    every cache leaf after each call.  In bf16 the reference in f32, with
    the same weights and tokens, gives each cache leaf's rounding noise."""
    jm, jp, tm, tp = models(arch, layers, dtype, impl)
    batch = grid_batch(tm.cfg, rng, 2, 24, "prefill")
    jc, jl, jlen = jm.prefill(jp, to_j(batch, dtype), MAX_CACHE)
    tc, tl, tlen = tm.prefill(tp, to_t(batch, dtype), MAX_CACHE)
    f32 = None
    if dtype == "bfloat16":
        jm32 = jax_model(arch, layers, "float32", impl)
        jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        f32 = jm32.prefill(jp32, to_j(batch), MAX_CACHE)[0]
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 512)
    assert tlen.tolist() == np.asarray(jlen).tolist() == [24, 24]
    close(tl, jl, dtype)
    same_cache_values(tc, jc, dtype, f32)
    cur = np.asarray(jnp.argmax(jl, axis=-1), np.int32)[:, None]
    for _ in range(12):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(cur))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(cur.copy()))
        if f32 is not None:
            f32 = jm32.decode_step(jp32, f32, jnp.asarray(cur))[1]
        close(tl, jl, dtype)
        same_cache_values(tc, jc, dtype, f32)
        cur = np.asarray(jnp.argmax(jl, axis=-1), np.int32)[:, None]


def test_gemma_embedding_scale_rounds_to_the_models_dtype_first():
    """sqrt(1152) = 33.94 is 34.0 in bf16: the scaled embedding is the
    bf16 row times 34, as in JAX."""
    cfg = dataclasses.replace(get_config("gemma3-1b").reduced(), d_model=1152)
    tm = build_model(cfg, device="cpu")
    row = torch.tensor([[0.5, -0.25, 1.0]], dtype=torch.bfloat16)
    x = tm._embed_tokens({"embed": row}, torch.zeros(1, 1, dtype=torch.int32))
    assert x.dtype == torch.bfloat16 and x[0, 0].tolist() == [17.0, -8.5, 34.0]


@pytest.mark.parametrize("impl,remat", [("chunked", False), ("flash", True)])
@pytest.mark.parametrize("arch,layers", CASES[1:], ids=CASE_IDS[1:])
def test_loss_and_grads_match_the_reference(rng, arch, layers, impl, remat):
    """DecoderModel.loss and its gradients (per-layer remat or none): the
    tied embedding's gradient sums the lookup's and the unembedding's;
    qwen2-vl's batch carries patch embeddings, grid positions and a loss
    mask zero over the patches."""
    jm, jp, tm, tp = models(arch, layers, "float32", impl, remat=remat)
    batch = grid_batch(tm.cfg, rng, 2, 32, "train")
    (jl, jaux), jg = jm.value_and_grad(jp, to_j(batch))
    tl, tmetrics, tg = GradAccumulator.accumulate(tm.loss, tp, to_t(batch), 1)
    close_rel(tl, jl)
    close_rel(tmetrics["ce"], jaux["ce"])
    got, want = ttree.flatten_with_names(tg), j_names(jg)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        close_rel(g, w)


def test_make_batch_draws_the_vlm_fields_from_a_generator():
    cfg = get_config("qwen2-vl-2b").reduced()
    b = make_batch(cfg, 2, 9, torch.Generator().manual_seed(1))
    P = min(cfg.vlm.num_patches, 9 - 2)
    assert tuple(b["patch_embeds"].shape) == (2, P, cfg.d_model)
    assert b["patch_embeds"].dtype == torch.bfloat16
    assert float(b["patch_embeds"].float().abs().max()) < 0.2
    assert b["positions_thw"].dtype == torch.int32
    assert torch.equal(b["positions_thw"], torch.arange(9, dtype=torch.int32).expand(3, 2, 9))
    assert b["loss_mask"][:, 1:1 + P].abs().sum() == 0 and b["loss_mask"][:, 1 + P:].all()
    again = make_batch(cfg, 2, 9, torch.Generator().manual_seed(1), kind="prefill")
    assert torch.equal(again["patch_embeds"], b["patch_embeds"]) and "loss_mask" not in again
    # an encoder-decoder's batch carries frame embeddings [B, source_len, D]
    # in the model's dtype at 0.02 scale
    audio = get_config("seamless-m4t-medium").reduced()
    fe = make_batch(audio, 1, 4, torch.Generator().manual_seed(0))["frame_embeds"]
    assert tuple(fe.shape) == (1, audio.encoder.source_len, audio.d_model)
    assert fe.dtype == torch.bfloat16
    assert 0.01 < float(fe.float().std()) < 0.03


# --------------------------------------------------------------------------- counterparts of the reference's model tests
def _greedy_rollout(model, params, prompt, n_steps, max_cache):
    cache, logits, _ = model.prefill(params, {"tokens": prompt}, max_cache_len=max_cache)
    toks = [int(torch.argmax(logits[0]))]
    outs = [logits]
    for _ in range(n_steps - 1):
        logits, cache = model.decode_step(params, cache,
                                          torch.tensor([[toks[-1]]], dtype=torch.int32))
        toks.append(int(torch.argmax(logits[0])))
        outs.append(logits)
    return toks, outs


def test_decode_past_window_matches_teacher_forcing():
    """test_window_cache.py's gemma3 case on the port: window 16, prefill 12
    tokens, decode 12 more (the ring wraps); each checked step's logits
    match a fresh prefill of the same prefix (rtol = atol = 0.1, bf16)."""
    cfg = get_config("gemma3-1b").reduced()
    assert cfg.window_size == 16
    model = build_model(cfg, remat=False, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 12)).astype(np.int32))
    n_extra = 12
    toks, step_logits = _greedy_rollout(model, params, prompt, n_extra + 1, max_cache=64)
    seq = prompt[0].tolist()
    for i, t in enumerate(toks[:-1]):
        seq.append(t)
        if i in (5, 8, n_extra - 1):  # positions 17, 20, 23: beyond W = 16
            _, logits_tf, _ = model.prefill(params, {"tokens": torch.tensor([seq])},
                                            max_cache_len=64)
            np.testing.assert_allclose(np32(step_logits[i + 1]), np32(logits_tf),
                                       rtol=0.1, atol=0.1)


def test_ring_slots_wrap_and_expire():
    """test_window_cache.py's direct inspection: after decoding past W, the
    trailing local layer's ring holds the last W absolute positions only."""
    cfg = get_config("gemma3-1b").reduced()
    model = build_model(cfg, remat=False, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    cache, _, _ = model.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.int32)},
                                max_cache_len=64)
    cur = torch.zeros((1, 1), dtype=torch.int32)
    for _ in range(20):
        _, cache = model.decode_step(params, cache, cur)
    seg = cache["segments"][-1]
    ring = seg[0] if isinstance(seg, list) else seg
    live = sorted(p for p in ring["pos"][0].tolist() if p >= 0)
    total = 8 + 20
    assert live == list(range(total - cfg.window_size, total))


def test_gemma3_layer_pattern():
    cfg = get_config("gemma3-4b")
    lt = cfg.layer_types()
    assert len(lt) == 34
    assert lt[5] == "global" and lt[11] == "global"
    assert lt[:5] == ("local",) * 5
    assert sum(t == "global" for t in lt) == 5  # 34 = 5 full periods + 4 locals


SMOKE_B, SMOKE_S = 2, 32


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-vl-2b"])
def test_arch_train_step(arch):
    """test_models_smoke.py's train step on the port: a finite loss, finite
    gradients, some of them non-zero (bf16, remat)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, remat=True, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = make_batch(cfg, SMOKE_B, SMOKE_S, torch.Generator().manual_seed(0), kind="train")
    loss, _, grads = GradAccumulator.accumulate(model.loss, params, batch, 1)
    assert loss.shape == () and torch.isfinite(loss), arch
    leaves = ttree.leaves(grads)
    assert all(torch.isfinite(g).all() for g in leaves), arch
    assert any(float(g.float().abs().max()) > 0 for g in leaves), arch


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-vl-2b"])
def test_arch_prefill_decode(arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg, remat=False, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = make_batch(cfg, SMOKE_B, SMOKE_S, torch.Generator().manual_seed(0), kind="prefill")
    cache, logits, lengths = model.prefill(params, batch, max_cache_len=SMOKE_S + 8)
    assert tuple(logits.shape) == (SMOKE_B, cfg.vocab_size) and torch.isfinite(logits).all()
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    logits2, cache = model.decode_step(params, cache, tok)
    assert tuple(logits2.shape) == (SMOKE_B, cfg.vocab_size) and torch.isfinite(logits2).all()
    assert int(cache["lengths"][0]) == int(lengths[0]) + 1


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-vl-2b"])
def test_decode_matches_teacher_forcing(arch):
    """prefill(t[:S-1]) + decode(t[S-1]) reproduces the full prefill's
    last logits (rtol = atol = 0.08, bf16, as the reference's test)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, remat=False, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (1, SMOKE_S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(7))
    _, logits_full, _ = model.prefill(params, {"tokens": toks}, max_cache_len=SMOKE_S + 4)
    cache, _, _ = model.prefill(params, {"tokens": toks[:, :SMOKE_S - 1]},
                                max_cache_len=SMOKE_S + 4)
    logits_step, _ = model.decode_step(params, cache, toks[:, SMOKE_S - 1:])
    np.testing.assert_allclose(np32(logits_step), np32(logits_full), rtol=0.08, atol=0.08)


# --------------------------------------------------------------------------- serving
def test_splice_cache_writes_along_each_leafs_batch_axis():
    """gemma3 reduced to 8 layers (a period's locals are [1, 5, B, 16, ...],
    its global [1, B, S, ...], the 2 trailing locals [B, 16, ...]), 3
    slots, a batch-1 prefill spliced into slot 2.  The JAX package's splice
    writes the period's local layer 0 into local layer 2 of every row, and
    leaves slot 2's local layer 1 empty; the port's makes slot 2 of every
    leaf bit-equal to the prefill and leaves the other slots as they were."""
    jm, jp, tm, tp = models("gemma3-1b", 8, "float32", "chunked")
    toks = np.random.default_rng(5).integers(0, 512, (1, 21)).astype(np.int32)
    j1, _, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, MAX_CACHE)
    t1, _, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, MAX_CACHE)

    jc = j_pipe._splice_cache(jm.init_cache(3, MAX_CACHE), j1, 2)
    j_locals, j_one = jc["segments"][0]["locals"], j1["segments"][0]["locals"]
    np.testing.assert_array_equal(np.asarray(j_locals["k"][:, 2, 0]),
                                  np.asarray(j_one["k"][:, 0, 0]))  # every row, layer 2
    assert np.abs(np.asarray(j_locals["k"][:, :, 0])).sum() > 0  # slot 0 written
    assert not np.array_equal(np.asarray(j_locals["k"][:, 1, 2]),
                              np.asarray(j_one["k"][:, 1, 0]))  # slot 2, layer 1 lost
    assert (np.asarray(j_locals["pos"][:, 1, 2]) == -1).all()

    empty = tm.init_cache(3, MAX_CACHE)
    tc = t_pipe._splice_cache(tm.init_cache(3, MAX_CACHE), t1, 2)
    axes = {"segments/0/locals": 2, "segments/0/global": 1, "segments/1": 0}
    got, one, init = (dict(cache_leaves(c)) for c in (tc, t1, empty))
    assert sorted(got) == sorted(one)
    for name, leaf in got.items():
        if name == "lengths":
            assert leaf.tolist() == [0, 0, 21]
            continue
        axis = next(a for prefix, a in axes.items() if name.startswith(prefix))
        assert torch.equal(leaf.select(axis, 2), one[name].select(axis, 0)), name
        for other in (0, 1):
            assert torch.equal(leaf.select(axis, other), init[name].select(axis, other)), name


def test_served_gemma3_tokens_are_the_references_batch1_rollouts():
    """gemma3 reduced to 8 layers in f32, served by the port's server (3
    slots, flash) for 6 prompts of 5-40 tokens, 8 new tokens each (the
    window of 16 wraps in prefill and in decode): each request's tokens
    equal the JAX model's batch-1 greedy rollout of its prompt."""
    jm, jp, tm, tp = models("gemma3-1b", 8, "float32", "flash", seed=2)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (18, 5, 40, 16, 29, 9)]
    max_new, max_cache = 8, 64
    server = t_pipe.VhostStyleServer(tm, tp, slots=3, max_cache_len=max_cache,
                                     device=make_device(n_instances=2, device="cpu"))
    reqs = [t_pipe.Request(req_id=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        server.enqueue(r)
    assert server.run_until_drained(max_steps=500) < 500
    for r, p in zip(reqs, prompts):
        cache, logits, _ = jm.prefill(jp, {"tokens": jnp.asarray(p)[None]}, max_cache)
        want = [int(jnp.argmax(logits[0]))]
        for _ in range(max_new - 1):
            logits, cache = jm.decode_step(jp, cache, jnp.asarray([[want[-1]]], jnp.int32))
            want.append(int(jnp.argmax(logits[0])))
        assert r.output == want, r.req_id
