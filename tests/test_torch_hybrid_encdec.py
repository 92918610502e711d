"""The port's hybrid family (hymba: attention and Mamba-2 heads side by side
in each layer, a learned meta-token prefix, windowed local layers and three
global ones) and its encoder-decoder (seamless-m4t: a bidirectional
encoder over frame embeddings, a decoder with cross-attention) against the
JAX package's.  Configs: hymba ``reduced()`` (4 layers, global / local
alternating, every segment one unrolled layer), hymba reduced to 8 layers
with global layers (0, 4, 7), so a run of 3 local layers makes a scanned
hybrid segment, and seamless ``reduced()`` (2 encoder and 4 decoder
layers, 24 source frames).  The reduced hymba keeps 4 meta tokens and a
window of 16.  The JAX parameters go across with ``params_from_numpy``,
their zero norm gains first moved off zero so the norms are held too;
inputs come from numpy seeds; the JAX entry points are jitted once per
configuration.

Tolerances, as ``test_torch_moe_ssm.py`` holds its families: f32 logits,
cache leaves, the encoder's output and the cross K / V 1e-5 relative to the
largest magnitude (the same f32 arithmetic with sums in another order);
loss, ``ce`` and gradients rtol 1e-5 with an atol of 1e-5 of the leaf's
largest magnitude.  bf16 within twice the rounding noise, measured in the
test as the reference in bf16 against the reference in f32 on the same
weights and inputs, or 5e-2 where that is larger.  The counterparts of the
reference's bf16 tests keep their bounds: 0.08 for decode against teacher
forcing (``test_models_smoke.py``, ``test_ssd.py``), 0.1 past the window
(``test_window_cache.py``).  Ring positions, cache lengths, splices and
served tokens are exact.
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
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models.api import build_model as j_build
from repro.models.api import make_batch as j_make_batch
from repro.models.decoder import build_segments as j_build_segments
from repro.serving import pipeline as j_pipe
from repro_torch import tree as ttree
from repro_torch.configs import get_config
from repro_torch.core import make_device
from repro_torch.models import blocks as TB
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models.api import build_model, make_batch, params_from_numpy
from repro_torch.models.decoder import build_segments
from repro_torch.models.encdec import EncDecModel
from repro_torch.optim.gradients import GradAccumulator
from repro_torch.serving import pipeline as t_pipe
from _torch_ref import (BF16_ATOL, BF16_NOISE_FACTOR, close_bf16, close_rel, JaxModel,
                        moved_norms, np32, pin_admission, RTOL, same)

MAX_CACHE = 48
HYMBA, SEAMLESS = "hymba-1.5b", "seamless-m4t-medium"
#: the configurations: (architecture, depth); hymba at 8 layers has global
#: layers (0, 4, 7)
HYMBA4, HYMBA8, SEAM = (HYMBA, 4), (HYMBA, 8), (SEAMLESS, None)
CONFIGS = [HYMBA4, HYMBA8, SEAM]
CONFIG_IDS = ["hymba-4L", "hymba-8L", "seamless"]


def _reduced(cfg, layers):
    if layers is None or layers == cfg.num_layers:
        return cfg
    globals_ = (0, layers // 2, layers - 1)
    return dataclasses.replace(cfg, num_layers=layers,
                               hybrid=dataclasses.replace(cfg.hybrid, global_layers=globals_))


def cfgs(case, dtype="float32"):
    arch, layers = case
    return tuple(dataclasses.replace(_reduced(get(arch).reduced(), layers), dtype=dtype)
                 for get in (j_get_config, get_config))


@functools.lru_cache(maxsize=None)
def jax_model(case, dtype, impl, remat=False):
    return JaxModel(cfgs(case, dtype)[0], impl, remat)


def models(case, dtype, impl, seed=0, remat=False):
    jm = jax_model(case, dtype, impl, remat)
    jp = moved_norms(jm.init(jax.random.key(seed)), seed)
    tm = build_model(cfgs(case, dtype)[1], remat=remat, attn_impl=impl, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def np_batch(cfg, rng, bsz, S, train=False):
    """Tokens and, for the encoder-decoder, frame embeddings (0.02 x a
    normal draw) as numpy arrays."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (bsz, S)).astype(np.int32)}
    if cfg.encoder is not None:
        batch["frame_embeds"] = (rng.normal(size=(bsz, cfg.encoder.source_len, cfg.d_model))
                                 * 0.02).astype(np.float32)
    if train:
        batch["loss_mask"] = np.ones((bsz, S), np.float32)
    return batch


def to_jax(batch, dtype="float32"):
    return {k: (jnp.asarray(v).astype(dtype) if k == "frame_embeds" else jnp.asarray(v))
            for k, v in batch.items()}


def to_torch(batch, dtype="float32"):
    return {k: (torch.from_numpy(v).to(getattr(torch, dtype)) if k == "frame_embeds"
                else torch.from_numpy(v)) for k, v in batch.items()}


def cache_leaves(cache):
    """(name, leaf) of a cache in JAX's order, for either package."""
    if isinstance(cache["lengths"], torch.Tensor):
        return ttree.flatten_with_names(cache)
    return j_names(cache)


def same_cache_values(tc, jc, dtype, jc32=None):
    """Every leaf: lengths and ring positions bit for bit; the rest in f32
    within 1e-5 relative, in bf16 against the leaf's rounding noise."""
    got, want = cache_leaves(tc), cache_leaves(jc)
    assert [n for n, _ in got] == [n for n, _ in want]
    ref32 = dict(cache_leaves(jc32)) if jc32 is not None else {}
    for (name, t), (_, a) in zip(got, want):
        assert tuple(t.shape) == np.asarray(a).shape, name
        assert str(t.dtype) == "torch." + str(np.asarray(a).dtype), name
        if name == "lengths" or name.endswith("/pos"):
            same(t, a)
        elif dtype == "float32":
            close_rel(t, a, name)
        else:
            close_bf16(t, a, ref32[name], name)


# --------------------------------------------------------------------------- structure
def test_segments_match_the_references():
    """hymba-1.5b: unroll 1 (global), scan 14, unroll 1, scan 15, unroll 1;
    reduced to 4 layers, four one-layer unrolled segments; at 8 layers a
    scanned run of 3 local layers and an unrolled run of 2."""
    full = [(s.kind, s.unit, s.n, s.layer_types) for s in build_segments(get_config(HYMBA))]
    assert [(k, n) for k, _, n, _ in full] == [("unroll", 1), ("scan", 14), ("unroll", 1),
                                               ("scan", 15), ("unroll", 1)]
    for case in (None, HYMBA4, HYMBA8):
        jcfg, cfg = (j_get_config(HYMBA), get_config(HYMBA)) if case is None else cfgs(case)
        got = [(s.kind, s.unit, s.n, s.layer_types, s.d_ff) for s in build_segments(cfg)]
        want = [(s.kind, s.unit, s.n, s.layer_types, s.d_ff) for s in j_build_segments(jcfg)]
        assert got == want
    assert [s.kind for s in build_segments(cfgs(HYMBA8)[1])] == [
        "unroll", "scan", "unroll", "unroll", "unroll"]
    assert get_config(HYMBA).num_params() == 1_472_105_600
    assert get_config(SEAMLESS).num_params() == 977_694_720


@pytest.mark.parametrize("case", CONFIGS, ids=CONFIG_IDS)
def test_init_draws_the_references_tree(case):
    """Leaf names, shapes and dtypes of ``init`` (bf16, the configs' own
    dtype): hymba's ``meta_tokens`` and hybrid layers, seamless's
    ``enc_layers``, ``enc_norm`` and ``dec_layers``."""
    jcfg, cfg = (_reduced(get(case[0]).reduced(), case[1]) for get in (j_get_config, get_config))
    want = j_names(jax.eval_shape(j_build(jcfg).init, jax.random.key(0)))
    tp = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    got = ttree.flatten_with_names(tp)
    assert [(n, tuple(t.shape), str(t.dtype)) for n, t in got] == [
        (n, a.shape, "torch." + str(a.dtype)) for n, a in want]
    names = [n for n, _ in got]
    if case[0] == HYMBA:
        assert "meta_tokens" in names and any("/mixer/A_log" in n for n in names)
    else:
        assert {"enc_norm", "embed", "unembed"} <= set(names)
        assert any(n.startswith("dec_layers/xattn/") for n in names)
        assert not any("xattn/q_norm" in n for n in names)


@pytest.mark.parametrize("case", CONFIGS, ids=CONFIG_IDS)
def test_params_from_numpy_carries_the_tree_leaf_for_leaf(case):
    jm, jp, tm, tp = models(case, "bfloat16", "chunked", seed=3)
    got, want = ttree.flatten_with_names(tp), j_names(jp)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, t), (_, a) in zip(got, want):
        assert str(t.dtype) == "torch." + str(np.asarray(a).dtype), name
        same(t.view(torch.int16) if t.dtype == torch.bfloat16 else t,
             np.asarray(a).view(np.int16) if t.dtype == torch.bfloat16 else a)


@pytest.mark.parametrize("case", CONFIGS, ids=CONFIG_IDS)
def test_init_cache_is_the_references(case):
    """The cache of 3 slots: hymba's {"attn", "ssm"} per layer (a ring of
    n_meta + window slots in local layers, max_cache_len + n_meta in
    global ones), seamless's stacked self K / V and static cross K / V."""
    jcfg, cfg = cfgs(case)
    jc = j_build(jcfg).init_cache(3, MAX_CACHE)
    tc = build_model(cfg, device="cpu").init_cache(3, MAX_CACHE)
    got, want = cache_leaves(tc), cache_leaves(jc)
    assert [(n, tuple(t.shape), str(t.dtype)) for n, t in got] == [
        (n, a.shape, "torch." + str(a.dtype)) for n, a in want]
    for (_, t), (_, a) in zip(got, want):
        same(t, a)


# --------------------------------------------------------------------------- the hybrid block
@pytest.mark.parametrize("layer_type", ["local", "global"])
@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_hybrid_block_prefill_and_decode_match_the_reference(rng, layer_type, impl):
    """One hybrid layer (reduced hymba, f32): prefill of 2 x (4 meta + 24)
    positions, its output and cache, then one decode step against that
    cache: output and both caches within 1e-5 relative."""
    jcfg, cfg = cfgs(HYMBA4)
    S, n_meta, W = 28, jcfg.hybrid.num_meta_tokens, jcfg.window_size
    jp = moved_norms(JB.init_hybrid_layer(jax.random.key(1), jcfg, jnp.float32), 1)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (2, S))

    def ctxs(positions, lengths=None, max_cache=0):
        jc, js = JL.rope_cos_sin(jnp.asarray(positions), cfg.head_dim, cfg.rope_theta)
        tc, ts = TL.rope_cos_sin(torch.from_numpy(np.ascontiguousarray(positions)),
                                 cfg.head_dim, cfg.rope_theta)
        kw = dict(n_meta=n_meta, window=W, max_cache_len=max_cache, attn_impl=impl)
        return (JB.Ctx(cfg=jcfg, cos_local=jc, sin_local=js, lengths=None if lengths is None
                       else jnp.asarray(lengths), **kw),
                TB.Ctx(cfg=cfg, cos_local=tc, sin_local=ts, lengths=None if lengths is None
                       else torch.from_numpy(lengths), **kw))

    jctx, tctx = ctxs(pos, max_cache=MAX_CACHE)
    jy, _, jcache = jax.jit(lambda x, p: JB.apply_hybrid(x, p, jctx, layer_type, "prefill"))(
        jnp.asarray(x), jp)
    ty, _, tcache = TB.apply_hybrid(torch.from_numpy(x), tp, tctx, layer_type, "prefill")
    close_rel(ty, jy)
    for (name, t), (_, a) in zip(ttree.flatten_with_names(tcache), j_names(jcache)):
        close_rel(t, a, name)
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    lengths = np.full((2,), S, np.int32)
    jctx, tctx = ctxs(lengths[:, None], lengths)
    jy, _, jcache = jax.jit(lambda x, p, c: JB.apply_hybrid(x, p, jctx, layer_type, "decode",
                                                            c))(jnp.asarray(x1), jp, jcache)
    ty, _, tcache = TB.apply_hybrid(torch.from_numpy(x1), tp, tctx, layer_type, "decode",
                                    tcache)
    close_rel(ty, jy)
    got, want = ttree.flatten_with_names(tcache), j_names(jcache)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, t), (_, a) in zip(got, want):
        close_rel(t, a, name)


def test_hybrid_block_train_output_and_grads_match_the_reference(rng):
    """One hybrid layer in train mode (a local layer, flash with the
    reference backward): output and the gradients of its sum, f32."""
    jcfg, cfg = cfgs(HYMBA4)
    S = 20
    jp = moved_norms(JB.init_hybrid_layer(jax.random.key(2), jcfg, jnp.float32), 2)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (2, S))
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), cfg.head_dim, cfg.rope_theta)
    tc, ts = TL.rope_cos_sin(torch.from_numpy(np.ascontiguousarray(pos)), cfg.head_dim,
                             cfg.rope_theta)
    kw = dict(n_meta=cfg.hybrid.num_meta_tokens, window=cfg.window_size, attn_impl="flash")
    jctx = JB.Ctx(cfg=jcfg, cos_local=jc, sin_local=js, **kw)
    tctx = TB.Ctx(cfg=cfg, cos_local=tc, sin_local=ts, **kw)

    def jf(p):
        return JB.apply_hybrid(jnp.asarray(x), p, jctx, "local", "train")[0].sum()

    jy, jg = jax.jit(jax.value_and_grad(jf))(jp)
    tp = ttree.tree_map(lambda t: t.requires_grad_(True), tp)
    ty = TB.apply_hybrid(torch.from_numpy(x), tp, tctx, "local", "train")[0].sum()
    leaves = ttree.leaves(tp)
    grads = torch.autograd.grad(ty, leaves)
    close_rel(ty, jy)
    for (name, _), g, (_, w) in zip(ttree.flatten_with_names(tp), grads, j_names(jg)):
        close_rel(g, w, name)


# --------------------------------------------------------------------------- the encoder-decoder's parts
def test_encoder_output_and_cross_kv_match_the_reference(rng):
    """seamless reduced, f32: ``encode`` (2 bidirectional layers and
    ``enc_norm``) and each decoder layer's ``_cross_kv`` of it."""
    jm, jp, tm, tp = models(SEAM, "float32", "chunked", seed=4)
    frames = (rng.normal(size=(2, 24, tm.cfg.d_model)) * 0.02).astype(np.float32)
    jenc = jax.jit(jm.model.encode)(jp, jnp.asarray(frames))
    tenc = tm.encode(tp, torch.from_numpy(frames))
    assert tuple(tenc.shape) == (2, 24, tm.cfg.d_model)
    close_rel(tenc, jenc)
    for i in range(tm.cfg.num_layers):
        jx = jax.tree.map(lambda a: a[i], jp["dec_layers"]["xattn"])
        tx = {k: v[i] for k, v in tp["dec_layers"]["xattn"].items()}
        for got, want in zip(TE._cross_kv(tenc, tx, tm.cfg), JE._cross_kv(jenc, jx, jm.cfg)):
            assert tuple(got.shape) == (2, 24, tm.cfg.num_kv_heads, tm.cfg.head_dim)
            close_rel(got, want)


def test_encdec_ignores_attn_impl_as_the_reference_does():
    """The reference's EncDecModel swallows ``attn_impl``; the port's does
    too, so its attention is the chunked path whatever is asked."""
    cfg = get_config(SEAMLESS).reduced()
    model = build_model(cfg, attn_impl="flash", device="cpu")
    assert isinstance(model, EncDecModel)
    assert model._dec_ctx(torch.zeros((1, 1), dtype=torch.int32)).attn_impl == "chunked"
    assert model._enc_ctx(4, 1).causal is False
    assert isinstance(j_build(j_get_config(SEAMLESS).reduced(), attn_impl="flash"), JE.EncDecModel)


# --------------------------------------------------------------------------- the models
#: (configuration, dtype, attention)
MODEL_CASES = [(HYMBA4, "float32", "chunked"), (HYMBA4, "float32", "flash"),
               (HYMBA4, "bfloat16", "flash"), (HYMBA8, "float32", "flash"),
               (HYMBA8, "bfloat16", "chunked"), (SEAM, "float32", "chunked"),
               (SEAM, "bfloat16", "chunked")]
MODEL_IDS = ["hymba-4L-f32-chunked", "hymba-4L-f32-flash", "hymba-4L-bf16-flash",
             "hymba-8L-f32-flash", "hymba-8L-bf16-chunked", "seamless-f32", "seamless-bf16"]


@pytest.mark.parametrize("case,dtype,impl", MODEL_CASES, ids=MODEL_IDS)
def test_prefill_and_teacher_forced_decode_match_the_reference(rng, case, dtype, impl):
    """Prefill two 24-token prompts (hymba: 28 positions with the 4 meta
    tokens, past the window of 16), then decode 12 steps feeding both
    models the reference's greedy tokens: the logits and every cache leaf
    after each call (the rings' positions exact; in bf16 against the
    reference's bf16-vs-f32 noise)."""
    jm, jp, tm, tp = models(case, dtype, impl)
    batch = np_batch(tm.cfg, rng, 2, 24)
    jc, jl, jlen = jm.prefill(jp, to_jax(batch, dtype), MAX_CACHE)
    tc, tl, tlen = tm.prefill(tp, to_torch(batch, dtype), MAX_CACHE)
    f32 = None
    if dtype == "bfloat16":
        jm32 = jax_model(case, "float32", impl)
        jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        f32, l32, _ = jm32.prefill(jp32, to_jax(batch), MAX_CACHE)
    n_meta = tm.n_meta if case[0] == HYMBA else 0
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 512)
    assert tlen.tolist() == np.asarray(jlen).tolist() == [24 + n_meta] * 2

    def logits_close(t, j, j32):
        close_rel(t, j) if dtype == "float32" else close_bf16(t, j, j32)

    logits_close(tl, jl, None if f32 is None else l32)
    same_cache_values(tc, jc, dtype, f32)
    cur = np.asarray(jnp.argmax(jl, axis=-1), np.int32)[:, None]
    for _ in range(12):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(cur))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(cur.copy()))
        if f32 is not None:
            l32, f32 = jm32.decode_step(jp32, f32, jnp.asarray(cur))
        logits_close(tl, jl, None if f32 is None else l32)
        same_cache_values(tc, jc, dtype, f32)
        cur = np.asarray(jnp.argmax(jl, axis=-1), np.int32)[:, None]
    assert tc["lengths"].tolist() == [24 + n_meta + 12] * 2


#: (configuration, attention, remat)
GRAD_CASES = [(HYMBA4, "chunked", False), (HYMBA4, "flash", True), (HYMBA8, "flash", True),
              (SEAM, "chunked", False), (SEAM, "chunked", True)]
GRAD_IDS = ["hymba-4L-chunked", "hymba-4L-flash-remat", "hymba-8L-flash-remat",
            "seamless", "seamless-remat"]


@pytest.mark.parametrize("case,impl,remat", GRAD_CASES, ids=GRAD_IDS)
def test_loss_and_grads_match_the_reference(rng, case, impl, remat):
    """``loss`` (hymba: the meta rows dropped before the CE), ``ce``, aux 0
    and every gradient, f32, with a loss mask that leaves out a few
    positions."""
    jm, jp, tm, tp = models(case, "float32", impl, remat=remat)
    batch = np_batch(tm.cfg, rng, 2, 32, train=True)
    batch["loss_mask"][0, 3:7] = 0.0
    (jl, jaux), jg = jm.value_and_grad(jp, to_jax(batch))
    tl, tmetrics, tg = GradAccumulator.accumulate(tm.loss, tp, to_torch(batch), 1)
    close_rel(tl, jl)
    close_rel(tmetrics["ce"], jaux["ce"])
    assert float(tmetrics["aux"]) == float(jaux["aux"]) == 0.0
    got, want = ttree.flatten_with_names(tg), j_names(jg)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        close_rel(g, w, name)
    if case[0] == HYMBA:
        assert float(tg["meta_tokens"].abs().max()) > 0


# --------------------------------------------------------------------------- counterparts of the reference's model tests
SMOKE_B, SMOKE_S = 2, 32
ARCHS = [HYMBA, SEAMLESS]


@pytest.mark.parametrize("arch", ARCHS)
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


@pytest.mark.parametrize("arch", ARCHS)
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


def test_hymba_decode_matches_teacher_forcing():
    """test_models_smoke.py's hymba case: prefill(t[:S-1]) + decode(t[S-1])
    reproduces the full prefill's last logits (rtol = atol = 0.08, bf16)."""
    cfg = get_config(HYMBA).reduced()
    model = build_model(cfg, remat=False, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (1, SMOKE_S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(7))
    _, logits_full, _ = model.prefill(params, {"tokens": toks}, max_cache_len=SMOKE_S + 4)
    cache, _, _ = model.prefill(params, {"tokens": toks[:, :SMOKE_S - 1]},
                                max_cache_len=SMOKE_S + 4)
    logits_step, _ = model.decode_step(params, cache, toks[:, SMOKE_S - 1:])
    assert torch.isfinite(logits_step).all()
    np.testing.assert_allclose(np32(logits_step), np32(logits_full), rtol=0.08, atol=0.08)


def test_seamless_decode_matches_teacher_forcing():
    """test_ssd.py's encoder-decoder case: the decoder's prefill + decode
    equals teacher forcing with the cross K / V static (rtol = atol =
    0.08, bf16)."""
    cfg = get_config(SEAMLESS).reduced()
    model = build_model(cfg, remat=False, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    S = 24
    batch = make_batch(cfg, 1, S, torch.Generator().manual_seed(5), kind="prefill")
    _, logits_full, _ = model.prefill(params, batch, max_cache_len=S + 4)
    short = dict(batch, tokens=batch["tokens"][:, :S - 1])
    cache, _, _ = model.prefill(params, short, max_cache_len=S + 4)
    cross = cache["layers"]["cross_k"].clone()
    logits_step, cache = model.decode_step(params, cache, batch["tokens"][:, S - 1:])
    assert torch.equal(cache["layers"]["cross_k"], cross)
    np.testing.assert_allclose(np32(logits_step), np32(logits_full), rtol=0.08, atol=0.08)


def _greedy_rollout(model, params, prompt, n_steps, max_cache):
    cache, logits, _ = model.prefill(params, {"tokens": prompt}, max_cache_len=max_cache)
    toks = [int(torch.argmax(logits[0]))]
    outs = [logits]
    for _ in range(n_steps - 1):
        logits, cache = model.decode_step(params, cache,
                                          torch.tensor([[toks[-1]]], dtype=torch.int32))
        toks.append(int(torch.argmax(logits[0])))
        outs.append(logits)
    return toks, outs, cache


def test_hymba_decode_past_window_matches_teacher_forcing():
    """test_window_cache.py's hymba case on the port: window 16 and 4 meta
    tokens, prefill 12 tokens, decode 12 more (the ring wraps); each
    checked step's logits match a fresh prefill of the same prefix (rtol =
    atol = 0.1, bf16)."""
    cfg = get_config(HYMBA).reduced()
    assert cfg.window_size == 16 and cfg.hybrid.num_meta_tokens == 4
    model = build_model(cfg, remat=False, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 12)).astype(np.int32))
    n_extra = 12
    toks, step_logits, _ = _greedy_rollout(model, params, prompt, n_extra + 1, max_cache=64)
    seq = prompt[0].tolist()
    for i, t in enumerate(toks[:-1]):
        seq.append(t)
        if i in (5, 8, n_extra - 1):  # 17, 20, 23 tokens: beyond W = 16
            _, logits_tf, _ = model.prefill(params, {"tokens": torch.tensor([seq])},
                                            max_cache_len=64)
            np.testing.assert_allclose(np32(step_logits[i + 1]), np32(logits_tf),
                                       rtol=0.1, atol=0.1)


def test_hymba_ring_keeps_the_meta_tokens_and_the_last_window():
    """After decoding past the window, every local layer's ring holds the 4
    meta positions in its first 4 slots and exactly the last W body
    positions in the rest."""
    cfg = get_config(HYMBA).reduced()
    n_meta, W = cfg.hybrid.num_meta_tokens, cfg.window_size
    model = build_model(cfg, remat=False, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    cache, _, _ = model.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.int32)},
                                max_cache_len=64)
    cur = torch.zeros((1, 1), dtype=torch.int32)
    for _ in range(20):
        _, cache = model.decode_step(params, cache, cur)
    total = n_meta + 8 + 20
    assert int(cache["lengths"][0]) == total
    rings = [seg[0]["attn"] for seg, lt in zip(cache["segments"], cfg.layer_types())
             if lt == "local"]
    assert len(rings) == 2
    for ring in rings:
        pos = ring["pos"][0].tolist()
        assert pos[:n_meta] == list(range(n_meta))
        assert sorted(pos[n_meta:]) == list(range(total - W, total))


# --------------------------------------------------------------------------- serving
@pytest.mark.parametrize("case", [HYMBA4, HYMBA8], ids=["hymba-4L", "hymba-8L"])
def test_splice_cache_writes_along_each_leafs_batch_axis(case):
    """A batch-1 prefill spliced into slot 2 of 3: each leaf's batch axis
    (0 in an unrolled layer's {"attn", "ssm"}, 1 in a scanned segment's
    stack) takes the prefill in slot 2 and keeps the other slots; the
    reference's splice gives the same cache."""
    jm, jp, tm, tp = models(case, "float32", "chunked")
    toks = np.random.default_rng(5).integers(0, 512, (1, 21)).astype(np.int32)
    j1, _, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, MAX_CACHE)
    t1, _, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, MAX_CACHE)
    empty = tm.init_cache(3, MAX_CACHE)
    tc = t_pipe._splice_cache(tm.init_cache(3, MAX_CACHE), t1, 2)
    jc = j_pipe._splice_cache(jm.init_cache(3, MAX_CACHE), j1, 2)
    got, one, init = (dict(cache_leaves(c)) for c in (tc, t1, empty))
    assert sorted(got) == sorted(one)
    scanned = {f"segments/{i}/" for i, s in enumerate(tm.segments) if s.kind == "scan"}
    assert bool(scanned) == (case == HYMBA8)
    assert any("/ssm/ssm_state" in n for n in got) and any("/attn/pos" in n for n in got)
    for name, leaf in got.items():
        if name == "lengths":
            assert leaf.tolist() == [0, 0, 21 + tm.n_meta]
            continue
        axes = [i for i, (m, n) in enumerate(zip(leaf.shape, one[name].shape)) if m != n]
        assert len(axes) == 1 and one[name].shape[axes[0]] == 1, name
        axis = axes[0]
        assert axis == (1 if any(name.startswith(p) for p in scanned) else 0), name
        assert torch.equal(leaf.select(axis, 2), one[name].select(axis, 0)), name
        for other in (0, 1):
            assert torch.equal(leaf.select(axis, other), init[name].select(axis, other)), name
    same_cache_values(tc, jc, "float32")


@pytest.mark.parametrize("case", [HYMBA4, HYMBA8], ids=["hymba-4L", "hymba-8L"])
def test_served_hymba_tokens_are_the_references_batch1_rollouts(case):
    """hymba reduced in f32, served by the port's server (3 slots, flash,
    admission pinned) for 6 prompts of 5-40 tokens, 8 new tokens each (the
    window of 16 wraps in prefill and in decode, the 4 meta tokens kept):
    each request's tokens equal the JAX model's batch-1 greedy rollout."""
    jm, jp, tm, tp = models(case, "float32", "flash", seed=2)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (18, 5, 40, 16, 29, 9)]
    max_new, max_cache = 8, 64
    server = t_pipe.VhostStyleServer(
        tm, tp, slots=3, max_cache_len=max_cache,
        device=pin_admission(make_device(n_instances=2, device="cpu")))
    reqs = [t_pipe.Request(req_id=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        server.enqueue(r)
    assert server.run_until_drained(max_steps=500) < 500
    assert server.metrics["completed"] == len(prompts)
    for r, p in zip(reqs, prompts):
        cache, logits, _ = jm.prefill(jp, {"tokens": jnp.asarray(p)[None]}, max_cache)
        want = [int(jnp.argmax(logits[0]))]
        for _ in range(max_new - 1):
            logits, cache = jm.decode_step(jp, cache, jnp.asarray([[want[-1]]], jnp.int32))
            want.append(int(jnp.argmax(logits[0])))
        assert r.output == want, r.req_id


# --------------------------------------------------------------------------- batches
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_has_the_references_fields(arch):
    """The same keys, shapes and dtypes as the reference's ``make_batch``
    for both kinds; seamless's ``frame_embeds`` [B, source_len, D] in the
    model's dtype at 0.02 scale."""
    cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
    for kind in ("train", "prefill"):
        got = make_batch(cfg, 2, 9, torch.Generator().manual_seed(1), kind=kind)
        want = j_make_batch(jcfg, 2, 9, jax.random.key(1), kind=kind)
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype) == "torch." + str(want[k].dtype), k
    if arch == SEAMLESS:
        fe = make_batch(cfg, 2, 9, torch.Generator().manual_seed(1))["frame_embeds"]
        assert 0.01 < float(fe.float().std()) < 0.03
