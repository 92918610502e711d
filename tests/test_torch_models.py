"""The port's model stack (repro_torch.models, configs, launch.steps) against
the JAX package's on tinyllama-1.1b.reduced() (4 layers, d_model 128, 4
heads, 2 KV heads, head_dim 32, vocab 512), with the JAX parameters carried
over by ``params_from_numpy``.  Inputs are made with numpy from a seed.

Tolerances: f32 atol = rtol = 1e-5: the same f32 arithmetic with sums in
another order (XLA's dot and reduce against PyTorch's), a few ulps a layer
through 4 layers, and for attn_impl="flash" the Pallas kernel's tile order
against the plain version's one pass.  bf16 atol = rtol = 5e-2: every
matmul, norm and residual add rounds to bf16 (2^-8 relative) in both
packages, with f32 accumulation in another order, so a value can land one
bf16 ulp apart after any of the ~20 roundings of the stack and carry that
forward; 5e-2 is about 12 ulps of a value of 1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _tree_flatten_with_names as j_names
from repro.configs import get_config as j_get_config
from repro.launch import steps as JS
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models.api import build_model as j_build
from repro_torch import tree as ttree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import make_device
from repro_torch.launch import steps as TS
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models.api import build_model, make_batch, params_from_numpy
from repro_torch.models.decoder import DecoderModel
from repro_torch.models.encdec import EncDecModel
from repro_torch.serving.pipeline import VhostStyleServer

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MAX_CACHE = 48


def cfgs(dtype):
    return (dataclasses.replace(j_get_config("tinyllama-1.1b").reduced(), dtype=dtype),
            dataclasses.replace(get_config("tinyllama-1.1b").reduced(), dtype=dtype))


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, dtype):
    np.testing.assert_allclose(np32(got), np32(want), **TOL[dtype])


def models(dtype, impl, seed=0):
    jcfg, cfg = cfgs(dtype)
    jm = j_build(jcfg, remat=False, attn_impl=impl)
    jp = jm.init(jax.random.key(seed))
    tm = build_model(cfg, remat=False, attn_impl=impl, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _t(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(TDT[dtype])


def _j(x, dtype):
    return jnp.asarray(x, jnp.float32).astype(JDT[dtype])


# --------------------------------------------------------------------------- configs and params
def test_configs_are_the_references():
    from repro.configs import ARCH_IDS as J_ARCH_IDS

    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCH_IDS:
        want = dataclasses.asdict(j_get_config(arch))
        assert dataclasses.asdict(get_config(arch)) == want
        assert dataclasses.asdict(get_config(arch).reduced()) == dataclasses.asdict(
            j_get_config(arch).reduced())


def test_build_segments_is_the_references():
    from repro.models.decoder import build_segments as j_segments
    from repro_torch.models.decoder import build_segments

    for arch in ARCH_IDS:
        for cfg, jcfg in ((get_config(arch), j_get_config(arch)),
                          (get_config(arch).reduced(), j_get_config(arch).reduced())):
            got = [dataclasses.astuple(s) for s in build_segments(cfg)]
            assert got == [dataclasses.astuple(s) for s in j_segments(jcfg)], arch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_keeps_every_leaf_and_its_name(dtype):
    jm, jp, tm, tp = models(dtype, "chunked")
    want = j_names(jp)
    got = ttree.flatten_with_names(tp)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, t), (_, a) in zip(got, want):
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape and t.dtype == TDT[dtype], name
        assert t.contiguous().view(torch.uint8).numpy().tobytes() == a.tobytes(), name


def test_init_draws_the_references_tree_from_a_generator():
    jcfg, cfg = cfgs("bfloat16")
    jshapes = jax.eval_shape(j_build(jcfg).init, jax.random.key(0))
    tp = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    got = ttree.flatten_with_names(tp)
    want = j_names(jshapes)
    assert [(n, tuple(t.shape)) for n, t in got] == [(n, tuple(a.shape)) for n, a in want]
    assert all(t.dtype == torch.bfloat16 for _, t in got)
    again = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(ttree.leaves(tp), ttree.leaves(again)))


# --------------------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_rope_and_mlp_match_the_reference(rng, dtype):
    x = rng.normal(size=(2, 7, 128)).astype(np.float32)
    w = rng.normal(size=(128,)).astype(np.float32) * 0.1
    close(TL.rms_norm(_t(x, dtype), _t(w, dtype)), JL.rms_norm(_j(x, dtype), _j(w, dtype)), dtype)

    pos = np.broadcast_to(np.arange(3, 10)[None], (2, 7))
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), 32, 10_000.0)
    tc, ts = TL.rope_cos_sin(torch.from_numpy(pos.copy()), 32, 10_000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL["float32"])
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL["float32"])
    xh = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    got = TL.apply_rope(_t(xh, dtype), tc, ts)
    assert got.dtype == TDT[dtype]
    close(got, JL.apply_rope(_j(xh, dtype), jc, js), dtype)

    p = {k: rng.normal(size=s).astype(np.float32) * 0.1
         for k, s in (("w1", (128, 256)), ("w3", (128, 256)), ("w2", (256, 128)))}
    for act in ("silu", "gelu"):
        close(TL.gated_mlp(_t(x, dtype), {k: _t(v, dtype) for k, v in p.items()}, act),
              JL.gated_mlp(_j(x, dtype), {k: _j(v, dtype) for k, v in p.items()}, act), dtype)


def test_tensor_parallel_paths_raise():
    """tp_comm="manual_bf16" (the name is kept from when it raised): with no
    rules context it is the plain path, as in the reference; the sharded
    path is held in test_torch_distributed.py."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 2, 8, generator=g)
    p = {"w1": torch.randn(8, 16, generator=g), "w3": torch.randn(8, 16, generator=g),
         "w2": torch.randn(16, 8, generator=g)}
    assert torch.equal(TL.gated_mlp(x, p, tp_comm="manual_bf16"), TL.gated_mlp(x, p))
    wo = torch.randn(8, 8, generator=g)
    assert torch.equal(TL.row_parallel_out(x, wo, tp_comm="manual_bf16"), x @ wo)


@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_sub_prefill_matches_the_reference(rng, dtype, impl):
    jm, jp, tm, tp = models(dtype, impl)
    jcfg, cfg = jm.cfg, tm.cfg
    S = 20
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (2, S))
    jcos, jsin = JL.rope_cos_sin(jnp.asarray(pos), cfg.head_dim, cfg.rope_theta)
    tcos, tsin = TL.rope_cos_sin(torch.from_numpy(pos.copy()), cfg.head_dim, cfg.rope_theta)
    jctx = JB.Ctx(cfg=jcfg, cos_local=jcos, sin_local=jsin, max_cache_len=MAX_CACHE,
                  attn_impl=impl)
    tctx = TB.Ctx(cfg=cfg, cos_local=tcos, sin_local=tsin, max_cache_len=MAX_CACHE,
                  attn_impl=impl)
    j_attn = jax.tree.map(lambda a: a[0], jp["segments"][0]["attn"])
    t_attn = {k: v[0] for k, v in tp["segments"][0]["attn"].items()}
    jo, jc = JB.attn_sub(_j(x, dtype), j_attn, jctx, "global", "prefill", None)
    to, tc = TB.attn_sub(_t(x, dtype), t_attn, tctx, "global", "prefill", None)
    close(to, jo, dtype)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape == (2, MAX_CACHE, 2, 32)
        close(tc[key], jc[key], dtype)


# --------------------------------------------------------------------------- the whole model
@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_teacher_forced_decode_match_the_reference(rng, dtype, impl):
    """Prefill two 24-token prompts, then decode 4 steps feeding both models
    the same tokens (the reference's greedy tokens), holding the logits and
    every cache leaf after each call."""
    jm, jp, tm, tp = models(dtype, impl)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 24)).astype(np.int32)
    jc, jl, jlen = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, MAX_CACHE)
    tc, tl, tlen = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, MAX_CACHE)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 512)
    assert tlen.tolist() == np.asarray(jlen).tolist() == [24, 24]
    close(tl, jl, dtype)

    def same_cache():
        assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist()
        for key in ("k", "v"):
            want = jc["segments"][0][key]
            assert tuple(tc["segments"][0][key].shape) == want.shape == (4, 2, MAX_CACHE, 2, 32)
            assert tc["segments"][0][key].dtype == TDT[dtype]
            close(tc["segments"][0][key], want, dtype)

    same_cache()
    cur = np.asarray(jnp.argmax(jl, axis=-1), np.int32)[:, None]
    for _ in range(4):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(cur))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(cur.copy()))
        close(tl, jl, dtype)
        same_cache()
        cur = np.asarray(jnp.argmax(jl, axis=-1), np.int32)[:, None]


def test_steps_give_the_references_greedy_tokens(rng):
    jm, jp, tm, tp = models("float32", "flash", seed=3)
    toks = rng.integers(0, tm.cfg.vocab_size, (3, 17)).astype(np.int32)
    jc, jnext, _ = JS.make_prefill_step(jm, MAX_CACHE)(jp, {"tokens": jnp.asarray(toks)})
    tc, tnext, _ = TS.make_prefill_step(tm, MAX_CACHE)(tp, {"tokens": torch.from_numpy(toks)})
    assert tnext.dtype == torch.int32 and tnext.tolist() == np.asarray(jnext).tolist()
    j_dec, t_dec = JS.make_decode_step(jm), TS.make_decode_step(tm)
    for _ in range(3):
        jnext, jc = j_dec(jp, jc, jnext)
        tnext, tc = t_dec(tp, tc, tnext)
        assert tnext.tolist() == np.asarray(jnext).tolist()


def test_greedy_ties_go_to_the_first_index():
    logits = torch.zeros(2, 9)
    logits[0, [3, 7]] = 1.0
    logits[1] = 5.0

    class Fixed:
        def prefill(self, params, batch, max_cache_len):
            return {}, logits, None

    _, nxt, _ = TS.make_prefill_step(Fixed(), 8)(None, None)
    assert nxt.tolist() == [[3], [0]]
    assert np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), axis=-1)).tolist() == [3, 0]


def test_an_idle_slot_decodes_past_the_cache_end_as_the_reference(rng):
    """decode_step adds 1 to every slot's length, idle slots included, so an
    idle slot's position passes max_cache_len.  JAX drops the out-of-range
    cache write; the port drops it too (on the card an index past the end
    would be a device-side assert), and the live slot is unaffected."""
    jm, jp, tm, tp = models("float32", "chunked")
    max_cache = 8
    jc, tc = jm.init_cache(2, max_cache), tm.init_cache(2, max_cache)
    toks = rng.integers(0, tm.cfg.vocab_size, (1, 3)).astype(np.int32)
    j1, _, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_cache)
    t1, _, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_cache)
    from repro.serving.pipeline import _splice_cache as j_splice
    from repro_torch.serving.pipeline import _splice_cache as t_splice

    jc, tc = j_splice(jc, j1, 0), t_splice(tc, t1, 0)  # slot 1 stays idle from 0
    cur = rng.integers(0, tm.cfg.vocab_size, (2, 1)).astype(np.int32)
    for _ in range(max_cache + 4):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(cur))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(cur.copy()))
        close(tl, jl, "float32")
        assert np.isfinite(tl.numpy()).all()
    assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist() == [
        3 + max_cache + 4, max_cache + 4]
    for key in ("k", "v"):
        close(tc["segments"][0][key], jc["segments"][0][key], "float32")


def test_make_batch_draws_tokens_from_a_generator():
    cfg = get_config("tinyllama-1.1b").reduced()
    b = make_batch(cfg, 2, 9, torch.Generator().manual_seed(1))
    assert b["tokens"].dtype == torch.int32 and tuple(b["tokens"].shape) == (2, 9)
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < cfg.vocab_size
    assert torch.equal(b["loss_mask"], torch.ones(2, 9))
    again = make_batch(cfg, 2, 9, torch.Generator().manual_seed(1), kind="prefill")
    assert torch.equal(again["tokens"], b["tokens"]) and "loss_mask" not in again


@pytest.mark.parametrize("arch", ["hymba-1.5b", "seamless-m4t-medium"])
def test_families_not_ported_yet_raise(arch):
    """The hybrid and encoder-decoder families, the last two to be ported
    (the name is kept from when both raised ``NotImplementedError``): the
    entry points take them, and the one refusal left is the server's for
    the encoder-decoder, whose frame embeddings its admission cannot pass
    (the JAX package's server prefills tokens only as well).  Their
    parameter and cache trees are held in ``test_torch_hybrid_encdec.py``."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = make_batch(cfg, 2, 9, torch.Generator().manual_seed(1), kind="prefill")
    device = make_device(device="cpu")
    if cfg.encoder is None:
        assert isinstance(model, DecoderModel) and model.n_meta == cfg.hybrid.num_meta_tokens
        assert sorted(batch) == ["tokens"]
        server = VhostStyleServer(model, params, slots=2, max_cache_len=32, device=device)
        assert server.cache["lengths"].tolist() == [0, 0]
    else:
        assert isinstance(model, EncDecModel)
        assert sorted(batch) == ["frame_embeds", "tokens"]
        with pytest.raises(ValueError, match="encoder-decoder.*prefill and decode_step"):
            VhostStyleServer(model, params, slots=2, max_cache_len=32, device=device)


def test_model_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tinyllama-1.1b").reduced()
    with pytest.raises(RuntimeError):
        build_model(cfg)
    with pytest.raises(RuntimeError):
        params_from_numpy({"w": np.zeros(3, np.float32)})
    from repro_torch.launch.mesh import make_host_mesh

    with pytest.raises(RuntimeError):
        make_host_mesh()
