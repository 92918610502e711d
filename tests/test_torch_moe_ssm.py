"""The port's MoE and Mamba-2 SSM families (repro_torch.models.moe, .ssm and
their blocks and decoder units) against the JAX package's: the router's
top-k (ties to the lower expert), the capacity dispatch (keep masks and
bucket positions exactly), the SSD chunked form and its decode recurrence,
the fixed SSM leaves bit for bit, and deepseek-moe-16b (a leading dense
layer, then MoE layers with shared experts), llama4-maverick (dense / MoE
periods, top-1) and mamba2-370m at ``reduced()`` size: prefill and 12
decode steps, loss, aux and gradients, one train step, served tokens and
the cache splice.  The JAX parameters go across with ``params_from_numpy``
(norm gains moved off zero, so the norms are held too); inputs come from
numpy seeds; the JAX entry points are jitted once per configuration.

Tolerances: the router's weights and aux 1e-6 (the same f32 softmax);
dispatch outputs, SSD functions and f32 model logits and cache leaves 1e-5
relative to the largest magnitude (the same f32 arithmetic with sums in
another order; the SSD's 4-operand einsums contract pairwise in the port
and in opt_einsum's order in JAX); loss, aux and gradients rtol 1e-5 with
an atol of 1e-5 of the leaf's largest magnitude (``test_torch_train.py``).
bf16 within twice the rounding noise, measured in the test as the
reference in bf16 against the reference in f32 on the same weights and
inputs (or 5e-2 where that is larger, ``test_torch_models.py``'s bf16
tolerance).  Routing indices, keep masks, bucket positions, cache lengths
and served tokens are exact.
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
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.core import make_device as j_make_device
from repro.launch import steps as JS
from repro.models import moe as JM
from repro.models import ssm as JSSM
from repro.models.api import build_model as j_build
from repro.optim.adamw import AdamW as JAdamW
from repro.serving import pipeline as j_pipe
from repro_torch import tree as ttree
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig, SSMConfig
from repro_torch.core import make_device
from repro_torch.launch import steps as TS
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TSSM
from repro_torch.models.api import build_model, make_batch, opt_state_from_numpy, params_from_numpy
from repro_torch.models.decoder import build_segments
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.gradients import GradAccumulator
from repro_torch.serving import pipeline as t_pipe

RTOL = 1e-5
ROUTER_TOL = dict(atol=1e-6, rtol=1e-6)
BF16_ATOL = 5e-2
BF16_NOISE_FACTOR = 2.0
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MAX_CACHE = 48
DEEPSEEK, LLAMA4, MAMBA2 = "deepseek-moe-16b", "llama4-maverick-400b-a17b", "mamba2-370m"
ARCHS = (DEEPSEEK, LLAMA4, MAMBA2)
ARCH_IDS = ("deepseek", "llama4", "mamba2")


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close_rel(got, want, err_msg=""):
    """rtol 1e-5, atol 1e-5 of ``want``'s largest magnitude."""
    w = np32(want)
    scale = float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(np32(got), w, rtol=RTOL, atol=RTOL * scale, err_msg=err_msg)


def close_bf16(got, want, want32, err_msg=""):
    """Within BF16_NOISE_FACTOR x the reference's own bf16-vs-f32 distance
    (or BF16_ATOL where that is larger)."""
    noise = float(np.abs(np32(want) - np32(want32)).max()) if np32(want).size else 0.0
    np.testing.assert_allclose(np32(got), np32(want), rtol=BF16_ATOL,
                               atol=max(BF16_ATOL, BF16_NOISE_FACTOR * noise),
                               err_msg=f"{err_msg} (bf16 noise {noise})")


def same(got, want):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(g, np.asarray(want))


def cfgs(arch, dtype="float32"):
    return (dataclasses.replace(j_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


def _moved_norms(params, seed):
    """The JAX parameters with every norm gain (zeros at init) drawn at 0.1
    scale, so the norms' weights are held as well."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        name = str(path[-1])
        if "norm" in name or "ln" in name:
            return (a.astype(jnp.float32) + 0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(move, params)


class JaxModel:
    """The reference model with its entry points jitted."""

    def __init__(self, cfg, impl, remat):
        self.model = j_build(cfg, remat=remat, attn_impl=impl)
        self.cfg = cfg
        self.init = self.model.init
        self.init_cache = self.model.init_cache
        self.prefill = jax.jit(self.model.prefill, static_argnums=(2,))
        self.decode_step = jax.jit(self.model.decode_step)
        self.value_and_grad = jax.jit(jax.value_and_grad(self.model.loss, has_aux=True))


@functools.lru_cache(maxsize=None)
def jax_model(arch, dtype, impl, remat=False):
    return JaxModel(cfgs(arch, dtype)[0], impl, remat)


def models(arch, dtype, impl, seed=0, remat=False):
    jm = jax_model(arch, dtype, impl, remat)
    jp = _moved_norms(jm.init(jax.random.key(seed)), seed)
    tm = build_model(cfgs(arch, dtype)[1], remat=remat, attn_impl=impl, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def cache_leaves(cache):
    """(name, leaf) of a cache in JAX's order, for either package."""
    if isinstance(cache["lengths"], torch.Tensor):
        return ttree.flatten_with_names(cache)
    return j_names(cache)


def same_cache_values(tc, jc, dtype, jc32=None):
    """Every leaf: lengths bit for bit; the rest in f32 within 1e-5
    relative, in bf16 against the leaf's rounding noise (``close_bf16``)."""
    got, want = cache_leaves(tc), cache_leaves(jc)
    assert [n for n, _ in got] == [n for n, _ in want]
    ref32 = dict(cache_leaves(jc32)) if jc32 is not None else {}
    for (name, t), (_, a) in zip(got, want):
        assert tuple(t.shape) == np.asarray(a).shape, name
        assert str(t.dtype) == "torch." + str(np.asarray(a).dtype), name
        if name == "lengths":
            same(t, a)
        elif dtype == "float32":
            close_rel(t, a, name)
        else:
            close_bf16(t, a, ref32[name], name)


# --------------------------------------------------------------------------- the router
#: (experts, top k, tokens): reduced() deepseek (4, 2), deepseek-moe-16b's
#: 64 experts top-6 (at decode's 4 tokens and a prefill's 96), llama4's
#: 128 experts top-1
ROUTER_CASES = [(4, 2, 24), (64, 6, 4), (64, 6, 96), (128, 1, 40)]


def _moe_cfgs(E, k, cf=1.25, shared=0):
    kw = dict(num_experts=E, top_k=k, d_ff_expert=32, num_shared_experts=shared,
              capacity_factor=cf)
    return JMoEConfig(**kw), MoEConfig(**kw)


@pytest.mark.parametrize("E,k,T", ROUTER_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_topk_matches_the_reference(rng, E, k, T, dtype):
    D = 64
    jcfg, cfg = _moe_cfgs(E, k)
    x = (rng.normal(size=(T, D))).astype(np.float32)
    w = (rng.normal(size=(D, E)) * D ** -0.5).astype(np.float32)
    jw, jidx, jaux = JM.router_topk(jnp.asarray(x).astype(jnp.dtype(dtype)), jnp.asarray(w), jcfg)
    tw, tidx, taux = TM.router_topk(torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(w), cfg)
    same(tidx, jidx)
    assert tw.dtype == torch.float32 and tuple(tw.shape) == (T, k)
    np.testing.assert_allclose(np32(tw), np32(jw), **ROUTER_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **ROUTER_TOL)


def test_router_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same probability; a router whose
    columns repeat gives exact ties between those experts.  Both packages
    take the lower index first."""
    T, D, E, k = 6, 16, 8, 3
    jcfg, cfg = _moe_cfgs(E, k)
    x = np.random.default_rng(1).normal(size=(T, D)).astype(np.float32)
    cols = np.random.default_rng(2).normal(size=(D, 3)).astype(np.float32)
    # experts 1, 4, 6 share column 0; 2 and 7 column 1; the rest column 2
    tied = cols[:, [2, 0, 1, 2, 0, 2, 0, 1]]
    for w in (np.zeros((D, E), np.float32), tied):
        jw, jidx, jaux = JM.router_topk(jnp.asarray(x), jnp.asarray(w), jcfg)
        tw, tidx, taux = TM.router_topk(torch.from_numpy(x), torch.from_numpy(w), cfg)
        same(tidx, jidx)
        np.testing.assert_allclose(np32(tw), np32(jw), **ROUTER_TOL)
        np.testing.assert_allclose(float(taux), float(jaux), **ROUTER_TOL)
    # with the zero router every token takes experts 0, 1, 2
    _, tidx, _ = TM.router_topk(torch.from_numpy(x), torch.zeros(D, E), cfg)
    assert tidx.tolist() == [[0, 1, 2]] * T
    # and among tied columns the lower index leads
    _, tidx, _ = TM.router_topk(torch.from_numpy(x), torch.from_numpy(tied), cfg)
    for row in tidx.tolist():
        for a, b in zip(row, row[1:]):
            if tied[:, a].tobytes() == tied[:, b].tobytes():
                assert a < b, row


# --------------------------------------------------------------------------- the dispatch
def _j_plan(idx, E, k, T, cf):
    """The reference's capacity bookkeeping (``repro.models.moe._moe_dense``),
    for holding the port's keep masks and bucket positions."""
    cap = max(int(cf * k * T / E), 1)
    flat_e = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
    keep = pos < cap
    return flat_e, jnp.where(keep, pos, 0), keep, cap


def _router(rng, D, E, skew: bool):
    """A router at the reference's init scale; ``skew`` leans it towards
    expert 0, so that bucket overflows."""
    w = rng.normal(size=(D, E)) * D ** -0.5
    if skew:
        w[:, 0] += 2.0 * D ** -0.5
    return w.astype(np.float32)


#: (experts, top k, tokens, capacity factor, skewed): reduced() deepseek's
#: 4 experts top-2 with a skewed router and a tight capacity (drops);
#: deepseek-moe-16b's 64 top-6 at decode (4 tokens: cap 1) and at 64
#: tokens; llama4's 128 top-1 at 32 tokens
DISPATCH_CASES = [(4, 2, 40, 1.0, True), (4, 2, 40, 1.25, False), (64, 6, 4, 1.25, False),
                  (64, 6, 64, 1.25, True), (128, 1, 32, 1.25, True)]


@pytest.mark.parametrize("E,k,T,cf,skew", DISPATCH_CASES)
def test_dispatch_plan_keeps_and_places_as_the_reference(rng, E, k, T, cf, skew):
    D = 32
    jcfg, cfg = _moe_cfgs(E, k, cf)
    x = rng.normal(size=(T, D)).astype(np.float32)
    w = _router(rng, D, E, skew)
    _, jidx, _ = JM.router_topk(jnp.asarray(x), jnp.asarray(w), jcfg)
    j_e, j_pos, j_keep, j_cap = _j_plan(jidx, E, k, T, cf)
    t_e, t_pos, t_keep, t_src, t_cap = TM.dispatch_plan(torch.from_numpy(np.asarray(jidx)).long(),
                                                         cfg, T)
    assert t_cap == j_cap
    same(t_e, j_e)
    same(t_pos, j_pos)
    same(t_keep, j_keep)
    assert t_src.tolist() == np.repeat(np.arange(T), k).tolist()
    # every kept (expert, position) pair is unique, and an expert's kept
    # assignments fill 0 .. n - 1 in token-major order
    kept = [(e, p) for e, p, kk in zip(t_e.tolist(), t_pos.tolist(), t_keep.tolist()) if kk]
    assert len(set(kept)) == len(kept)
    if skew and E == 4:
        assert not bool(t_keep.all()), "the skewed case must drop assignments"


@pytest.mark.parametrize("E,k,T,cf,skew", DISPATCH_CASES)
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_dense_matches_the_reference(rng, E, k, T, cf, skew, act):
    """``_moe_dense`` in f32 within 1e-5; in bf16 within twice the
    reference's own bf16-vs-f32 distance, on the same routing."""
    D, F = 32, 24
    jcfg, cfg = _moe_cfgs(E, k, cf)
    x = rng.normal(size=(T, D)).astype(np.float32)
    w = _router(rng, D, E, skew)
    p = {"w1": rng.normal(size=(E, D, F)) * D ** -0.5, "w3": rng.normal(size=(E, D, F)) * D ** -0.5,
         "w2": rng.normal(size=(E, F, D)) * F ** -0.5}
    jweights, jidx, _ = JM.router_topk(jnp.asarray(x), jnp.asarray(w), jcfg)
    out = {}
    for dtype in ("float32", "bfloat16"):
        jp = {n: jnp.asarray(v, jnp.float32).astype(jnp.dtype(dtype)) for n, v in p.items()}
        tp = {n: torch.from_numpy(v.astype(np.float32)).to(TDT[dtype]) for n, v in p.items()}
        jx = jnp.asarray(x).astype(jnp.dtype(dtype))
        tx = torch.from_numpy(x).to(TDT[dtype])
        want = JM._moe_dense(jx, jweights, jidx, jp, jcfg, act)
        got = TM._moe_dense(tx, torch.from_numpy(np.asarray(jweights)),
                            torch.from_numpy(np.asarray(jidx)).long(), tp, cfg, act)
        assert got.dtype == TDT[dtype] and tuple(got.shape) == (T, D)
        out[dtype] = (got, want)
    close_rel(*out["float32"])
    close_bf16(*out["bfloat16"], out["float32"][1])


@pytest.mark.parametrize("dispatch", ["dense", "a2a"])
@pytest.mark.parametrize("E,k,shared", [(4, 2, 2), (64, 6, 2), (128, 1, 1)])
def test_moe_block_with_shared_experts_matches_the_reference(rng, E, k, shared, dispatch):
    """The whole block (router, dispatch, shared experts) from
    ``init_moe_params``' tree; "a2a" without a mesh is the dense dispatch in
    both packages."""
    D, B, S = 32, 2, 10
    jcfg, cfg = _moe_cfgs(E, k, shared=shared)
    jp = JM.init_moe_params(jax.random.key(3), jcfg, D, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    jy, jaux = JM.moe_block(jnp.asarray(x), jp, jcfg, "silu", dispatch=dispatch)
    ty, taux = TM.moe_block(torch.from_numpy(x), tp, cfg, "silu", dispatch=dispatch)
    assert tuple(ty.shape) == (B, S, D)
    close_rel(ty, jy)
    np.testing.assert_allclose(float(taux), float(jaux), **ROUTER_TOL)
    dense, _ = TM.moe_block(torch.from_numpy(x), tp, cfg, "silu")
    assert torch.equal(ty, dense)


def test_init_moe_params_draws_the_references_leaves():
    """Names, shapes, dtypes (the router in f32) and scales; a stack of n
    layers is drawn one layer at a time."""
    jcfg, cfg = _moe_cfgs(16, 2, shared=2)
    D = 64
    want = jax.eval_shape(lambda: JM.init_moe_params(jax.random.key(0), jcfg, D, jnp.bfloat16))
    got = TM.init_moe_params(torch.Generator().manual_seed(0), cfg, D, torch.bfloat16)
    assert sorted(got) == sorted(want)
    for n, a in want.items():
        assert tuple(got[n].shape) == a.shape and str(got[n].dtype) == "torch." + str(a.dtype), n
    stacked = TM.init_moe_params(torch.Generator().manual_seed(0), cfg, D, torch.bfloat16, n=3)
    assert tuple(stacked["w1"].shape) == (3, 16, D, 32)
    for n, scale in (("w1", D ** -0.5), ("w2", 32 ** -0.5), ("shared_w2", 64 ** -0.5),
                     ("router", D ** -0.5)):
        std = float(stacked[n].float().std())
        assert 0.9 * scale < std < 1.1 * scale, (n, std, scale)
    assert not torch.equal(stacked["w1"][0], stacked["w1"][1])


# --------------------------------------------------------------------------- SSD
def _ssd_inputs(rng, B=2, S=64, H=4, P=8, G=1, N=16):
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    a_bar = -rng.uniform(0.01, 0.5, size=(B, S, H)).astype(np.float32)
    b = rng.normal(size=(B, S, G, N)).astype(np.float32)
    c = rng.normal(size=(B, S, G, N)).astype(np.float32)
    return x, a_bar, b, c


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("chunk_a,chunk_b", [(8, 16), (8, 32), (16, 64)])
def test_ssd_chunk_size_invariance(rng, chunk_a, chunk_b):
    """test_ssd.py's chunk-size invariance on the port (tolerance 2e-4)."""
    x, a_bar, b, c = _t(*_ssd_inputs(rng))
    ya, sa = TSSM.ssd_chunked(x, a_bar, b, c, chunk_a)
    yb, sb = TSSM.ssd_chunked(x, a_bar, b, c, chunk_b)
    np.testing.assert_allclose(ya.numpy(), yb.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(sa.numpy(), sb.numpy(), rtol=2e-4, atol=2e-4)


def test_ssd_matches_sequential_recurrence(rng):
    """test_ssd.py's literal per-step recurrence against the port's
    chunked form (tolerance 2e-4)."""
    x, a_bar, b, c = _ssd_inputs(rng, B=1, S=32, H=2, P=4, N=8)
    y_chunk, state_chunk = TSSM.ssd_chunked(*_t(x, a_bar, b, c), chunk=8)
    B_, S, H, P = x.shape
    N = b.shape[-1]
    state = np.zeros((B_, H, P, N), np.float32)
    ys = np.zeros((B_, S, H, P), np.float32)
    for t in range(S):
        decay = np.exp(a_bar[:, t])
        state = state * decay[..., None, None] + x[:, t][..., None] * b[:, t, 0][:, None, None, :]
        ys[:, t] = (state * c[:, t, 0][:, None, None, :]).sum(-1)
    np.testing.assert_allclose(y_chunk.numpy(), ys, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(state_chunk.numpy(), state, rtol=2e-4, atol=2e-4)


def _mixer_cfgs(**kw):
    base = dict(d_state=8, d_conv=4, expand=2, head_dim=8, chunk_size=8)
    base.update(kw)
    return JSSMConfig(**base), SSMConfig(**base)


def test_mixer_prefill_state_matches_decode_chain(rng):
    """test_ssd.py's: the prefill's final SSD state and convolution window
    equal the ones left by decoding the same tokens one by one (the port's
    mixer; tolerance 3e-3)."""
    jcfg, cfg = _mixer_cfgs()
    d_model = 16
    p = params_from_numpy(jax.tree.map(np.asarray, JSSM.init_mamba2_params(
        jax.random.key(0), jcfg, d_model, jnp.float32)), device="cpu")
    x = torch.from_numpy((rng.normal(size=(1, 16, d_model)) * 0.3).astype(np.float32))
    _, state_pf, conv_pf = TSSM.mamba2_mixer_with_state(x, p, cfg, d_model)
    H = cfg.n_heads(d_model)
    state = torch.zeros((1, H, cfg.head_dim, cfg.d_state))
    conv = torch.zeros((1, cfg.d_conv - 1, cfg.d_inner(d_model) + 2 * cfg.n_groups * cfg.d_state))
    for t in range(x.shape[1]):
        _, state, conv = TSSM.mamba2_decode_step(x[:, t], state, conv, p, cfg, d_model)
    np.testing.assert_allclose(state_pf.numpy(), state.numpy(), rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(conv_pf.numpy(), conv.numpy(), rtol=3e-3, atol=3e-3)


def test_segsum_matches_the_reference(rng):
    x = rng.normal(size=(2, 3, 9)).astype(np.float32)
    want, got = np.asarray(JSSM.segsum(jnp.asarray(x))), TSSM.segsum(torch.from_numpy(x)).numpy()
    assert (np.isneginf(want) == np.isneginf(got)).all()
    finite = np.isfinite(want)
    close_rel(got[finite], want[finite])


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_the_reference(rng, G, with_state):
    x, a_bar, b, c = _ssd_inputs(rng, S=48, H=4, G=G)
    s0 = rng.normal(size=(2, 4, 8, 16)).astype(np.float32) if with_state else None
    jy, js = JSSM.ssd_chunked(*map(jnp.asarray, (x, a_bar, b, c)), 16,
                              initial_state=None if s0 is None else jnp.asarray(s0))
    ty, ts = TSSM.ssd_chunked(*_t(x, a_bar, b, c), 16,
                              initial_state=None if s0 is None else torch.from_numpy(s0))
    assert ty.dtype == ts.dtype == torch.float32
    close_rel(ty, jy)
    close_rel(ts, js)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_depthwise_conv_matches_the_reference(rng, dtype):
    x = rng.normal(size=(2, 11, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32) * 0.1
    bias = rng.normal(size=(24,)).astype(np.float32) * 0.1
    jdt = jnp.dtype(dtype)
    want = JSSM._causal_depthwise_conv(*(jnp.asarray(a).astype(jdt) for a in (x, w, bias)))
    got = TSSM._causal_depthwise_conv(*(torch.from_numpy(a).to(TDT[dtype]) for a in (x, w, bias)))
    assert got.dtype == TDT[dtype]
    # the same f32 products and sums in the same order: bit for bit
    same(got.float(), np.asarray(want.astype(jnp.float32)))


#: sequence lengths for the mixer: one chunk (S <= chunk_size), chunks that
#: halve to 8 (40), and an odd length whose chunk halves down to 1 (33)
MIXER_LENGTHS = [5, 8, 40, 33]


@pytest.mark.parametrize("S", MIXER_LENGTHS)
def test_mamba2_mixer_and_decode_step_match_the_reference(rng, S):
    """``mamba2_mixer_with_state`` (output, final state, conv window) and 3
    decode steps from it, f32 within 1e-5; the mixer in bf16 within twice
    the reference's rounding noise."""
    jcfg, cfg = _mixer_cfgs(chunk_size=32, d_state=16, head_dim=16)
    d_model = 32
    jp = _moved_norms(JSSM.init_mamba2_params(jax.random.key(1), jcfg, d_model, jnp.float32), 1)
    x = (rng.normal(size=(2, S, d_model)) * 0.5).astype(np.float32)
    outs = {}
    for dtype in ("float32", "bfloat16"):
        jdt = jnp.dtype(dtype)
        # the reference's dtypes: dt_bias, A_log and D stay f32
        jpd = {k: (v if k in ("dt_bias", "A_log", "D") else v.astype(jdt)) for k, v in jp.items()}
        tp = params_from_numpy(jax.tree.map(np.asarray, jpd), device="cpu")
        want = JSSM.mamba2_mixer_with_state(jnp.asarray(x).astype(jdt), jpd, jcfg, d_model)
        got = TSSM.mamba2_mixer_with_state(torch.from_numpy(x).to(TDT[dtype]), tp, cfg, d_model)
        assert [str(g.dtype) for g in got] == ["torch." + str(w.dtype) for w in want]
        outs[dtype] = (got, want, jpd, tp)
    (got, want, jpd, tp), (gb, wb, _, _) = outs["float32"], outs["bfloat16"]
    for g, w in zip(got, want):
        close_rel(g, w)
    for g, w, w32 in zip(gb, wb, want):
        close_bf16(g, w, w32)
    _, jstate, jconv = want
    _, tstate, tconv = got
    for t in range(3):
        x1 = (rng.normal(size=(2, d_model)) * 0.5).astype(np.float32)
        jy, jstate, jconv = JSSM.mamba2_decode_step(jnp.asarray(x1), jstate, jconv, jpd, jcfg,
                                                    d_model)
        ty, tstate, tconv = TSSM.mamba2_decode_step(torch.from_numpy(x1), tstate, tconv, tp, cfg,
                                                    d_model)
        for g, w in ((ty, jy), (tstate, jstate), (tconv, jconv)):
            close_rel(g, w)


@pytest.mark.parametrize("arch,H", [(MAMBA2, 32), (MAMBA2, 16), ("hymba-1.5b", 50)])
def test_fixed_ssm_leaves_are_the_references_bit_for_bit(arch, H):
    """dt_bias, A_log and D (f32), out_norm and conv_b (zeros in the
    model's dtype) from the port's init equal the reference's, bit for
    bit, at full size and reduced()."""
    full = j_get_config(arch)
    ssm_cfg = full.ssm if full.ssm is not None else full.hybrid.ssm
    d_model = full.d_model if H != 16 else 128
    if H == 16:
        ssm_cfg = (j_get_config(arch).reduced().ssm if full.ssm is not None
                   else j_get_config(arch).reduced().hybrid.ssm)
    tcfg = SSMConfig(**dataclasses.asdict(ssm_cfg))
    assert tcfg.n_heads(d_model) == H
    want = JSSM.init_mamba2_params(jax.random.key(0), ssm_cfg, d_model, jnp.bfloat16)
    got = TSSM.init_mamba2_params(torch.Generator().manual_seed(0), tcfg, d_model, torch.bfloat16)
    assert sorted(got) == sorted(want)
    for name in ("dt_bias", "A_log", "D", "out_norm", "conv_b"):
        a = np.asarray(want[name])
        assert str(got[name].dtype) == "torch." + str(a.dtype), name
        g = got[name].view(torch.int16 if a.itemsize == 2 else torch.int32).numpy()
        np.testing.assert_array_equal(g, a.view(np.int16 if a.itemsize == 2 else np.int32), name)
    for name in ("in_proj", "conv_w", "out_proj"):
        assert tuple(got[name].shape) == want[name].shape and got[name].dtype == torch.bfloat16
    stacked = TSSM.init_mamba2_params(torch.Generator().manual_seed(0), tcfg, d_model,
                                      torch.bfloat16, n=2)
    assert torch.equal(stacked["A_log"][1], got["A_log"])


def test_fixed_leaves_outside_the_table_are_within_a_few_ulps():
    """Correctly rounded float64 values against XLA's CPU log and expm1,
    which are up to 3 ulps off at these head counts."""
    for H in (7, 24, 64):
        dt, a = TSSM.fixed_leaves(H)
        jdt = np.asarray(jnp.log(jnp.expm1(jnp.linspace(1e-3, 1e-1, H))).astype(jnp.float32))
        ja = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, H)).astype(jnp.float32))
        for got, want in ((dt, jdt), (a, ja)):
            ulps = np.abs(got.view(np.int32).astype(np.int64)
                          - want.view(np.int32).astype(np.int64))
            assert ulps.max() <= 4, (H, ulps.max())


# --------------------------------------------------------------------------- the decoder
def test_segments_at_full_depth():
    """deepseek-moe-16b: a leading dense layer (d_ff 10944), then 27 MoE
    layers; llama4-maverick: 24 (dense, MoE) periods; mamba2-370m: 48 SSM
    layers."""
    got = {a: [(s.kind, s.unit, s.n, s.d_ff) for s in build_segments(get_config(a))]
           for a in ARCHS}
    assert got == {DEEPSEEK: [("unroll", "dense", 1, 10944), ("scan", "moe", 27, None)],
                   LLAMA4: [("scan", "moe_period", 24, None)],
                   MAMBA2: [("scan", "ssm", 48, None)]}
    assert get_config(DEEPSEEK).num_params() == 16_372_072_448


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_init_draws_the_references_tree(arch):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    want = j_names(jax.eval_shape(j_build(jcfg).init, jax.random.key(0)))
    tp = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    got = ttree.flatten_with_names(tp)
    assert [(n, tuple(t.shape), str(t.dtype)) for n, t in got] == [
        (n, a.shape, "torch." + str(a.dtype)) for n, a in want]


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_init_cache_is_the_references(arch):
    jcfg, cfg = cfgs(arch)
    jc = j_build(jcfg).init_cache(3, MAX_CACHE)
    tc = build_model(cfg, device="cpu").init_cache(3, MAX_CACHE)
    got, want = cache_leaves(tc), cache_leaves(jc)
    assert [(n, tuple(t.shape), str(t.dtype)) for n, t in got] == [
        (n, a.shape, "torch." + str(a.dtype)) for n, a in want]
    for (_, t), (_, a) in zip(got, want):
        same(t, a)


#: (architecture, dtype, attention): both MoE models in f32 under both
#: attention paths between them, and each in bf16; mamba2 has no attention
MODEL_CASES = [(DEEPSEEK, "float32", "chunked"), (DEEPSEEK, "float32", "flash"),
               (DEEPSEEK, "bfloat16", "flash"), (LLAMA4, "float32", "flash"),
               (LLAMA4, "bfloat16", "chunked"), (MAMBA2, "float32", "chunked"),
               (MAMBA2, "bfloat16", "chunked")]


@pytest.mark.parametrize("arch,dtype,impl", MODEL_CASES)
def test_prefill_and_teacher_forced_decode_match_the_reference(rng, arch, dtype, impl):
    """Prefill two 24-token prompts, then decode 12 steps feeding both models
    the reference's greedy tokens: the logits and every cache leaf after
    each call (in bf16 against the reference's bf16-vs-f32 noise)."""
    jm, jp, tm, tp = models(arch, dtype, impl)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 24)).astype(np.int32)
    jc, jl, jlen = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, MAX_CACHE)
    tc, tl, tlen = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, MAX_CACHE)
    f32 = None
    if dtype == "bfloat16":
        jm32 = jax_model(arch, "float32", impl)
        jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        f32, l32, _ = jm32.prefill(jp32, {"tokens": jnp.asarray(toks)}, MAX_CACHE)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 512)
    assert tlen.tolist() == np.asarray(jlen).tolist() == [24, 24]

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


#: (architecture, attention, remat)
GRAD_CASES = [(DEEPSEEK, "chunked", False), (DEEPSEEK, "flash", True), (LLAMA4, "flash", True),
              (MAMBA2, "chunked", False), (MAMBA2, "chunked", True)]


@pytest.mark.parametrize("arch,impl,remat", GRAD_CASES)
def test_loss_aux_and_grads_match_the_reference(rng, arch, impl, remat):
    """DecoderModel.loss (ce + the routers' aux) and its gradients, f32."""
    jm, jp, tm, tp = models(arch, "float32", impl, remat=remat)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 32)).astype(np.int32)
    batch = {"tokens": toks, "loss_mask": np.ones((2, 32), np.float32)}
    (jl, jaux), jg = jm.value_and_grad(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tmetrics, tg = GradAccumulator.accumulate(
        tm.loss, tp, {k: torch.from_numpy(v) for k, v in batch.items()}, 1)
    close_rel(tl, jl)
    close_rel(tmetrics["ce"], jaux["ce"])
    np.testing.assert_allclose(float(tmetrics["aux"]), float(jaux["aux"]), rtol=RTOL,
                               atol=RTOL * float(jaux["ce"]))
    if arch != MAMBA2:
        assert float(tmetrics["aux"]) > 0
    got, want = ttree.flatten_with_names(tg), j_names(jg)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        close_rel(g, w, name)


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_one_train_step_matches_the_reference(arch):
    """One make_train_step step (AdamW, clipping) from the same parameters
    and non-zero moments (one step taken by the reference first): new
    parameters, moments and metrics, f32."""
    jcfg, cfg = cfgs(arch)
    jm = j_build(jcfg, remat=False)
    jopt = JAdamW(lr=1e-3)
    jstep = jax.jit(JS.make_train_step(jm, jopt))
    rng = np.random.default_rng(9)
    batches = [{"tokens": rng.integers(0, 512, (2, 16)).astype(np.int32),
                "loss_mask": np.ones((2, 16), np.float32)} for _ in range(2)]
    jp = jm.init(jax.random.key(2))
    jp, jo, _ = jstep(jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in batches[0].items()})
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    to = opt_state_from_numpy(jax.tree.map(np.asarray, jo), device="cpu")
    jp2, jo2, jmet = jstep(jp, jo, {k: jnp.asarray(v) for k, v in batches[1].items()})
    tm = build_model(cfg, remat=True, attn_impl="flash", device="cpu")
    tp2, to2, tmet = TS.make_train_step(tm, AdamW(lr=1e-3))(
        tp, to, {k: torch.from_numpy(v) for k, v in batches[1].items()})
    for got, want in ((tp2, jp2), (to2.m, jo2.m), (to2.v, jo2.v)):
        for (name, g), (_, w) in zip(ttree.flatten_with_names(got), j_names(want)):
            close_rel(g, w, name)
    assert int(to2.step) == int(jo2.step) == 2
    for k in ("loss", "grad_norm", "ce", "aux"):
        close_rel(tmet[k], jmet[k])


def test_moe_aux_loss_nonzero():
    """test_models_smoke.py's on the port: deepseek-moe's loss carries a
    positive aux term (bf16, its own init)."""
    cfg = get_config(DEEPSEEK).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = make_batch(cfg, 2, 32, torch.Generator().manual_seed(0), kind="train")
    _, metrics = model.loss(params, batch)
    assert float(metrics["aux"]) > 0.0


SMOKE_B, SMOKE_S = 2, 32


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_arch_train_step(arch):
    """test_models_smoke.py's train step on the port: a finite loss, finite
    gradients, some of them non-zero (bf16, remat)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, remat=True, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = make_batch(cfg, SMOKE_B, SMOKE_S, torch.Generator().manual_seed(0), kind="train")
    loss, _, grads = GradAccumulator.accumulate(model.loss, params, batch, 1)
    assert loss.shape == () and torch.isfinite(loss)
    leaves = ttree.leaves(grads)
    assert all(torch.isfinite(g).all() for g in leaves)
    assert any(float(g.float().abs().max()) > 0 for g in leaves)


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_decode_matches_teacher_forcing(arch):
    """prefill(t[:S-1]) + decode(t[S-1]) reproduces the full prefill's
    last logits (rtol = atol = 0.08, bf16, as the reference's test); the
    SSM's counterpart of chip_smoke.py's phase 4i check.  As there, an MoE
    runs with capacity factor 8: which assignments a full expert drops
    depends on the sequence's length, so the two prefills agree only where
    none is dropped."""
    cfg = get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
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


# --------------------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_splice_cache_writes_along_each_leafs_batch_axis(arch):
    """A batch-1 prefill spliced into slot 2 of 3: the leaf's batch axis,
    found from the shapes (the one axis where the two caches differ), takes
    the prefill in slot 2 and keeps the other slots; the reference's splice
    gives the same cache for these structures (deepseek's unrolled dense
    layer [B, ...], its MoE stack and mamba2's states [L, B, ...], llama4's
    {"dense", "moe"} periods)."""
    jm, jp, tm, tp = models(arch, "float32", "chunked")
    toks = np.random.default_rng(5).integers(0, 512, (1, 21)).astype(np.int32)
    j1, _, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, MAX_CACHE)
    t1, _, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, MAX_CACHE)
    empty = tm.init_cache(3, MAX_CACHE)
    tc = t_pipe._splice_cache(tm.init_cache(3, MAX_CACHE), t1, 2)
    jc = j_pipe._splice_cache(jm.init_cache(3, MAX_CACHE), j1, 2)
    got, one, init = (dict(cache_leaves(c)) for c in (tc, t1, empty))
    assert sorted(got) == sorted(one)
    for name, leaf in got.items():
        if name == "lengths":
            assert leaf.tolist() == [0, 0, 21]
            continue
        axes = [i for i, (m, n) in enumerate(zip(leaf.shape, one[name].shape)) if m != n]
        assert len(axes) == 1 and one[name].shape[axes[0]] == 1, name
        axis = axes[0]
        assert axis == (0 if name.startswith("segments/0/0") and arch == DEEPSEEK else 1), name
        assert torch.equal(leaf.select(axis, 2), one[name].select(axis, 0)), name
        for other in (0, 1):
            assert torch.equal(leaf.select(axis, other), init[name].select(axis, other)), name
    same_cache_values(tc, jc, "float32")


def pin_admission(device):
    """Wait for each prompt copy burst as it is submitted, so the server
    admits every request in the step after its copies went out, whatever
    the engines' speed.  At decode the reduced MoE's capacity is 1 (3
    slots, top-2 of 4 experts), so a request's tokens depend on which
    requests share its decode steps (ROADMAP.md, held for parity), and two
    servers that admit at other steps serve other tokens."""
    submit = device.batch_async

    def batch_async(*a, **kw):
        fut = submit(*a, **kw)
        fut.wait()
        return fut

    device.batch_async = batch_async
    return device


def test_moe_tokens_depend_on_their_neighbours_in_both_packages():
    """The parity quirk pin_admission works around: three sequences, each
    prefilled alone and spliced into a 3-slot cache, take one decode step
    together, where the capacity is 1 (top-2 of 4 experts, 3 tokens); the
    last slot's logits differ from the same sequence's step alone, and the
    same way in both packages."""
    jm, jp, tm, tp = models(DEEPSEEK, "float32", "chunked", seed=4)
    toks = np.random.default_rng(3).integers(0, 512, (3, 12)).astype(np.int32)
    out = {}
    for name, m, p, conv, pipe in (("j", jm, jp, jnp.asarray, j_pipe),
                                   ("t", tm, tp, torch.from_numpy, t_pipe)):
        cache = m.init_cache(3, MAX_CACHE)
        for i in range(3):
            one, _, _ = m.prefill(p, {"tokens": conv(toks[i:i + 1, :-1].copy())}, MAX_CACHE)
            cache = pipe._splice_cache(cache, one, i)
        batch_l, _ = m.decode_step(p, cache, conv(toks[:, -1:].copy()))
        alone, _, _ = m.prefill(p, {"tokens": conv(toks[2:, :-1].copy())}, MAX_CACHE)
        alone_l, _ = m.decode_step(p, alone, conv(toks[2:, -1:].copy()))
        out[name] = (np32(batch_l)[2], np32(alone_l)[0])
    close_rel(out["t"][0], out["j"][0])
    close_rel(out["t"][1], out["j"][1])
    assert np.abs(out["j"][0] - out["j"][1]).max() > 1e-3
    assert np.abs(out["t"][0] - out["t"][1]).max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_served_tokens_are_the_references(arch):
    """Six requests of 5-40 tokens through three slots (f32; flash for the
    MoE models), 6 new tokens each, admission pinned (``pin_admission``):
    each request's tokens, the metrics' counts and the completion order
    equal the JAX server's."""
    impl = "chunked" if arch == MAMBA2 else "flash"
    jm, jp, tm, tp = models(arch, "float32", impl, seed=2)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (18, 5, 40, 16, 29, 9)]

    def serve(pipe, model, params, device):
        server = pipe.VhostStyleServer(model, params, slots=3, max_cache_len=64,
                                       device=pin_admission(device))
        reqs = [pipe.Request(req_id=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        for r in reqs:
            server.enqueue(r)
        assert server.run_until_drained(max_steps=500) < 500
        order = [r.req_id for r in sorted(reqs, key=lambda r: r.done_at)]
        metrics = {k: v for k, v in server.metrics.items() if k != "steps"}
        return [r.output for r in reqs], metrics, order

    want = serve(j_pipe, jm, jp, j_make_device(n_instances=2, policy="least_loaded"))
    got = serve(t_pipe, tm, tp, make_device(n_instances=2, policy="least_loaded", device="cpu"))
    assert got == want
    assert all(len(o) == 6 for o in got[0])
