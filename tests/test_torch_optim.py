"""The port's optimizer package (repro_torch.optim) against the JAX package's.

The same inputs, made with numpy from a seed, go through ``repro.optim`` and
``repro_torch.optim``.  Tolerances: fp32 values agree to rtol 1e-6 / atol
1e-7 (the two frameworks' ``pow``, ``cos`` and reductions may round a last
bit differently); bf16 parameters are equal after the cast; integer work
(steps, int8 codes) is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro.optim import adamw as jadamw
from repro.optim import gradients as jgrad
from repro_torch import optim as topt_pkg
from repro_torch import tree as ttree
from repro_torch.core.perfmodel import DEFAULT_MODEL
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import gradients as tgrad
from repro_torch.optim import offload as toff

RTOL, ATOL = 1e-6, 1e-7


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.detach().numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def pair(a: np.ndarray, dtype: str):
    """(jax array, torch tensor) of ``a`` cast to ``dtype`` the same way."""
    if dtype == "bfloat16":
        j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
        bits = np.asarray(j).view(np.uint16)
        return j, torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    return jnp.asarray(a, jnp.float32), torch.from_numpy(a.astype(np.float32))


def from_jax(a) -> torch.Tensor:
    """A torch tensor with the bits and dtype of the jax array ``a``."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a).copy())


def close(t, j, dtype="float32"):
    a, b = to_np(t), to_np(j)
    assert a.shape == b.shape
    if dtype == "bfloat16":
        assert (a == b).all()
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def params_pair(rng, dtype):
    shapes = {"w": (16, 8), "b": (8,), "blocks": [(4, 4), (6,)]}
    j, t = {}, {}
    for k in ("w", "b"):
        j[k], t[k] = pair(rng.normal(size=shapes[k]), dtype)
    j["blocks"], t["blocks"] = zip(*(pair(rng.normal(size=s), dtype) for s in shapes["blocks"]))
    j["blocks"], t["blocks"] = list(j["blocks"]), list(t["blocks"])
    return j, t


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_adamw_three_steps_match_reference(rng, dtype, schedule):
    if schedule == "cosine":
        jo = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-2, warmup=2, total=10))
        to = tadamw.AdamW(lr=tadamw.cosine_schedule(1e-2, warmup=2, total=10))
    else:
        jo, to = jadamw.AdamW(lr=3e-3), tadamw.AdamW(lr=3e-3)
    jp, tp = params_pair(rng, dtype)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(3):
        grads = jax.tree.map(lambda p: rng.normal(size=p.shape) * 0.1, jp)
        jg = jax.tree.map(lambda g, p: jnp.asarray(g, jnp.float32).astype(p.dtype), grads, jp)
        tg = ttree.unflatten(ttree.flatten(tp)[1], [from_jax(g) for g in jax.tree.leaves(jg)])
        jp, js = jo.update(jg, js, jp)
        tp, ts = to.update(tg, ts, tp)
    assert int(ts.step) == int(js.step) == 3 and ts.step.dtype == torch.int32
    for t, j in zip(ttree.leaves(tp), jax.tree.leaves(jp)):
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        close(t, j, dtype)
    for t, j in zip(ttree.leaves((ts.m, ts.v)), jax.tree.leaves((js.m, js.v))):
        assert t.dtype == torch.float32
        close(t, j)


def test_cosine_schedule_matches_reference():
    j = jadamw.cosine_schedule(3e-4, warmup=20, total=100)
    t = tadamw.cosine_schedule(3e-4, warmup=20, total=100)
    for s in (0, 1, 19, 20, 21, 60, 99, 100, 150):
        close(t(torch.tensor(s, dtype=torch.int32)), j(jnp.asarray(s, jnp.int32)))


@pytest.mark.parametrize("max_norm", [0.5, 1e6], ids=["clips", "keeps"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_clip_by_global_norm_matches_reference(rng, max_norm, dtype):
    jg, tg = params_pair(rng, dtype)
    jc, jn = jgrad.clip_by_global_norm(jg, max_norm)
    tc, tn = tgrad.clip_by_global_norm(tg, max_norm)
    close(tn, jn)
    for t, j in zip(ttree.leaves(tc), jax.tree.leaves(jc)):
        close(t, j, dtype)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 250.0])
def test_compress_int8_round_trip_matches_reference(rng, scale):
    g = (rng.normal(size=(64, 33)) * scale).astype(np.float32)
    jq, js = jgrad.compress_int8(jnp.asarray(g))
    tq, ts = tgrad.compress_int8(torch.from_numpy(g))
    assert tq.dtype == torch.int8 and (to_np(tq) == to_np(jq)).all()
    close(ts, js)
    close(tgrad.decompress_int8(tq, ts, torch.float32),
          jgrad.decompress_int8(jq, js, jnp.float32))
    back = tgrad.decompress_int8(tq, ts, torch.float32)
    assert float((back - torch.from_numpy(g)).abs().max()) <= float(ts) / 2 * (1 + 1e-6)


def _batch(rng):
    x = rng.normal(size=(8, 4)).astype(np.float32)
    y = rng.normal(size=(8, 1)).astype(np.float32)
    pos = rng.normal(size=(3, 8)).astype(np.float32)  # batch on axis 1
    return {"x": x, "y": y, "positions_thw": pos}


def _jax_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = jnp.mean((pred - batch["y"]) ** 2) + 0.01 * jnp.mean(batch["positions_thw"]) * jnp.sum(params["w"])
    return loss, {"ce": loss}


def _torch_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = (torch.mean((pred - batch["y"]) ** 2)
            + 0.01 * torch.mean(batch["positions_thw"]) * torch.sum(params["w"]))
    return loss, {"ce": loss}


@pytest.mark.parametrize("n", [1, 2])
def test_grad_accumulator_matches_reference(rng, n):
    w = rng.normal(size=(4, 1)).astype(np.float32)
    b = rng.normal(size=(1,)).astype(np.float32)
    batch = _batch(rng)
    jl, jm, jg = jgrad.GradAccumulator.accumulate(
        _jax_loss, {"w": jnp.asarray(w), "b": jnp.asarray(b)},
        {k: jnp.asarray(v) for k, v in batch.items()}, n)
    tl, tm, tg = tgrad.GradAccumulator.accumulate(
        _torch_loss, {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
        {k: torch.from_numpy(v) for k, v in batch.items()}, n)
    close(tl, jl)
    close(tm["ce"], jm["ce"])
    assert sorted(tm) == sorted(jm)
    for k in ("w", "b"):
        assert tg[k].dtype == torch.float32
        close(tg[k], jg[k])


def test_optim_exports_match_reference():
    import repro.optim as jopt

    assert topt_pkg.__all__ == jopt.__all__


def _moment_state(rng):
    params = {"w": torch.from_numpy(rng.normal(size=(128, 64)).astype(np.float32)).to(torch.bfloat16),
              "b": torch.zeros(64, dtype=torch.bfloat16)}
    st = tadamw.AdamW().init(params)
    return st._replace(m=ttree.tree_map(lambda x: x + 1.5, st.m))


def test_plan_follows_the_port_model(rng):
    st = _moment_state(rng)
    p = toff.plan(st)
    nbytes = 2 * (128 * 64 + 64) * 4
    want = (DEFAULT_MODEL.op_time(nbytes, async_depth=32, src_tier="hbm", dst_tier="host")
            + DEFAULT_MODEL.op_time(nbytes, async_depth=32, src_tier="host", dst_tier="hbm"))
    assert p.hbm_freed_bytes == nbytes
    assert p.transfer_s_per_step == pytest.approx(want, rel=1e-12) and want > 0
    assert p.profitable_below_step_s == p.transfer_s_per_step
    assert p.hides_under(1.0) and not p.hides_under(0.0)
    assert toff.plan(st, fraction=0.5).hbm_freed_bytes == nbytes // 2


def test_moment_roundtrip_through_engine(rng):
    st = _moment_state(rng)
    device = T.make_device(n_instances=2, policy="least_loaded", device="cpu")
    off = toff.MomentOffloader(device)
    parked = off.offload(st)
    back = off.fetch(parked)
    for a, b in zip(ttree.leaves((st.m, st.v)), ttree.leaves((back.m, back.v))):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert back.step is st.step
    assert off.stats["offloads"] == 1 and off.stats["fetches"] == 1
    assert off.stats["bytes_moved"] == 4 * (128 * 64 + 64) * 4  # m+v, twice
    # each tree is one batch submission: two per move
    assert sum(device.policy_stats["decisions"].values()) == 4


def test_moment_roundtrip_of_a_single_leaf_tree():
    device = T.make_device(device="cpu")
    st = tadamw.AdamW().init({"w": torch.ones(4, 4)})
    st = st._replace(m=ttree.tree_map(lambda x: x + 2, st.m))
    back = toff.MomentOffloader(device).fetch(st)
    assert torch.equal(back.m["w"], st.m["w"]) and torch.equal(back.v["w"], st.v["w"])
