"""The port's training path (repro_torch.models loss, launch.steps
make_train_step and launch.train, data.pipeline, distributed.fault) against
the JAX package's on tinyllama-1.1b.reduced() in f32 (4 layers, d_model 128,
4 heads, 2 KV heads, head_dim 32, vocab 512).  Parameters and AdamW state go
across with ``params_from_numpy`` / ``opt_state_from_numpy``; batches come
from ``SyntheticLMDataset`` (numpy, the same in both packages).

Tolerances: the loss, its gradients and one step's parameters and moments
rtol 1e-5, with an atol of 1e-5 times the leaf's largest magnitude (an
entry far below the leaf's scale, such as an embedding row's gradient
from one token, carries the rounding of the sums that make the large
ones): the same f32 arithmetic with sums in another order.  Flash attention's gradients
atol = rtol = 2e-4, the JAX package's own tolerance for its custom VJP.
Dataset batches are bit for bit.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import pipeline as j_data
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.models.api import build_model as j_build
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import tree as ttree
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import pipeline as t_data
from repro_torch.distributed.fault import (
    Heartbeat,
    HeartbeatMonitor,
    RestartPolicy,
    StragglerDetector,
    run_with_restarts,
)
from repro_torch.launch import steps as TS
from repro_torch.launch import train as t_train
from repro_torch.models import layers as TL
from repro_torch.models.api import build_model, opt_state_from_numpy, params_from_numpy
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.gradients import GradAccumulator

RTOL = 1e-5
FLASH_TOL = dict(rtol=2e-4, atol=2e-4)
B, S = 2, 32


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, **tol):
    """rtol 1e-5, atol 1e-5 of ``want``'s largest magnitude (or ``tol``)."""
    w = np32(want)
    scale = float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(np32(got), w, **(tol or dict(rtol=RTOL, atol=RTOL * scale)))


def close_trees(got, want, **tol):
    gl, wl = ttree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        close(g, w, **tol)


def _cfgs():
    return (dataclasses.replace(j_get_config("tinyllama-1.1b").reduced(), dtype="float32"),
            dataclasses.replace(get_config("tinyllama-1.1b").reduced(), dtype="float32"))


@pytest.fixture(scope="module")
def ref():
    """The JAX model, parameters, AdamW state after one step (so the moments
    are not zero), a batch, and the JAX loss/grad and train step, jitted
    once for the module."""
    jcfg, cfg = _cfgs()
    jm = j_build(jcfg, remat=False)
    jp = jm.init(jax.random.key(0))
    jopt = JAdamW(lr=1e-3)
    jstep = jax.jit(JS.make_train_step(jm, jopt))
    ds = j_data.SyntheticLMDataset(jcfg, B, S, seed=1)
    batches = [{k: jnp.asarray(v) for k, v in ds.batch_at(i).items()} for i in range(2)]
    jp, jo, _ = jstep(jp, jopt.init(jp), batches[0])
    vg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, jp=jp, jo=jo, jopt=jopt, jstep=jstep,
                batch=batches[1], vg=vg)


def t_params(ref):
    return params_from_numpy(jax.tree.map(np.asarray, ref["jp"]), device="cpu")


def t_batch(jbatch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in jbatch.items()}


# --------------------------------------------------------------------------- layers
def test_cross_entropy_value_and_grad_match_the_reference(rng):
    logits = rng.normal(size=(2, 5, 17)).astype(np.float32) * 3
    labels = rng.integers(0, 17, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    jv, jg = jax.value_and_grad(JL.cross_entropy)(jnp.asarray(logits), jnp.asarray(labels),
                                                  jnp.asarray(mask))
    x = torch.from_numpy(logits).requires_grad_()
    tv = TL.cross_entropy(x, torch.from_numpy(labels), torch.from_numpy(mask))
    tv.backward()
    close(tv, jv)
    close(x.grad, jg)
    empty = TL.cross_entropy(x, torch.from_numpy(labels), torch.zeros(2, 5))
    assert float(empty.detach()) == 0.0  # an all-masked batch divides by 1, not 0


FLASH_CASES = [  # (Sq, Skv, H, KV, hd, causal, window)
    (128, 128, 4, 2, 32, True, 0),
    (64, 64, 4, 4, 32, False, 0),
    (96, 96, 4, 1, 64, True, 24),
]


def _qkv(rng, Sq, Skv, H, KV, hd):
    return (rng.normal(size=(1, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(1, Skv, KV, hd)).astype(np.float32),
            rng.normal(size=(1, Skv, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("how", ["backward", "torch.func.grad"])
def test_flash_gradients_match_the_references_custom_vjp(rng, case, how):
    """attention_trainable(impl="flash") under .backward() and under
    torch.func.grad: against the JAX package's custom VJP (the Pallas
    kernel in interpret mode forward, the chunked path backward) and the
    port's own chunked attention."""
    Sq, Skv, H, KV, hd, causal, window = case
    q, k, v = _qkv(rng, Sq, Skv, H, KV, hd)
    w = rng.normal(size=(1, Sq, H, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window)

    def jloss(q, k, v):
        return jnp.sum(JL.attention_trainable(q, k, v, impl="flash", **kw) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tw = torch.from_numpy(w)

    def tloss(q, k, v, impl="flash"):
        if impl == "flash":
            return torch.sum(TL.attention_trainable(q, k, v, impl="flash", **kw) * tw)
        return torch.sum(TL.attention(q, k, v, **kw) * tw)

    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    if how == "backward":
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        tloss(*leaves).backward()
        got = [t.grad for t in leaves]
    else:
        got = torch.func.grad(tloss, argnums=(0, 1, 2))(tq, tk, tv)
    plain = torch.func.grad(lambda *a: tloss(*a, impl="chunked"), argnums=(0, 1, 2))(tq, tk, tv)
    for g, wnt, p in zip(got, want, plain):
        np.testing.assert_allclose(np32(g), np32(wnt), **FLASH_TOL)
        np.testing.assert_allclose(np32(g), np32(p), **FLASH_TOL)


# --------------------------------------------------------------------------- model loss
@pytest.mark.parametrize("impl,remat,group", [("chunked", False, 1), ("flash", False, 1),
                                              ("flash", True, 1), ("chunked", True, 2)])
def test_loss_and_grads_match_the_reference(ref, impl, remat, group):
    """DecoderModel.loss and its gradients, with and without per-layer
    (and per-group) activation checkpointing, against the JAX model."""
    (jl, jaux), jg = ref["vg"](ref["jp"], ref["batch"])
    tm = build_model(ref["cfg"], remat=remat, remat_group=group, attn_impl=impl, device="cpu")
    tl, tmetrics, tg = GradAccumulator.accumulate(tm.loss, t_params(ref), t_batch(ref["batch"]),
                                                  1)
    close(tl, jl)
    close(tmetrics["ce"], jaux["ce"])
    assert float(tmetrics["aux"]) == 0.0
    close_trees(tg, jg)


def test_chunked_ce_matches_one_pass_and_the_reference(ref):
    """More than one chunk (target_tokens < B * S): the checkpointed chunk
    loop gives the one-pass CE, value and gradients, as the reference's."""
    from repro.models.decoder import _chunked_ce as j_ce
    from repro_torch.models.decoder import _chunked_ce as t_ce

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 8)).astype(np.float32)
    w = rng.normal(size=(8, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) > 0.2).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda x, w: j_ce(x, w, False, labels, mask, target_tokens=8),
                                argnums=(0, 1))(x, w)
    for target in (8, 16384):
        tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
        tv = t_ce(tx, tw, False, torch.from_numpy(labels), torch.from_numpy(mask),
                  target_tokens=target)
        tv.backward()
        close(tv, jv)
        close(tx.grad, jg[0])
        close(tw.grad, jg[1])


# --------------------------------------------------------------------------- train step
def test_one_train_step_matches_the_reference(ref):
    """One make_train_step step from the same parameters and (non-zero)
    AdamW moments: new parameters, moments, step and metrics."""
    jp, jo, jm = ref["jstep"](ref["jp"], ref["jo"], ref["batch"])
    tm = build_model(ref["cfg"], remat=True, attn_impl="flash", device="cpu")
    to = opt_state_from_numpy(jax.tree.map(np.asarray, ref["jo"]), device="cpu")
    close_trees(to.m, ref["jo"].m, rtol=0, atol=0)  # carried across exactly
    step = TS.make_train_step(tm, AdamW(lr=1e-3))
    tp, to, tmetrics = step(t_params(ref), to, t_batch(ref["batch"]))
    close_trees(tp, jp)
    close_trees(to.m, jo.m)
    close_trees(to.v, jo.v)
    assert int(to.step) == int(jo.step) == 2
    for k in ("loss", "grad_norm", "ce"):
        close(tmetrics[k], jm[k])


def test_grad_shardings_need_a_mesh(ref):
    """ZeRO-2's ``grad_shardings`` (the name is kept from when it raised
    without a mesh): on the one-rank host mesh, with the moments' specs,
    the step takes the gradients onto the moments' layout and gives the
    step without it; the parameters and moments keep their layout."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import rules_for_mesh, use_rules
    from repro_torch.distributed.params import opt_state_shardings, tree_shardings
    from repro_torch.distributed.sharding import place
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device="cpu")
    rules = rules_for_mesh(mesh)
    tm = build_model(ref["cfg"], mesh=mesh, remat=False, device="cpu")
    params, batch = t_params(ref), t_batch(ref["batch"])
    opt = AdamW()
    want_p, want_o, want_m = TS.make_train_step(tm, opt)(params, opt.init(params), batch)
    with use_rules(mesh, rules):
        pp = ttree.tree_map(place, params, tree_shardings(params, mesh, rules))
        osh = opt_state_shardings(None, params, mesh, rules)
        oo = ttree.tree_map(place, opt.init(params), osh)
        got_p, got_o, got_m = TS.make_train_step(tm, opt, grad_shardings=osh.m)(pp, oo, batch)
    assert all(isinstance(t, DTensor) for t in ttree.leaves(got_p) + ttree.leaves(got_o.m))
    for g, w in zip(ttree.leaves(got_p), ttree.leaves(want_p)):
        assert torch.equal(g.full_tensor(), w)
    for g, w in zip(ttree.leaves(got_o.m), ttree.leaves(want_o.m)):
        assert torch.equal(g.full_tensor(), w)
    assert float(got_m["loss"]) == float(want_m["loss"])


def test_grad_accumulation_consistency(ref):
    """micro_steps=2 ~= micro_steps=1 on the same batch (fp32 accumulation),
    the reference test's bounds, and micro_steps=2 against the JAX package's
    own accumulation."""
    from repro.optim.gradients import GradAccumulator as JGA

    tm = build_model(ref["cfg"], remat=False, device="cpu")
    params, batch = t_params(ref), t_batch(ref["batch"])
    l1, _, g1 = GradAccumulator.accumulate(tm.loss, params, batch, 1)
    l2, m2, g2 = GradAccumulator.accumulate(tm.loss, params, batch, 2)
    assert abs(float(l1) - float(l2)) < 0.05
    n1 = float(torch.sqrt(sum(torch.sum(a.float() ** 2) for a in ttree.leaves(g1))))
    n2 = float(torch.sqrt(sum(torch.sum(a.float() ** 2) for a in ttree.leaves(g2))))
    assert abs(n1 - n2) / max(n1, 1e-6) < 0.1
    jl2, _, jg2 = JGA.accumulate(ref["jm"].loss, ref["jp"], ref["batch"], 2)
    close(l2, jl2)
    close_trees(g2, jg2)


# --------------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (12, 1000)])
def test_dataset_batches_are_the_references_bit_for_bit(seed, step):
    jcfg, cfg = _cfgs()
    want = j_data.SyntheticLMDataset(jcfg, 4, 48, seed=seed).batch_at(step)
    got = t_data.SyntheticLMDataset(cfg, 4, 48, seed=seed).batch_at(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_data_pipeline_deterministic():
    cfg = get_config("tinyllama-1.1b").reduced()
    ds = t_data.SyntheticLMDataset(cfg, batch=4, seq_len=32, seed=3)
    a, b, c = ds.batch_at(7), ds.batch_at(7), ds.batch_at(8)
    assert (a["tokens"] == b["tokens"]).all()
    assert (a["tokens"] != c["tokens"]).any()


def test_prefetcher_orders_steps():
    cfg = get_config("tinyllama-1.1b").reduced()
    ds = t_data.SyntheticLMDataset(cfg, batch=2, seq_len=16)
    pf = t_data.Prefetcher(ds, start_step=5, depth=2, device="cpu")
    try:
        got = [next(pf) for _ in range(4)]
    finally:
        pf.stop()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    for s, batch in got:
        assert batch["tokens"].dtype == torch.int32
        assert batch["loss_mask"].dtype == torch.float32
        np.testing.assert_array_equal(batch["tokens"].numpy(), ds.batch_at(s)["tokens"])


def test_prefetcher_means_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = t_data.SyntheticLMDataset(get_config("tinyllama-1.1b").reduced(), 2, 16)
    with pytest.raises(RuntimeError):
        t_data.Prefetcher(ds)


# --------------------------------------------------------------------------- training
def test_loss_decreases_short_training():
    """8 steps on learnable synthetic data: the loss falls, as in the
    reference's test_loss_decreases_short_training."""
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg, remat=False, attn_impl="flash", device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = AdamW(lr=5e-3)
    opt_state = opt.init(params)
    ds = t_data.SyntheticLMDataset(cfg, batch=8, seq_len=64)
    step = TS.make_train_step(model, opt)
    losses = []
    for i in range(8):
        b = {k: torch.from_numpy(v) for k, v in ds.batch_at(i).items()}
        params, opt_state, m = step(params, opt_state, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.05, losses


def test_train_checkpoint_crash_resume(tmp_path):
    """The reference's fault-tolerance loop on the port: training state
    after a crash + restore continues bit-compatibly from the checkpoint
    (kernel CRCs on a CPU Device)."""
    from repro_torch.core import make_device

    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg, remat=False, device="cpu")
    opt = AdamW(lr=1e-3)
    step_fn = TS.make_train_step(model, opt)
    ds = t_data.SyntheticLMDataset(cfg, batch=4, seq_len=32)
    ckpt = CheckpointManager(CheckpointConfig(directory=str(tmp_path), async_save=False,
                                              crc_impl="kernel"),
                             device=make_device(device="cpu"))

    def batch(i):
        return {k: torch.from_numpy(v) for k, v in ds.batch_at(i).items()}

    params = model.init(torch.Generator().manual_seed(0))
    opt_state = opt.init(params)
    for i in range(4):
        params, opt_state, _ = step_fn(params, opt_state, batch(i))
        if i == 1:
            ckpt.save(2, {"params": params, "opt": opt_state})

    step, tree = ckpt.restore(treedef_like={"params": params, "opt": opt_state})
    assert step == 2
    p2, o2 = tree["params"], tree["opt"]
    for i in range(2, 4):
        p2, o2, _ = step_fn(p2, o2, batch(i))
    for a, b in zip(ttree.leaves(params), ttree.leaves(p2)):
        np.testing.assert_allclose(np32(a), np32(b), rtol=1e-5, atol=1e-6)


def _train_args(tmp_path, name, **kw):
    args = argparse.Namespace(
        arch="tinyllama-1.1b", reduced=True, steps=6, batch=2, seq=32, lr=1e-3,
        micro_steps=1, seed=0, ckpt_dir=str(tmp_path / name), ckpt_every=2, full_every=2,
        replicas=1, log_every=100, no_remat=False, instances=2, policy="round_robin",
        crc_impl="zlib", device="cpu", layers=2)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


class InjectedFailure(RuntimeError):
    """A failure injected into launch/train.py's loop."""


def _restarts(out: str) -> list:
    return [line for line in out.splitlines() if line.startswith("[fault] restarting")]


def test_train_driver_resumes_after_an_injected_crash(tmp_path, capsys, monkeypatch):
    """launch/train.py's train(): a crash after step 4's save restarts from
    step 4 through run_with_restarts and ends where an uninterrupted run
    ends, with a restorable step-6 checkpoint whose CRCs are zlib's (host
    CRCs here: the kernel CRC's plain version takes tens of seconds a save
    on the CPU; test_train_checkpoint_crash_resume covers it).  The crash
    comes from the caller: the driver's checkpoint manager raises once,
    after its save of step 4 has landed.  run_with_restarts retries any
    failure, so the whole run must log no restart and the crashed run
    exactly the injected one."""
    import json
    import zlib

    assert t_train.train(_train_args(tmp_path, "whole")) == 6
    assert _restarts(capsys.readouterr().out) == []

    crashed_at = []

    class CrashingManager(CheckpointManager):
        def save(self, step, tree, **kw):
            super().save(step, tree, **kw)
            if step == 4 and not crashed_at:
                crashed_at.append(step)
                self.wait()
                raise InjectedFailure(f"injected failure after step {step}'s save")

    monkeypatch.setattr(t_train, "CheckpointManager", CrashingManager)
    assert t_train.train(_train_args(tmp_path, "crash")) == 6
    out = capsys.readouterr().out
    restarts = _restarts(out)
    assert crashed_at == [4] and len(restarts) == 1
    assert restarts[0].startswith("[fault] restarting from step 4 after InjectedFailure")
    assert "resumed from step 4" in out

    def final(name):
        m = CheckpointManager(CheckpointConfig(directory=str(tmp_path / name)))
        return m.restore()

    (sw, whole), (sc, crashed) = final("whole"), final("crash")
    assert sw == sc == 6 and sorted(whole) == sorted(crashed)
    for k in whole:
        np.testing.assert_allclose(np32(crashed[k]), np32(whole[k]), rtol=1e-5, atol=1e-6)
    manifest = json.loads((tmp_path / "crash" / "step_00000006" / "manifest.json").read_text())
    for key, entry in manifest["leaves"].items():
        if entry["mode"] == "full":
            data = (tmp_path / "crash" / "step_00000006"
                    / f"{key.replace('/', '__')}.bin").read_bytes()
            assert entry["crc"] == zlib.crc32(data)


def test_the_train_e2e_example_flow_runs_on_the_port(tmp_path):
    """examples/train_e2e.py's namespace (micro_steps=2, replicas=2, no
    device, CRC or crash fields) through the port's train(), on the CPU
    and cut to 4 steps of 4 x 16 tokens."""
    args = argparse.Namespace(
        arch="tinyllama-1.1b", reduced=True, steps=4, batch=4, seq=16, lr=1e-3,
        micro_steps=2, seed=0, ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2, full_every=4,
        replicas=2, log_every=2, no_remat=False, device="cpu")
    assert t_train.train(args) == 4
    for d in ("ckpt", "ckpt-replica"):
        step, _ = CheckpointManager(CheckpointConfig(directory=str(tmp_path / d))).restore()
        assert step == 4


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_a_second_save_of_one_step_is_lost_in_repro_and_kept_in_the_port(tmp_path, package):
    """Both packages' drivers save the last step again after the loop.  When
    the loop's save of that step was a full snapshot, the JAX package's
    second save is a delta against itself: publishing it deletes the base
    files it points at, and restore falls back to the step before.  The
    port writes the second save as a full snapshot, and the step restores."""
    import importlib

    mgr = importlib.import_module(f"{package}.checkpoint.manager")
    leaf = np.arange(64, dtype=np.float32)
    as_leaf = (jnp.asarray if package == "repro" else torch.from_numpy)
    ckpt = mgr.CheckpointManager(mgr.CheckpointConfig(directory=str(tmp_path), full_every=2,
                                                      async_save=False))
    ckpt.save(4, {"w": as_leaf(leaf)})
    ckpt.save(6, {"w": as_leaf(leaf + 1)})  # delta against step 4
    ckpt.save(8, {"w": as_leaf(leaf + 2)})  # full
    ckpt.save(8, {"w": as_leaf(leaf + 2)})  # repro: a delta against step 8 itself
    step, tree = ckpt.restore()
    if package == "repro":
        assert step == 6
        np.testing.assert_array_equal(np.asarray(tree["w"]), leaf + 1)
    else:
        assert step == 8
        np.testing.assert_array_equal(np.asarray(tree["w"]), leaf + 2)


# --------------------------------------------------------------------------- fault
def test_heartbeat_monitor(tmp_path):
    hb = Heartbeat(str(tmp_path), rank=0)
    hb.beat(5)
    mon = HeartbeatMonitor(str(tmp_path), world_size=2, timeout_s=60)
    assert mon.dead_ranks() == [1]  # rank 1 never beat
    assert not mon.all_alive()
    assert HeartbeatMonitor(str(tmp_path), 1, timeout_s=60).dead_ranks(now=1e18) == [0]


def test_straggler_detector():
    det = StragglerDetector(min_samples=4, z_threshold=2.0)
    for _ in range(10):
        for r in range(7):
            det.record(r, 0.1)
        det.record(7, 0.5)  # rank 7 is slow
    assert det.stragglers() == [7]


def test_run_with_restarts_recovers():
    calls = {"n": 0}
    saved = {"step": 0}

    def train_fn(start):
        calls["n"] += 1
        for i in range(start, 10):
            saved["step"] = i
            if calls["n"] == 1 and i == 4:
                raise RuntimeError("simulated node failure")
        return 10

    final = run_with_restarts(train_fn, lambda: saved["step"],
                              RestartPolicy(backoff_base_s=0.0), sleep=lambda s: None)
    assert final == 10 and calls["n"] == 2


def test_restart_policy_bounds():
    p = RestartPolicy(max_restarts=2, backoff_base_s=0.0)
    assert p.should_restart()
    p.backoff()
    p.backoff()
    assert not p.should_restart()
    with pytest.raises(RuntimeError):
        run_with_restarts(lambda s: (_ for _ in ()).throw(RuntimeError("x")), lambda: None,
                          RestartPolicy(max_restarts=1), sleep=lambda s: None)
