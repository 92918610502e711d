"""The port's serving stack (repro_torch.serving) against the JAX package's:
slo and traffic (numpy, equal results), the null decoder, the paged KV pool
(page tables, statistics and pool bytes equal after every move) and the
Vhost-style server on tinyllama-1.1b.reduced() in f32 with
attn_impl="flash" (the Pallas kernel in interpret mode on the JAX side, the
plain version on the port's): the same tokens, counts and completion order.

The port runs on a CPU ``Device`` (``make_device(device="cpu")``), where
every kernel takes its plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import make_device as j_make_device
from repro.core.topology import Topology as JTopology
from repro.models.api import build_model as j_build
from repro.serving import kv_pool as j_kv
from repro.serving import nullmodel as j_null
from repro.serving import pipeline as j_pipe
from repro.serving import slo as j_slo
from repro.serving import traffic as j_traffic
from repro_torch.configs import get_config
from repro_torch.core import make_device
from repro_torch.core.topology import Topology
from repro_torch.kernels import batch_copy as tbatch
from repro_torch.models.api import build_model, params_from_numpy
from repro_torch.serving import kv_pool as t_kv
from repro_torch.serving import nullmodel as t_null
from repro_torch.serving import pipeline as t_pipe
from repro_torch.serving import slo as t_slo
from repro_torch.serving import traffic as t_traffic


def cpu_device(**kw):
    return make_device(device="cpu", **kw)


# --------------------------------------------------------------------------- slo
def test_percentile_and_latency_tracker_match_the_reference(rng):
    vals = list(rng.exponential(size=37))
    for p in (0, 1, 50, 90, 99, 100):
        assert t_slo.percentile(vals, p) == j_slo.percentile(vals, p)
    jt = j_slo.LatencyTracker(j_slo.DEFAULT_SLO_CLASSES)
    tt = t_slo.LatencyTracker(t_slo.DEFAULT_SLO_CLASSES)
    for i in range(40):
        cls = ("latency", "bulk")[i % 2]
        a = float(rng.uniform(0, 5))
        ft = a + float(rng.exponential(0.05))
        args = (cls, a, ft, ft + float(rng.exponential(0.5)))
        jt.record(*args)
        tt.record(*args)
    assert tt.summary() == jt.summary()
    assert [tt.within_slo(c) for c in tt.classes] == [jt.within_slo(c) for c in jt.classes]


def test_admission_controller_makes_the_references_decisions(rng):
    ja = j_slo.AdmissionController(j_slo.DEFAULT_SLO_CLASSES, queue_watermark=8)
    ta = t_slo.AdmissionController(t_slo.DEFAULT_SLO_CLASSES, queue_watermark=8)
    for _ in range(200):
        cls = ("latency", "bulk")[int(rng.integers(2))]
        if rng.random() < 0.2:
            assert ta.on_backpressure(cls) == ja.on_backpressure(cls)
        else:
            depth = int(rng.integers(0, 12))
            assert ta.admit(cls, depth) == ja.admit(cls, depth)
    assert ta.counters == ja.counters and ta.totals() == ja.totals()
    assert ta.closes() and ja.closes()


# --------------------------------------------------------------------------- traffic
@pytest.mark.parametrize("kind", ["poisson", "bursty", "diurnal"])
def test_traffic_traces_are_the_references(kind):
    def gen(mod):
        arrivals = {
            "poisson": lambda: mod.PoissonArrivals(80.0, seed=3),
            "bursty": lambda: mod.BurstyArrivals(200.0, 10.0, seed=3),
            "diurnal": lambda: mod.DiurnalArrivals(120.0, 20.0, period_s=2.0, seed=3),
        }[kind]()
        return mod.TrafficGenerator(arrivals, prompt_lengths=mod.ZipfLengths(s=1.2, lo=8, hi=64),
                                    output_lengths=mod.ZipfLengths(s=1.2, lo=2, hi=16),
                                    class_mix={"latency": 0.25, "bulk": 0.75}, seed=3)

    jg, tg = gen(j_traffic), gen(t_traffic)
    jtr, ttr = jg.trace(3.0), tg.trace(3.0)
    assert len(ttr) == len(jtr) > 0
    assert [dataclasses.astuple(e) for e in ttr] == [dataclasses.astuple(e) for e in jtr]
    assert tg.offered_rps() == jg.offered_rps()
    for je, te in zip(jtr[:5], ttr[:5]):
        jr, tr = je.materialize(97), te.materialize(97)
        assert isinstance(tr, t_pipe.Request)
        assert np.array_equal(tr.prompt, jr.prompt) and tr.prompt.dtype == jr.prompt.dtype
        assert (tr.req_id, tr.slo, tr.max_new_tokens, tr.arrival_s) == (
            jr.req_id, jr.slo, jr.max_new_tokens, jr.arrival_s)
    z_j, z_t = j_traffic.ZipfLengths(1.1, 1, 100), t_traffic.ZipfLengths(1.1, 1, 100)
    assert np.array_equal(z_t.pmf(), z_j.pmf()) and z_t.mean() == z_j.mean()


# --------------------------------------------------------------------------- null decoder
def test_null_decoder_matches_the_reference():
    jm, tm = j_null.NullDecoder(64), t_null.NullDecoder(64, device="cpu")
    toks = np.array([[3, 63], [5, 9]], np.int32)
    jc, jl, jlen = jm.prefill({}, {"tokens": jnp.asarray(toks)}, 16)
    tc, tl, tlen = tm.prefill({}, {"tokens": torch.from_numpy(toks)}, 16)
    assert np.array_equal(tl.numpy(), np.asarray(jl)) and tlen.tolist() == np.asarray(jlen).tolist()
    jl2, jc2 = jm.decode_step({}, jc, jnp.asarray(toks[:, :1]))
    tl2, tc2 = tm.decode_step({}, tc, torch.from_numpy(toks[:, :1].copy()))
    assert np.array_equal(tl2.numpy(), np.asarray(jl2))
    assert tc2["lengths"].tolist() == np.asarray(jc2["lengths"]).tolist()
    assert tm.init_cache(3, 8)["segments"][0]["state"].shape == (1, 3, 1)
    with pytest.raises(ValueError):
        t_null.NullDecoder(1, device="cpu")


# --------------------------------------------------------------------------- paged KV pool
def _pool_state(pool):
    def bits(t):
        if isinstance(t, torch.Tensor):
            return t.contiguous().view(torch.uint8).numpy().tobytes()
        return np.asarray(t).tobytes()

    return (dataclasses.astuple(pool.stats), {k: list(v) for k, v in pool.page_table.items()},
            [bits(p) for p in pool.device_pools], bits(pool.host_pool),
            [list(f) for f in pool._free_device], list(pool._free_host))


@pytest.mark.parametrize("n_nodes", [1, 2])
def test_paged_pool_moves_match_the_reference(rng, n_nodes):
    """alloc, write, swap out, swap in (pinned and greedy), free, capacity
    refusals: the page tables, free lists, statistics and every pool byte
    equal the reference's after each call."""
    jd = j_make_device(topology=JTopology.symmetric(n_nodes, 1))
    td = cpu_device(topology=Topology.symmetric(n_nodes, 1))
    kw = dict(n_device_pages=9, n_host_pages=6, page_tokens=4, kv_dim=16)
    jp = j_kv.PagedKVPool(**kw, device=jd)
    tp = t_kv.PagedKVPool(**kw, device=td)
    assert _pool_state(tp) == _pool_state(jp)

    def both(name, *args, **kwargs):
        r_j = getattr(jp, name)(*args, **kwargs)
        r_t = getattr(tp, name)(*args, **kwargs)
        assert r_t == r_j, name
        assert _pool_state(tp) == _pool_state(jp), name

    both("alloc", 1, 3)
    both("alloc", 2, 4, node=n_nodes - 1) if n_nodes > 1 else both("alloc", 2, 4)
    for seq, n in ((1, 3), (2, 4)):
        for i in range(n):
            page = rng.normal(size=(4, 16)).astype(np.float32)
            jp.write_page(seq, i, jnp.asarray(page, jnp.bfloat16))
            tp.write_page(seq, i, torch.from_numpy(page).to(torch.bfloat16))
    assert _pool_state(tp) == _pool_state(jp)
    assert np.array_equal(tp.read_pages(2).float().numpy(),
                          np.asarray(jp.read_pages(2), np.float32))
    both("swap_out", 1)
    both("swap_out", 2)  # host holds 6: 3 + 4 does not fit
    both("alloc", 3, 6)
    both("swap_in", 1)
    both("free", 3)
    both("swap_out", 2)
    both("swap_in", 2, node=0)
    both("free", 1)
    both("free", 2)
    assert tp.stats.device_pages_used == 0 and tp.stats.copy_fallbacks == 0


def test_paged_pool_fallback_copies_through_the_batch_copy_path(monkeypatch):
    """When the engine path fails, the pool counts a fallback and copies
    synchronously through kernels.ops.batch_copy: on a CUDA pool that is
    the CUDA kernel, here its plain version."""
    td = cpu_device()
    pool = t_kv.PagedKVPool(4, 4, 2, 8, device=td)
    monkeypatch.setattr(td, "batch_copy_async", lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("engine down")))
    calls = []
    real = tbatch.batch_copy_pages

    def spy(*a):
        calls.append(a[0].device.type)
        return real(*a)

    monkeypatch.setattr(t_kv.kops._bc, "batch_copy_pages", spy)
    assert pool.alloc(1, 2)
    pool.write_page(1, 0, torch.ones(2, 8))
    assert pool.swap_out(1)
    assert pool.stats.copy_fallbacks == 1 and calls == ["cpu"]
    assert torch.equal(pool.read_pages(1)[:2].float(), torch.ones(2, 8))


# --------------------------------------------------------------------------- server
def test_reorder_array_commits_in_order():
    class Rec:
        done = False

        def is_done(self):
            return self.done

    ra = t_pipe.ReorderArray()
    recs = [Rec() for _ in range(4)]
    for i, r in enumerate(recs):
        ra.push(i, r, payload=i)
    recs[1].done = recs[3].done = True
    assert ra.pop_completed() == []
    recs[0].done = True
    assert [t for t, _ in ra.pop_completed()] == [0, 1]
    recs[2].done = True
    assert [t for t, _ in ra.pop_completed()] == [2, 3] and len(ra) == 0


def test_splice_cache_writes_one_row_in_place():
    batch = {"segments": [{"k": torch.zeros(2, 3, 4), "v": torch.zeros(2, 3, 4)}],
             "lengths": torch.zeros(3, dtype=torch.int32)}
    one = {"segments": [{"k": torch.ones(2, 1, 4), "v": torch.full((2, 1, 4), 2.0)}],
           "lengths": torch.tensor([5], dtype=torch.int32)}
    k = batch["segments"][0]["k"]
    out = t_pipe._splice_cache(batch, one, 1)
    assert out["segments"][0]["k"] is k
    assert torch.equal(k[:, 1], torch.ones(2, 4)) and k[:, [0, 2]].abs().sum() == 0
    assert torch.equal(out["segments"][0]["v"][:, 1], torch.full((2, 4), 2.0))
    assert out["lengths"].tolist() == [0, 5, 0]


LENS = (16, 40, 24, 64, 32, 48)


def test_vhost_server_matches_the_reference(rng):
    """Six requests through three slots with attn_impl="flash": each
    request's tokens, the metrics' counts and the completion order equal
    the JAX server's.  ``steps`` is left out: it counts loop iterations,
    which depend on when each copy's completion is observed (the reference
    runs its copies in interpret mode and admits a step later)."""
    jcfg = dataclasses.replace(j_get_config("tinyllama-1.1b").reduced(), dtype="float32")
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(), dtype="float32")
    jm = j_build(jcfg, remat=False, attn_impl="flash")
    jp = jm.init(jax.random.key(0))
    tm = build_model(cfg, remat=False, attn_impl="flash", device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in LENS]

    def serve(pipe, model, params, device):
        server = pipe.VhostStyleServer(model, params, slots=3, max_cache_len=96, device=device)
        reqs = [pipe.Request(req_id=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
        for r in reqs:
            server.enqueue(r)
        steps = server.run_until_drained(max_steps=500)
        assert steps < 500
        order = [r.req_id for r in sorted(reqs, key=lambda r: r.done_at)]
        metrics = {k: v for k, v in server.metrics.items() if k != "steps"}
        return [r.output for r in reqs], metrics, order

    want = serve(j_pipe, jm, jp, j_make_device(n_instances=2, policy="least_loaded"))
    got = serve(t_pipe, tm, tp, cpu_device(n_instances=2, policy="least_loaded"))
    assert got == want
    outputs, metrics, _ = got
    assert all(len(o) == 4 for o in outputs)
    assert metrics["completed"] == metrics["copy_bursts"] == len(LENS)
    assert metrics["decoded_tokens"] == 3 * len(LENS)


def test_open_loop_null_server_conserves_and_leaks_no_pages():
    """The reference's overload soak, shortened, on the port: the traffic
    matches the reference's, the ledger closes, every KV page comes home."""
    def traffic(mod):
        return mod.TrafficGenerator(
            mod.PoissonArrivals(150.0, seed=7),
            prompt_lengths=mod.ZipfLengths(s=1.2, lo=8, hi=64),
            output_lengths=mod.ZipfLengths(s=1.2, lo=2, hi=16),
            class_mix={"latency": 0.25, "bulk": 0.75}, seed=7)

    td = cpu_device(wq_configs=list(t_pipe.SERVING_WQ_CONFIGS))
    pool = t_kv.PagedKVPool(n_device_pages=64, n_host_pages=4, page_tokens=32, kv_dim=8,
                            device=td)
    adm = t_slo.AdmissionController(t_slo.DEFAULT_SLO_CLASSES, queue_watermark=24)
    server = t_pipe.VhostStyleServer(t_null.NullDecoder(64, device="cpu"), {}, slots=4,
                                     max_cache_len=128, device=td, kv_pool=pool,
                                     admission=adm,
                                     tracker=t_slo.LatencyTracker(t_slo.DEFAULT_SLO_CLASSES))
    report = server.run_open_loop(traffic(t_traffic), horizon_s=2.0, step_s=0.02,
                                  vocab_size=64)
    assert report["generated"] == len(traffic(j_traffic).trace(2.0))
    assert report["in_flight"] == 0
    assert report["admitted"] + report["shed"] == report["generated"]
    assert report["admitted"] == report["completed"] > 0
    assert pool.stats.device_pages_used == 0 and not pool.page_table
    assert adm.closes()
