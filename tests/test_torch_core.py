"""The port's engine core (repro_torch.core, repro_torch.analysis) against
the JAX package's: descriptor sizes, desclint codes, work queues and the
priority arbiter, topology, the performance model's mechanism, the lock
detector, and the port's import rules."""
import ast
import copy
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as J
import repro_torch.core as T
from repro.analysis import desclint as jlint
from repro.analysis import lockcheck as jlock
from repro.core import perfmodel as jperf
from repro_torch.analysis import desclint as tlint
from repro_torch.analysis import lockcheck as tlock
from repro_torch.core import perfmodel as tperf

SRC = Path(__file__).resolve().parent.parent / "src"


def tt(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a torch tensor with the same bits and dtype."""
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).view(torch.uint32)
    return torch.from_numpy(a.copy())


# Each case builds one descriptor from (core module, array constructor), so
# both packages see the same operands.
def _wd(c, **kw):
    return c.WorkDescriptor(**kw)


class Duck:
    size = 64
    shape = (64,)


CASES = {
    "memcpy_f32": lambda c, A: _wd(c, op=c.OpType.MEMCPY, src=A(np.zeros((8, 128), np.float32))),
    "memcpy_u8": lambda c, A: _wd(c, op=c.OpType.MEMCPY, src=A(np.zeros(100, np.uint8))),
    "memcpy_empty": lambda c, A: _wd(c, op=c.OpType.MEMCPY, src=A(np.zeros(0, np.float32))),
    "memcpy_duck": lambda c, A: _wd(c, op=c.OpType.MEMCPY, src=Duck()),
    "crc32_u32": lambda c, A: _wd(c, op=c.OpType.CRC32, src=A(np.zeros(77, np.uint32))),
    "copy_crc_i32": lambda c, A: _wd(c, op=c.OpType.COPY_CRC, src=A(np.zeros((3, 5), np.int32))),
    "fill_missing": lambda c, A: _wd(c, op=c.OpType.FILL, n_words=0),
    "fill_ok": lambda c, A: _wd(c, op=c.OpType.FILL, pattern=A(np.asarray([7], np.uint32)),
                                n_words=10),
    "compare_shape": lambda c, A: _wd(c, op=c.OpType.COMPARE, src=A(np.zeros(64, np.float32)),
                                      src2=A(np.zeros(32, np.float32))),
    "compare_dtype": lambda c, A: _wd(c, op=c.OpType.COMPARE, src=A(np.zeros(64, np.float32)),
                                      src2=A(np.zeros(64, np.int32))),
    "delta_mismatch": lambda c, A: _wd(c, op=c.OpType.DELTA_CREATE,
                                       src=A(np.zeros(64, np.uint32)),
                                       src2=A(np.zeros(128, np.uint32)), cap=16),
    "delta_cap0": lambda c, A: _wd(c, op=c.OpType.DELTA_CREATE, src=A(np.zeros(64, np.uint32)),
                                   src2=A(np.zeros(64, np.uint32)), cap=0),
    "delta_no_ref": lambda c, A: _wd(c, op=c.OpType.DELTA_CREATE,
                                     src=A(np.zeros(64, np.uint32)), cap=16),
    "delta_apply_len": lambda c, A: _wd(c, op=c.OpType.DELTA_APPLY,
                                        src=A(np.zeros(64, np.uint32)),
                                        src_idx=A(np.zeros(4, np.int32)),
                                        src2=A(np.zeros(3, np.uint32))),
    "dif_float": lambda c, A: _wd(c, op=c.OpType.DIF_INSERT, src=A(np.zeros(256, np.float32))),
    "dif_2d": lambda c, A: _wd(c, op=c.OpType.DIF_INSERT, src=A(np.zeros((2, 128), np.uint32))),
    "dif_check_flat": lambda c, A: _wd(c, op=c.OpType.DIF_CHECK, src=A(np.zeros(130, np.uint32))),
    "dif_i32_ok": lambda c, A: _wd(c, op=c.OpType.DIF_INSERT, src=A(np.zeros(256, np.int32))),
    "batch_copy_idx": lambda c, A: _wd(c, op=c.OpType.BATCH_COPY,
                                       src=A(np.zeros((8, 32), np.float32)),
                                       dst_pool=A(np.zeros((8, 32), np.float32)),
                                       src_idx=A(np.arange(4, dtype=np.int32)),
                                       dst_idx=A(np.arange(3, dtype=np.int32))),
    "batch_copy_no_dst": lambda c, A: _wd(c, op=c.OpType.BATCH_COPY,
                                          src=A(np.zeros((8, 32), np.float32)),
                                          src_idx=A(np.arange(4, dtype=np.int32)),
                                          dst_idx=A(np.arange(4, dtype=np.int32))),
    "batch_copy_2d_idx": lambda c, A: _wd(c, op=c.OpType.BATCH_COPY,
                                          src=A(np.zeros((8, 32), np.float32)),
                                          dst_pool=A(np.zeros((8, 32), np.float32)),
                                          src_idx=A(np.zeros((2, 2), np.int32)),
                                          dst_idx=A(np.zeros((2, 2), np.int32))),
    "batch_copy_pages": lambda c, A: _wd(c, op=c.OpType.BATCH_COPY,
                                         src=A(np.zeros((8, 32), np.float32)),
                                         dst_pool=A(np.zeros((8, 16), np.float32)),
                                         src_idx=A(np.arange(2, dtype=np.int32)),
                                         dst_idx=A(np.arange(2, dtype=np.int32))),
    "batch_copy_empty": lambda c, A: _wd(c, op=c.OpType.BATCH_COPY,
                                         src=A(np.zeros((0, 16), np.float32)),
                                         dst_pool=A(np.zeros((4, 16), np.float32)),
                                         src_idx=A(np.arange(0, dtype=np.int32)),
                                         dst_idx=A(np.arange(0, dtype=np.int32))),
    "batch_copy_no_idx": lambda c, A: _wd(c, op=c.OpType.BATCH_COPY,
                                          src=A(np.zeros((4, 16), np.float32))),
    "batch_copy_ok": lambda c, A: _wd(c, op=c.OpType.BATCH_COPY,
                                      src=A(np.zeros((4, 16), np.float32)),
                                      dst_pool=A(np.zeros((4, 16), np.float32)),
                                      src_idx=A(np.arange(2, dtype=np.int32)),
                                      dst_idx=A(np.arange(2, dtype=np.int32))),
    "batch_mixed": lambda c, A: c.BatchDescriptor(descriptors=[
        _wd(c, op=c.OpType.MEMCPY, src=A(np.zeros((8, 128), np.float32))),
        _wd(c, op=c.OpType.MEMCPY, src=A(np.zeros((4, 128), np.float32))),
        _wd(c, op=c.OpType.MEMCPY, src=A(np.zeros((8, 128), np.float32)),
            cache_hint=c.CacheHint.TO_CACHE)]),
    "batch_same": lambda c, A: c.BatchDescriptor(descriptors=[
        _wd(c, op=c.OpType.MEMCPY, src=A(np.zeros((8, 128), np.float32))) for _ in range(3)]),
    "batch_empty": lambda c, A: c.BatchDescriptor(descriptors=[]),
    "batch_bad_member": lambda c, A: c.BatchDescriptor(descriptors=[
        _wd(c, op=c.OpType.FILL, n_words=0),
        _wd(c, op=c.OpType.MEMCPY, src=A(np.zeros(16, np.float32)))]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_nbytes_and_desclint_codes_match_reference(case):
    jd = CASES[case](J, jnp.asarray)
    td = CASES[case](T, tt)
    assert td.nbytes == jd.nbytes
    codes = lambda diags: sorted((d.code, d.severity) for d in diags)  # noqa: E731
    assert codes(tlint.check(td)) == codes(jlint.check(jd))


def test_torch_dtypes_keep_numpy_kinds():
    kinds = {torch.float32: "f", torch.bfloat16: "f", torch.int32: "i", torch.int8: "i",
             torch.uint32: "u", torch.uint8: "u", torch.bool: "b", torch.complex64: "c"}
    for dt, kind in kinds.items():
        assert tlint._kind(dt) == kind
    assert tlint._word_dtype_ok(torch.zeros(1, dtype=torch.int32))
    assert tlint._word_dtype_ok(torch.zeros(1, dtype=torch.uint32))
    assert not tlint._word_dtype_ok(torch.zeros(1, dtype=torch.float32))
    assert not tlint._word_dtype_ok(torch.zeros(1, dtype=torch.int16))


# --------------------------------------------------------------------------- queues and the arbiter
def _drain_order(c, A, prios, n_each, n_pes=1):
    wqs = [c.WorkQueue(f"w{i}", size=64, priority=p) for i, p in enumerate(prios)]
    g = c.GroupConfig("g0", wqs, n_pes=n_pes)
    kw = {"device": "cpu"} if c is T else {}
    eng = c.StreamEngine(c.DeviceConfig(groups=[g], **kw))
    for _ in range(n_each):
        for w in wqs:
            w.submit(_wd(c, op=c.OpType.MEMCPY, src=A(np.zeros((8, 128), np.float32))))  # dsalint: disable=DSA101,DSA106 — raw WQ submit returns Status
    picks = []
    while True:
        got = eng._arbitrate(g)
        if got is None:
            return picks
        picks.append(got[1].name)


@pytest.mark.parametrize("prios,n_each", [((10, 1), 22), ((15, 4, 1), 12), ((3, 3), 5)])
def test_arbiter_order_matches_reference(prios, n_each):
    want = _drain_order(J, jnp.asarray, prios, n_each)
    assert _drain_order(T, tt, prios, n_each) == want
    assert len(want) == len(prios) * n_each


def test_work_queue_semantics_match_reference():
    def run(c, A):
        d = lambda: _wd(c, op=c.OpType.MEMCPY, src=A(np.zeros((8, 128), np.float32)))  # noqa: E731
        out = []
        q = c.WorkQueue("swq", mode="shared", size=2)
        out += [q.submit(d()).name for _ in range(3)]  # dsalint: disable=DSA101 — raw WQ submit returns Status
        out.append(q.pop() is not None)
        out.append(q.submit(d()).name)  # dsalint: disable=DSA101 — raw WQ submit returns Status
        out.append(q.submit_many([d(), d()]).name)
        dq = c.WorkQueue("dwq", mode="dedicated", size=4, owner="t0")
        out.append(dq.submit(d(), producer="t0").name)  # dsalint: disable=DSA101 — raw WQ submit returns Status
        with pytest.raises(PermissionError):
            dq.submit(d(), producer="t1")  # dsalint: disable=DSA101 — raw WQ submit returns Status
        out.append((len(q), len(dq), q.occupancy, dq.occupancy))
        cfg = c.WQConfig("lat", mode="dedicated", size=16, priority=12, traffic_class="to_cache")
        w = c.WorkQueue.from_config(cfg)
        out.append((w.name, w.mode, w.size, w.priority, w.traffic_class))
        for bad in ({"mode": "hybrid"}, {"priority": 0}, {"priority": 16}, {"size": 0},
                    {"traffic_class": "to_l2"}, {"group": -1}):
            with pytest.raises(ValueError):
                c.WQConfig("bad", **bad)
        return out

    assert run(T, tt) == run(J, jnp.asarray)


# --------------------------------------------------------------------------- topology
def test_topology_matches_reference():
    def run(c):
        topo = c.Topology.symmetric(2, engines_per_node=2)
        out = [topo.n_nodes, topo.engine_nodes(),
               [topo.hops(e, s, d) for e in (0, 1) for s in (0, 1) for d in (0, 1)],
               sorted(topo.link_charge(1, 0, 0)), topo.link_charge(0, 0, 0),
               c.Topology.single_node().link_charge(0, 0, 0),
               c.Topology([c.Node(0, n_engines=2), c.Node(1, n_engines=3)]).engine_nodes()]
        for bad in (lambda: c.Topology([]), lambda: c.Topology([c.Node(0), c.Node(2)]),
                    lambda: c.Node(-1), lambda: c.Node(0, n_engines=0),
                    lambda: c.Link(bw=0), lambda: c.Link(lat_s=-1e-6),
                    lambda: c.Topology.symmetric(0)):
            with pytest.raises(ValueError):
                bad()
        kw = {"device": "cpu"} if c is T else {}
        dev = c.make_device(topology=topo, policy="numa_local", **kw)
        out.append([(e.name, e.node_id) for e in dev.engines])
        out.append([e.name for e in dev.engines_on(1)])
        return out

    assert run(T) == run(J)


def test_numa_local_placement_matches_reference():
    def run(c, A):
        kw = {"device": "cpu"} if c is T else {}
        dev = c.make_device(topology=c.Topology.symmetric(2, engines_per_node=1),
                            policy="numa_local", **kw)
        bufs = [A(np.full((16, 128), i, np.float32)) for i in range(6)]
        for i, b in enumerate(bufs):
            dev.register(b, node=i % 2)
        futs = [dev.memcpy_async(b) for b in bufs]
        futs.append(dev.memcpy_async(A(np.zeros((16, 128), np.float32)), node=1))
        dev.drain()
        return ([f.record.engine_node for f in futs],
                [(f.record.src_node, f.record.link_hops) for f in futs],
                dict(dev.policy_stats["decisions"]))

    assert run(T, tt) == run(J, jnp.asarray)


# --------------------------------------------------------------------------- performance model
SIZES = [64.0, 4096.0, 65536.0, float(1 << 20), float(64 << 20)]


def test_op_time_matches_reference_with_its_constants(monkeypatch):
    """The mechanism is the JAX package's: with its constants and tier table
    injected at run time, every estimate is the same number."""
    monkeypatch.setattr(tperf, "TIERS", copy.deepcopy(jperf.TIERS))
    ref = jperf.DEFAULT_MODEL
    port = tperf.EngineModel(**dataclasses.asdict(ref))
    link = J.Link()
    for nbytes in SIZES:
        for kw in ({}, {"batch_size": 8, "n_pe": 4}, {"async_depth": 16, "n_pe": 2},
                   {"dst_tier": "vmem"}, {"src_tier": "host", "dst_tier": "hbm"},
                   {"src_tier": "hbm", "dst_tier": "remote", "read_factor": 1.5},
                   {"read_factor": 0.5}, {"link": link, "link_hops": 2},
                   {"tiers": {"hbm": {"bw": 1e12, "wr_bw": 5e11, "lat": 1e-6}}}):
            assert port.op_time(nbytes, **kw) == ref.op_time(nbytes, **kw)
            assert port.throughput(nbytes, **kw) == ref.throughput(nbytes, **kw)
        assert port.op_time_default_pes(nbytes) == ref.op_time_default_pes(nbytes)
        assert port.sw_time(nbytes, dst_tier="host") == ref.sw_time(nbytes, dst_tier="host")
        assert port.speedup(nbytes, n_pe=4) == ref.speedup(nbytes, n_pe=4)
    assert port.crossover_bytes() == ref.crossover_bytes()
    assert port.crossover_bytes(async_depth=8) == ref.crossover_bytes(async_depth=8)


def test_card_constants_replace_the_reference_ones():
    """No constant of the JAX package's device model survives in the port;
    the host-side costs are the paper's and stay."""
    ref = dataclasses.asdict(jperf.DEFAULT_MODEL)
    port = dataclasses.asdict(tperf.DEFAULT_MODEL)
    paper = {"submit_overhead_s", "enqcmd_overhead_s", "completion_poll_s", "pause_poll_s",
             "umwait_wake_s", "irq_cost_s", "max_pes"}
    for name, value in port.items():
        if name in paper:
            assert value == ref[name], name
        else:
            assert value != ref[name], name
    for tier in jperf.TIERS:
        assert tperf.TIERS[tier]["bw"] != jperf.TIERS[tier]["bw"], tier


@settings(max_examples=30, deadline=None)
@given(st.integers(6, 30), st.integers(1, 64), st.integers(1, 4), st.integers(1, 32))
def test_perfmodel_monotonicity_with_card_constants(log2_bytes, batch, n_pe, depth):
    """The invariants of the paper's figures hold for the card's constants:
    batching, PEs and async depth never lower throughput, and throughput
    never exceeds the measured copy rate."""
    m = tperf.DEFAULT_MODEL
    nbytes = float(2 ** log2_bytes)
    t = m.throughput(nbytes, batch_size=batch, n_pe=n_pe, async_depth=depth)
    assert t <= m.pe_peak_bw + 1e-6
    assert m.throughput(nbytes, batch_size=batch + 1, n_pe=n_pe, async_depth=depth) >= t * 0.5
    assert m.throughput(nbytes, batch_size=batch, n_pe=n_pe, async_depth=depth + 1) >= t - 1e-9
    assert m.throughput(nbytes, batch_size=batch, n_pe=min(n_pe + 1, 4),
                        async_depth=depth) >= t - 1e-9


def test_remote_placement_is_slower_at_every_size():
    topo = T.Topology.symmetric(2)
    m = tperf.DEFAULT_MODEL
    for size in SIZES:
        local = m.op_time(size)
        one_hop = m.op_time(size, **topo.link_charge(0, 1, 0))
        two_hop = m.op_time(size, **topo.link_charge(1, 0, 0))
        assert two_hop > one_hop > local


# --------------------------------------------------------------------------- lock detector
def test_lockcheck_matches_reference():
    def run(mod):
        lc = mod.LockCheck()
        a, b, c = lc.lock("A"), lc.lock("B"), lc.rlock("C")
        with a, b:
            pass
        with b, a:  # inversion: a cycle
            pass
        with c, c:  # reentrant: fine
            pass
        with a:
            with lc.notify_region("cb"):  # notifying with a lock held
                pass
        return [v.kind for v in lc.violations], {k: sorted(v) for k, v in lc.edges().items()}

    assert run(tlock) == run(jlock)
    assert run(tlock)[0]  # the hazards were found


# --------------------------------------------------------------------------- device selection and import rules
def test_make_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.make_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.make_device(device="cuda")
    with pytest.raises(ValueError):
        T.make_device(device="meta")
    assert T.make_device(device="cpu").engines[0].device == torch.device("cpu")


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), f"{f}: imports {name}"


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "import repro_torch, repro_torch.core, repro_torch.kernels.ops, "
            "repro_torch.analysis.desclint, repro_torch.calibrate; "
            "d = repro_torch.core.make_device(device='cpu'); "
            "import torch; x = torch.arange(64.0); "
            "assert torch.equal(d.memcpy_async(x).result(), x); "
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
