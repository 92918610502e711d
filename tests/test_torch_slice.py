"""The port's offload loop end to end against the JAX package's.

The same flow (the whole quickstart, delta section included, plus copy+CRC,
batch copy into a destination pool, a fused-doorbell burst, the unfused
batch paths, and fill, compare, DIF and cache-flush descriptors) runs on
``repro.core.make_device`` and on
``repro_torch.core.make_device(device="cpu")``, both under the round-robin
policy, from the same numpy inputs.  Every output byte, status and byte
count, the policy's decisions, the engines' counters and the telemetry byte
totals must be identical.  On the reference side ``delta_apply`` runs its
``use_kernel=False`` path: its Pallas kernel cannot run on the installed jax,
and the flow's record leaves word 0 alone, where that path is exact."""
import functools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.kernels.ops as jops
import repro_torch.core as T
from repro.core.telemetry import Telemetry as JTelemetry
from repro_torch.analysis import lockcheck as tlock


def tt(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).view(torch.uint32)
    return torch.from_numpy(a.copy())


def as_bytes(x):
    if isinstance(x, torch.Tensor):
        return (str(x.dtype).split(".")[-1], tuple(x.shape),
                x.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    a = np.asarray(x)
    return str(a.dtype), tuple(a.shape), a.tobytes()


def leaves(x):
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in leaves(v)]
    if isinstance(x, str):
        return [x]
    return [as_bytes(x)]


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(64, 128)).astype(np.float32)
    x2 = x.copy()
    x2[40, 3] += 1
    return {
        "x": x,
        "batch": [np.full((8, 128), i, np.float32) for i in range(8)],
        "src_pool": rng.normal(size=(12, 8, 128)).astype(np.float32),
        "dst_pool": rng.normal(size=(10, 8, 128)).astype(np.float32),
        "si": np.asarray([0, 3, 3, 11, 5], np.int32),
        "di": np.asarray([5, 2, 7, 0, 5], np.int32),
        "burst": [rng.normal(size=(16, 64)).astype(np.float32) for _ in range(32)],
        "words": rng.integers(0, 2**32, 257, dtype=np.uint64).astype(np.uint32),
        "bf16_bits": (rng.normal(size=(40, 10)).astype(np.float32).view(np.uint32)
                      >> 16).astype(np.uint16),
        "ragged": [rng.normal(size=(8 + i, 32)).astype(np.float32) for i in range(3)],
        # the quickstart's delta section: 4096 words, 3 of them changed
        "delta_base": np.random.default_rng(1).integers(0, 2**31, 4096).astype(np.uint32),
        "x2": x2,
    }


def run_flow(c, A, telemetry_cls, **kw):
    """Drive the slice's main path on package ``c``; return everything the
    two packages must agree on."""
    data = inputs()
    device = c.make_device(n_instances=2, policy="round_robin", **kw)
    tel = telemetry_cls(device)
    x = A(data["x"])
    futs = {}
    futs["memcpy"] = device.memcpy_async(x)
    futs["crc32.then"] = device.crc32_async(x).then(lambda v: f"0x{int(v):08x}")
    gate = device.promise()
    futs["fenced"] = device.memcpy_async(x, after=[gate])
    device.kick()
    held = futs["fenced"].done()
    gate.set_result(None)
    futs["batch"] = device.batch_async(
        [c.WorkDescriptor(op=c.OpType.MEMCPY, src=A(b)) for b in data["batch"]])
    futs["copy_crc"] = device.copy_crc_async(x)
    futs["batch_copy"] = device.batch_copy_async(
        A(data["src_pool"]), A(data["dst_pool"]), A(data["si"]), A(data["di"]))
    for i, f in enumerate(device.submit_many(
            [c.WorkDescriptor(op=c.OpType.MEMCPY, src=A(b)) for b in data["burst"]])):
        futs[f"burst{i}"] = f
        f.result()  # the burst fills one WQ: let it drain before the next submit
    words = A(data["words"])  # 257 words: one CRC chain
    futs["crc32_words"] = device.crc32_async(words)
    futs["mixed"] = device.batch_async([
        c.WorkDescriptor(op=c.OpType.MEMCPY, src=words),
        c.WorkDescriptor(op=c.OpType.CRC32, src=words),
        c.WorkDescriptor(op=c.OpType.COPY_CRC, src=x)])
    futs["ragged"] = device.batch_async(
        [c.WorkDescriptor(op=c.OpType.MEMCPY, src=A(r)) for r in data["ragged"]])
    bf16 = (jnp.asarray(data["bf16_bits"]).view(jnp.bfloat16) if c is J else
            torch.from_numpy(data["bf16_bits"].view(np.int16).copy()).view(torch.bfloat16))
    futs["crc32_bf16"] = device.crc32_async(bf16)
    futs["memcpy_bf16"] = device.memcpy_async(bf16)
    # the quickstart's delta section
    base_np = data["delta_base"]
    changed_np = base_np.copy()
    changed_np[[7, 99, 2048]] += 1
    base, changed = A(base_np), A(changed_np)
    futs["delta_create"] = device.delta_create_async(changed, base, cap=64)
    offsets, record, _, _ = futs["delta_create"].result()
    futs["delta_apply"] = device.delta_apply_async(base, offsets, record)
    futs["delta_overflow"] = device.delta_create_async(changed, base, cap=2)
    # fill, compare, DIF and cache-flush descriptors
    futs["fill"] = device.fill_async(A(np.asarray([1, 0x80000002], np.uint32)), 1000)
    futs["fill4"] = device.fill_async(A(np.asarray([5, 6, 7, 8], np.uint32)), 64)
    futs["compare_eq"] = device.compare_async(x, A(data["x"]))
    futs["compare_ne"] = device.compare_async(x, A(data["x2"]))
    futs["dif_insert"] = device.dif_insert_async(base)
    framed = futs["dif_insert"].result()
    futs["dif_check"] = device.dif_check_async(framed)
    futs["dif_strip"] = device.dif_strip_async(framed)
    futs["cache_flush"] = device.submit(c.WorkDescriptor(op=c.OpType.CACHE_FLUSH, src=base))
    results = {k: f.result() for k, f in futs.items()}
    device.drain()
    snap = tel.snapshot()
    out = {
        "held": held,
        "results": {k: leaves(v) for k, v in results.items()},
        "status": {k: f.status.name for k, f in futs.items()},
        "bytes": {k: f.record.bytes_processed for k, f in futs.items() if k != "crc32.then"},
        "ops": {k: f.op for k, f in futs.items()},
        "decisions": dict(device.policy_stats["decisions"]),
        "decisions_by_op": dict(device.policy_stats["decisions_by_op"]),
        "desclint_warnings": device.policy_stats["desclint_warnings"],
        "counters": {e.name: {k: e.counters_snapshot()[k] for k in
                              ("completed", "bytes", "submitted", "fused_batches",
                               "fused_descs")} for e in device.engines},
        "telemetry": {name: {op: (o["count"], o["bytes"]) for op, o in e["ops"].items()}
                      for name, e in snap["engines"].items()},
        "telemetry_wqs": {name: {w: (v["submitted"], v["dispatched"], v["completed"], v["bytes"])
                                 for w, v in e["wqs"].items()}
                          for name, e in snap["engines"].items()},
        "nodes": {n: (v["local_ops"], v["local_bytes"], v["cross_bytes"])
                  for n, v in snap["nodes"].items()},
    }
    return out


@pytest.fixture(scope="module")
def flows():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "delta_apply", functools.partial(jops.delta_apply, use_kernel=False))
        ref = run_flow(J, jnp.asarray, JTelemetry)
    port = run_flow(T, tt, T.Telemetry, device="cpu")
    return ref, port


@pytest.mark.parametrize("key", ["held", "results", "status", "bytes", "ops", "decisions",
                                 "decisions_by_op", "desclint_warnings", "counters",
                                 "telemetry", "telemetry_wqs", "nodes"])
def test_slice_flow_matches_reference(flows, key):
    ref, port = flows
    assert port[key] == ref[key]


def test_slice_flow_is_right(flows):
    _, port = flows
    data = inputs()
    assert not port["held"]
    assert set(port["status"].values()) == {"SUCCESS"}
    want = f"0x{zlib.crc32(data['x'].tobytes()) & 0xFFFFFFFF:08x}"
    assert port["results"]["crc32.then"] == [want]
    assert port["results"]["memcpy"] == [as_bytes(data["x"])]
    assert set(port["decisions"]) == {"dsa0", "dsa1"}
    # one fused doorbell: the submit_many burst of 32
    assert port["counters"]["dsa0"]["fused_batches"] + port["counters"]["dsa1"][
        "fused_batches"] == 1
    # one warning, DESC105 on the deliberately ragged copy batch; the fill,
    # compare, delta and DIF descriptors add none
    assert port["desclint_warnings"] == 1
    # the delta round trip restores the changed words; the cap-2 record
    # overflows with the true count
    changed = data["delta_base"].copy()
    changed[[7, 99, 2048]] += 1
    assert port["results"]["delta_apply"] == [as_bytes(changed)]
    count, overflow = port["results"]["delta_overflow"][2:]
    assert count[2] == np.int32(3).tobytes() and overflow[2] == b"\x01"
    assert port["results"]["compare_eq"][0][2] == b"\x01"
    assert port["results"]["compare_ne"][1][2] == np.int32(40 * 128 + 3).tobytes()
    assert port["results"]["dif_check"] == [as_bytes(np.ones(32, bool))]


def test_batch_fusion_rule(monkeypatch):
    """F2: a batch of same-shape copies is ONE batch_copy; a mixed, ragged
    or cache-hint-mixed batch runs per descriptor."""
    from repro_torch.kernels import ops

    calls = []
    real = ops.batch_copy
    monkeypatch.setattr(ops, "batch_copy", lambda *a: calls.append(1) or real(*a))
    device = T.make_device(device="cpu")
    md = lambda t, **kw: T.WorkDescriptor(op=T.OpType.MEMCPY, src=t, **kw)  # noqa: E731
    same = [torch.full((8, 128), float(i)) for i in range(8)]
    outs = device.batch_async([md(t) for t in same]).result()
    assert len(calls) == 1 and all(torch.equal(o, t) for o, t in zip(outs, same))
    for batch in ([md(torch.zeros(8, 128)), md(torch.zeros(4, 128))],
                  [md(torch.zeros(8, 128)), T.WorkDescriptor(op=T.OpType.CRC32,
                                                             src=torch.zeros(8, 128))],
                  [md(torch.zeros(8, 128)), md(torch.zeros(8, 128),
                                               cache_hint=T.CacheHint.TO_CACHE)]):
        device.batch_async(batch).result()
    assert len(calls) == 1


@pytest.mark.parametrize("op", [T.OpType.FILL_VERIFY, T.OpType.COMPARE_PATTERN,
                                T.OpType.DUALCAST], ids=lambda o: o.value)
def test_unported_op_resolves_error(op):
    """The three ops that earlier slices of the port refused (resolving
    Status.ERROR) now run: SUCCESS, no error text, the right result."""
    device = T.make_device(device="cpu")
    words = torch.arange(256, dtype=torch.int32)
    pat = torch.tensor([7], dtype=torch.int32)
    operands = {
        T.OpType.FILL_VERIFY: {"pattern": pat, "n_words": 64},
        T.OpType.COMPARE_PATTERN: {"src": words, "pattern": pat},
        T.OpType.DUALCAST: {"src": words},
    }[op]
    fut = device.submit(T.WorkDescriptor(op=op, **operands))
    device.drain()
    assert fut.status == T.Status.SUCCESS and fut.error is None
    out = fut.result()
    if op == T.OpType.FILL_VERIFY:
        filled, (ok, first) = out
        assert filled.view(torch.int32).tolist() == [7] * 64 and bool(ok) and int(first) == -1
    elif op == T.OpType.COMPARE_PATTERN:
        assert not bool(out[0]) and int(out[1]) == 0  # word 0 is 0, not 7
    else:
        assert all(torch.equal(o, words) for o in out)
    assert device.policy_stats["desclint_warnings"] == 0


def test_operand_on_another_device_is_an_error():
    device = T.make_device(device="cpu")
    fut = device.memcpy_async(torch.zeros(16, device="meta"))
    device.drain()
    assert fut.status == T.Status.ERROR and "runs on cpu" in fut.error


@pytest.mark.parametrize("op,name", [("compare", "src2"), ("delta_create", "src2"),
                                     ("delta_apply", "src_idx"), ("delta_apply", "src2")])
def test_second_operands_on_another_device_are_an_error(op, name):
    """src2 and src_idx are checked like src: the engine's own message, not
    a failure inside the kernel layer."""
    device = T.make_device(device="cpu")
    words = torch.arange(64, dtype=torch.int32).view(torch.uint32)
    off = torch.tensor([1, 2], dtype=torch.int32)
    operands = {"compare": dict(src=words, src2=words.clone()),
                "delta_create": dict(src=words, src2=words.clone(), cap=4),
                "delta_apply": dict(src=words, src_idx=off, src2=words[:2].clone())}[op]
    operands[name] = operands[name].to("meta")
    fut = device.submit(T.WorkDescriptor(op=T.OpType(op), **operands))
    device.drain()
    assert fut.status == T.Status.ERROR
    assert f"operand {name!r} is on meta" in fut.error and "runs on cpu" in fut.error


@pytest.mark.parametrize("pat", [7, [7], (7, 8), torch.tensor([7, 8, 9, 10], dtype=torch.int32)],
                         ids=["int", "list", "tuple", "tensor"])
def test_fill_pattern_is_an_immediate(pat):
    """The pattern may be ints, a list or a tensor on any device the host can
    read; the buffer goes on the engine's device."""
    device = T.make_device(device="cpu")
    got = device.fill_async(pat, 10).result()
    assert got.dtype == torch.uint32 and got.device.type == "cpu"
    p = [pat] if isinstance(pat, int) else list(map(int, pat))
    assert got.view(torch.int32).tolist() == [p[i % len(p)] for i in range(10)]


def test_tracing_is_not_ported_yet():
    """make_device(trace=True) builds a tracer that samples every
    submission (tests/test_torch_trace.py tests the tracer).  The name
    dates from when trace= raised."""
    device = T.make_device(device="cpu", trace=True)
    assert device.tracer is not None and device.tracer.config.rate == 1.0


def test_slice_flow_takes_locks_in_one_order(monkeypatch):
    """The port's engine, queues, completion sets and device take their
    locks from its own lockcheck: the whole flow records no hazard."""
    detector = tlock.LockCheck(enabled=True)
    monkeypatch.setattr(tlock, "GLOBAL", detector)
    out = run_flow(T, tt, T.Telemetry, device="cpu")
    assert set(out["status"].values()) == {"SUCCESS"}
    assert detector.edges(), "no instrumented lock was taken"
    assert detector.violations == [], detector.report()
