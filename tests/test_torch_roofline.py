"""The port's roofline modules (``repro_torch.roofline``) against the JAX
package's ``repro.roofline``:

* ``roofline_terms`` and ``model_flops_for_cell`` equal the reference's for
  every cell of ``all_cells()`` with the same ``HW`` values (exactly);
* ``collective_bytes_from_log`` equals ``collective_bytes_from_hlo`` on
  synthesized HLO lines: five collectives x g in {1, 2, 4, 16} x {f32,
  bf16} (exactly);
* the op counter: the counterpart of ``test_hlo_cost_counts_loop_trips``
  (a Python loop of 7 ``tanh(c @ w)`` is exactly L * 2 * B * D * D
  forward, its gradient 3x within 5 %, as the reference's test holds), the
  byte rules, and on a 4-rank fake mesh (a subprocess: a process has one
  default group) one rank's 1/4 of a column-sharded matmul and the one
  all-reduce of 2 * 3/4 * 64 * 256 * 4 = 98304 bytes that brings the
  column- then row-parallel pair to ``Replicate``, for DTensor's
  functional collectives and ``dist.all_reduce`` alike;
* FLOPs of reduced tinyllama-1.1b and deepseek-moe-16b train, prefill and
  decode steps against the reference's ``analyze_hlo`` on the one-device
  host mesh: prefill and decode within 2 %, the train step within 5 %;
* ``report.summary`` / ``report.table`` print the reference's lines on the
  same records, apart from the capacity header (80 GB, not 16 GB);
* ``reanalyze`` from saved op logs reproduces a fresh ``dryrun_cell``.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import all_cells
from repro.configs import get_config as j_get_config
from repro.configs.base import SHAPES_BY_NAME as J_SHAPES
from repro.roofline import analysis as janalysis
from repro.roofline import report as jreport
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import SHAPES_BY_NAME as T_SHAPES
from repro_torch.configs.base import ShapeConfig
from repro_torch.roofline import H100, analysis, report
from repro_torch.roofline.op_cost import OpCounter, analyze_log, op_bytes, top_sites

SRC = str(Path(__file__).resolve().parent.parent / "src")
J_H100 = janalysis.HW(peak_flops=H100.peak_flops, hbm_bw=H100.hbm_bw, ici_bw=H100.ici_bw,
                      hbm_bytes=H100.hbm_bytes, vmem_bytes=H100.vmem_bytes,
                      launch_overhead_s=H100.launch_overhead_s)


# --------------------------------------------------------------------------- analysis.py
def test_h100_constants():
    assert (H100.peak_flops, H100.hbm_bw, H100.ici_bw, H100.hbm_bytes) == (
        989e12, 3.35e12, 50e9, 80e9)
    assert H100.vmem_bytes == 50 * 2 ** 20 and H100.launch_overhead_s == 33.2e-6
    assert not hasattr(analysis, "V5E")


@pytest.mark.parametrize("arch,shape_name", all_cells())
def test_terms_and_model_flops_equal_the_references(arch, shape_name):
    jc, tc = j_get_config(arch), t_get_config(arch)
    js, ts = J_SHAPES[shape_name], T_SHAPES[shape_name]
    mf = analysis.model_flops_for_cell(tc, ts, ts.kind)
    assert mf == janalysis.model_flops_for_cell(jc, js, js.kind)
    # a step's terms from numbers of its size: compute-, memory- and
    # collective-bound in turn
    for flops, byts, coll in ((mf / 256, mf / 2560, 1e6), (mf / 1e6, mf / 256, 1e3),
                              (1e9, 1e6, mf / 256)):
        assert analysis.roofline_terms(flops, byts, coll) == janalysis.roofline_terms(
            flops, byts, coll, hw=J_H100)


COLLECTIVE_HLO = {"all-gather": "all-gather", "all-reduce": "all-reduce",
                  "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
                  "collective-permute": "collective-permute"}


@pytest.mark.parametrize("dtype,itemsize", [("f32", 4), ("bf16", 2)])
@pytest.mark.parametrize("g", [1, 2, 4, 16])
@pytest.mark.parametrize("op", list(COLLECTIVE_HLO))
def test_collective_bytes_from_log_equal_the_hlo_walk(op, g, dtype, itemsize):
    groups = "{{" + ",".join(str(i) for i in range(g)) + "}}"
    hlo = "\n".join([
        f"  %c0 = {dtype}[64,256]{{1,0}} {op}({dtype}[64,256]{{1,0}} %p0), "
        f"replica_groups={groups}",
        f"  %c1 = {dtype}[8,128,4]{{2,1,0}} {op}({dtype}[8,128,4]{{2,1,0}} %p1), "
        f"replica_groups={groups}",
    ])
    log = [{"op": "x", "collective": op, "group": g, "result_bytes": 64 * 256 * itemsize},
           {"op": "x", "collective": op, "group": g, "result_bytes": 8 * 128 * 4 * itemsize}]
    assert analysis.collective_bytes_from_log(log) == janalysis.collective_bytes_from_hlo(hlo)


# --------------------------------------------------------------------------- op_cost.py
def test_counts_loop_trips():
    """Counterpart of ``test_hlo_cost_counts_loop_trips``: the reference's
    scan of 7 ``tanh(c @ w)`` bodies, as the Python loop eager PyTorch
    runs."""
    L, B, D = 7, 32, 64
    ws = torch.zeros(L, D, D, requires_grad=True)
    x = torch.zeros(B, D)

    def f(ws, x):
        c = x
        for i in range(L):
            c = torch.tanh(c @ ws[i])
        return c.sum()

    with torch.no_grad(), OpCounter() as fwd:
        f(ws, x)
    assert analyze_log(fwd.records).flops == L * 2 * B * D * D
    with OpCounter() as grad:
        torch.autograd.grad(f(ws, x), ws)
    assert analyze_log(grad.records).flops == pytest.approx(3 * L * 2 * B * D * D, rel=0.05)
    # identical ops at one site are one record with their count
    mm = [r for r in fwd.records if r["op"] == "aten.mm.default"]
    assert len(mm) == 1 and mm[0]["n"] == L
    (top,) = top_sites(fwd.records, "dot", 1)
    assert top[:4] == (L * 2 * B * D * D, L, 2 * B * D * D, "aten.mm.default")


def test_byte_rules():
    x = torch.zeros(64, 32)
    idx = torch.arange(8)
    upd = torch.ones(8, 32)
    with OpCounter() as c:
        x.t()  # a view: free
        x + 1  # reads x, writes a result of its size
        x.index_select(0, idx)  # a gather: 2x the result
        x.index_put_((idx,), upd)  # an update in place: 2x the update
        torch.empty(64, 32).copy_(x)  # reads the source, writes the destination
        x.zero_()  # writes only
    by_op = {r["op"].split(".")[1]: op_bytes(r) for r in c.records}
    n = 64 * 32 * 4
    assert by_op["t"] == 0 and by_op["empty"] == 0
    assert by_op["add"] == 2 * n
    assert by_op["index_select"] == 2 * (8 * 32 * 4)
    assert by_op["index_put_"] == 2 * (8 * 32 * 4)
    assert by_op["copy_"] == 2 * n and by_op["zero_"] == n


def test_peak_bytes_follow_the_live_storages():
    with OpCounter() as c:
        a = torch.zeros(1024)  # 4 KiB
        b = a + 1  # 8 KiB live
        del a
        d = b * 2  # a freed: 8 KiB live again
        del b, d
    assert c.peak_bytes == 8192 and c.live_bytes == 0


_MESH_SCRIPT = r"""
import json
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.dryrun import fake_world
from repro_torch.roofline.op_cost import OpCounter, analyze_log

fake_world(4)
mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
out = {}
with FakeTensorMode():
    w = DTensor.from_local(torch.empty(256, 128), mesh, [Shard(1)], run_check=False)
    x = DTensor.from_local(torch.empty(64, 256), mesh, [Replicate()], run_check=False)
    with OpCounter() as col:
        h = x @ w  # column-parallel
    with OpCounter() as pair:
        h = x @ w
        y = (h @ w.T).redistribute(mesh, [Replicate()])  # row-parallel, summed
    with OpCounter() as raw:
        t = torch.empty(64, 256)
        dist.all_reduce(t, group=mesh.get_group("model"))
for name, c in (("column", col), ("pair", pair), ("raw", raw)):
    cost = analyze_log(c.records)
    out[name] = {"flops": cost.flops, "coll_bytes": cost.coll_bytes,
                 "coll_ops": {k: dict(v) for k, v in cost.coll_ops.items()},
                 "collectives": [r["op"] for r in c.records if r.get("collective")]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_mesh_counts():
    res = subprocess.run([sys.executable, "-c", _MESH_SCRIPT],
                         env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_a_column_sharded_matmul_counts_one_ranks_quarter(fake_mesh_counts):
    assert fake_mesh_counts["column"]["flops"] == 2 * 64 * 256 * 512 / 4
    assert fake_mesh_counts["column"]["coll_bytes"] == 0


def test_the_row_parallel_sum_is_one_all_reduce_of_98304_bytes(fake_mesh_counts):
    pair = fake_mesh_counts["pair"]
    assert pair["flops"] == 2 * (2 * 64 * 256 * 512) / 4
    assert pair["collectives"] == ["_c10d_functional.all_reduce.default"]
    assert pair["coll_ops"] == {"all-reduce": {"count": 1, "bytes": 98304.0}}
    assert pair["coll_bytes"] == 2 * 3 / 4 * 64 * 256 * 4 == 98304


def test_a_raw_all_reduce_is_counted_from_its_process_group(fake_mesh_counts):
    raw = fake_mesh_counts["raw"]
    assert raw["collectives"] == ["c10d.allreduce_.default"]
    assert raw["coll_ops"] == {"all-reduce": {"count": 1, "bytes": 98304.0}}


# --------------------------------------------------------------------------- FLOPs against analyze_hlo
PARITY = [(arch, kind) for arch in ("tinyllama-1.1b", "deepseek-moe-16b")
          for kind in ("train", "prefill", "decode")]
#: relative tolerance on total FLOPs: the reference counts XLA's optimized
#: HLO, the port what eager PyTorch dispatches (its remat replay included)
PARITY_RTOL = {"train": 0.05, "prefill": 0.02, "decode": 0.02}
B, S, CACHE = 4, 64, 64


def _reference_flops(arch, kind):
    from repro.distributed.annotate import use_rules
    from repro.distributed.params import tree_shardings
    from repro.distributed.sharding import rules_for_mesh
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import make_decode_step, make_prefill_step, make_train_step
    from repro.models.api import build_model
    from repro.optim.adamw import AdamW
    from repro.roofline.hlo_cost import analyze_hlo

    mesh = make_host_mesh()
    rules = rules_for_mesh(mesh)
    cfg = j_get_config(arch).reduced()
    model = build_model(cfg, mesh=mesh)
    p_abs = jax.eval_shape(model.init, jax.random.key(0))
    p_in = jax.tree.map(lambda a, s: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=s),
                        p_abs, tree_shardings(p_abs, mesh, rules))
    toks = jax.ShapeDtypeStruct((B, S if kind != "decode" else 1), jnp.int32)
    with mesh, use_rules(mesh, rules):
        if kind == "train":
            opt = AdamW()
            batch = {"tokens": toks, "loss_mask": jax.ShapeDtypeStruct((B, S), jnp.float32)}
            lowered = jax.jit(make_train_step(model, opt)).lower(
                p_in, jax.eval_shape(opt.init, p_abs), batch)
        elif kind == "prefill":
            lowered = jax.jit(make_prefill_step(model, max_cache_len=S)).lower(
                p_in, {"tokens": toks})
        else:
            cache = jax.eval_shape(lambda: model.init_cache(B, CACHE))
            lowered = jax.jit(make_decode_step(model)).lower(p_in, cache, toks)
    return analyze_hlo(lowered.compile().as_text()).flops


@pytest.fixture(scope="module")
def host_mesh():
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(device="cpu")


@pytest.mark.parametrize("arch,kind", PARITY)
def test_step_flops_match_the_reference_hlo_walk(arch, kind, host_mesh):
    from repro_torch.launch.dryrun import lower_cell

    shape = ShapeConfig("parity", S if kind != "decode" else CACHE, B, kind)
    counter, _ = lower_cell(arch, "parity", host_mesh, cfg=t_get_config(arch).reduced(),
                            shape=shape)
    got = analyze_log(counter.records).flops
    want = _reference_flops(arch, kind)
    assert got == pytest.approx(want, rel=PARITY_RTOL[kind]), (got, want, got / want)


# --------------------------------------------------------------------------- report.py
def _records():
    def ok(arch, shape, mesh, b, u, h, fits):
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok", "bottleneck": b,
                "compute_s": 1.5, "memory_s": 2.5e-3, "collective_s": 7e-6,
                "useful_flops_ratio": u, "hbm_per_dev_gb": h, "fits_hbm": fits}

    return [ok("tinyllama-1.1b", "train_4k", "single", "compute", 0.31, 11.8, True),
            ok("tinyllama-1.1b", "decode_32k", "single", "memory", 0.9, 0.6, True),
            ok("deepseek-67b", "train_4k", "multi", "collective", 0.05, 95.2, False),
            ok("mamba2-370m", "prefill_32k", "multi", "memory", 0.6, 3.0, True),
            ok("gemma3-1b", "train_4k", "single", "compute", 0.7, 20.0, True),
            {"arch": "llama4-maverick-400b-a17b", "shape": "long_500k", "mesh": "single",
             "status": "skip", "reason": "pure full-attention arch"},
            {"arch": "hymba-1.5b", "shape": "train_4k", "mesh": "multi", "status": "error",
             "reason": "RuntimeError: " + "x" * 100}]


def test_report_prints_the_references_lines():
    recs = _records()
    assert report.summary(recs) == jreport.summary(recs)
    for mesh in ("single", "multi"):
        got, want = report.table(recs, mesh).splitlines(), jreport.table(recs, mesh).splitlines()
        assert got[2] == want[2].replace("fits 16GB", "fits 80GB")
        assert got[:2] + got[3:] == want[:2] + want[3:]


# --------------------------------------------------------------------------- reanalyze.py
def test_reanalyze_from_saved_op_logs_reproduces_a_fresh_cell(tmp_path, host_mesh):
    from repro_torch.launch.dryrun import dryrun_cell
    from repro_torch.roofline.reanalyze import reanalyze

    cfg = t_get_config("tinyllama-1.1b").reduced()
    rec = dryrun_cell("tinyllama-1.1b", "train_4k", False, save_ops=str(tmp_path / "ops"),
                      mesh=host_mesh, cfg=cfg, shape=ShapeConfig("train_4k", 32, 2, "train"))
    assert rec["status"] == "ok", rec.get("traceback")
    (tmp_path / "dry").mkdir()
    path = tmp_path / "dry" / "single__tinyllama-1.1b__train_4k.json"
    stale = dict(rec, flops_per_dev=0.0, bytes_per_dev=0.0, collective_bytes_per_dev=1.0,
                 compute_s=0.0, memory_s=0.0, bottleneck="?", useful_flops_ratio=0.0)
    path.write_text(json.dumps(stale))
    assert reanalyze(tmp_path / "ops", tmp_path / "dry") == 1
    again = json.loads(path.read_text())
    for key in ("flops_per_dev", "bytes_per_dev", "collective_bytes_per_dev", "collective_ops",
                "compute_s", "memory_s", "collective_s", "bottleneck",
                "roofline_fraction_compute", "useful_flops_ratio"):
        assert again[key] == rec[key], key
