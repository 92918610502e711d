"""The port's loop-aware count (``repro_torch.roofline.op_cost.counted_range``
under ``OpCounter(loops="once")``, the counterpart of ``hlo_cost``'s
trip-count walk) against the count that runs every trip (``loops="all"``):

* ``counted_range`` is ``range`` with no counter and under a full counter,
  and hands back what it is given; nested counted loops multiply; a
  stacked 7-layer ``tanh(c @ w[i])`` with its backward counts the same
  both ways;
* a reduced model of each family the loops touch, on a (2, 2) ("data",
  "model") mesh of the fake process group (a subprocess per family, all at
  once: a process has one default group): dense (tinyllama), gemma3 (two
  periods and a trailing unroll), deepseek-moe (its lead layer and the MoE
  scan), llama4 (periods of a dense and an MoE layer), mamba2, hymba (a
  scanned run of locals among unrolled globals and a short local run) and
  seamless (4 encoder layers, the first peeled: its input needs no
  gradient), each train step with 1 and 2 micro-steps, prefill and decode:
  FLOPs, bytes, collective bytes and each collective kind's count and
  bytes equal to 1e-9 relative, peak temporary bytes within PEAK_RTOL;
* reduced tinyllama-1.1b and deepseek-moe-16b train steps counted
  loop-aware on the one-rank host mesh against the reference's
  ``analyze_hlo``: ratio 1.000000;
* a model's loss and gradients on real CPU tensors are the same bit for
  bit with no counter and under a full counter (the loops run as before);
* the dry-run record says how it counted (``loops``), and the report
  prints it, the FLOPs and HBM over a full count, and reads its own
  tables back.
"""
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import tree as ttree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.roofline import report
from repro_torch.roofline.op_cost import OpCounter, counted_range

SRC = str(Path(__file__).resolve().parent.parent / "src")
#: relative tolerance on FLOPs, bytes and collectives: the same ops counted
RTOL = 1e-9
#: peak temporary bytes: the loop-aware count adds the other trips'
#: leftovers (a prefill's caches, a replay's saved inputs) to one trip's
#: high-water mark; on these cells it lands within 0.976-1.047 of the full
#: count's peak
PEAK_RTOL = 0.06

FAMILIES = ("dense", "gemma3", "deepseek-moe", "llama4", "mamba2", "hymba", "seamless")
STEPS = (("train", 1), ("train", 2), ("prefill", 1), ("decode", 1))


# --------------------------------------------------------------------------- counted_range
def test_counted_range_is_range_without_a_loop_aware_counter():
    x, p = torch.ones(3), {"w": torch.ones(2, 3)}
    for counter in (None, OpCounter(loops="all")):
        with counter if counter is not None else contextlib.nullcontext():
            loop = counted_range(5, peel=1)
            assert list(loop) == [0, 1, 2, 3, 4]
            (cx,), cp = loop.enter((x,), p)
            assert cx is x and cp is p
            assert loop.exit(x)[0] is x
            outs = [1, 2, 3]
            assert loop.repeat(outs) is outs
    with pytest.raises(ValueError):
        OpCounter(loops="some")


def test_a_counted_loop_runs_one_trip_and_nested_loops_multiply():
    a, w = torch.ones(8, 16), torch.ones(16, 16)
    counts = {}
    for loops in ("all", "once"):
        trips = []
        with OpCounter(loops=loops) as c:
            for i in counted_range(3):
                for j in counted_range(4):
                    trips.append((i, j))
                    a @ w
            for k in counted_range(5, scan=False):  # an unrolled segment
                a @ w
        counts[loops] = (trips, c.cost().flops)
    assert counts["all"][0] == [(i, j) for i in range(3) for j in range(4)]
    assert counts["once"][0] == [(0, 0)]
    assert counts["once"][1] == counts["all"][1] == (12 + 5) * 2 * 8 * 16 * 16


def _stacked_tanh_step(loops, input_grad):
    """A 7-layer stack of tanh(c @ w[i]) over stacked w [7, D, D], summed
    and differentiated, under a counter.  Without ``input_grad`` the first
    layer has no input gradient, unlike the others, and is peeled."""
    L, B, D = 7, 8, 32
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(L, D, D, generator=g) * 0.1).requires_grad_(True)
    x0 = torch.randn(B, D, generator=g).requires_grad_(input_grad)
    with OpCounter(loops=loops) as c:
        x = x0
        loop = counted_range(L, peel=0 if input_grad else 1)
        for i in loop:
            (x,), wt = loop.enter((x,), w)
            x = torch.tanh(x @ wt[i])
            x, = loop.exit(x)
        grads = torch.autograd.grad(x.sum(), [w, x0] if input_grad else [w])
    return c, grads


@pytest.mark.parametrize("input_grad", [True, False])
def test_a_stacked_loop_with_its_backward_counts_the_full_run(input_grad):
    full, g_full = _stacked_tanh_step("all", input_grad)
    once, g_once = _stacked_tanh_step("once", input_grad)
    f, o = full.cost(), once.cost()
    assert o.flops == f.flops and o.bytes == f.bytes
    # forward 7 x 2BDD; backward the weight gradients and the input
    # gradients (the first layer's only if asked for)
    assert f.flops == (7 + 7 + 6 + input_grad) * 2 * 8 * 32 * 32
    assert once.peak_bytes == pytest.approx(full.peak_bytes, rel=PEAK_RTOL)
    assert [g.shape for g in g_once] == [g.shape for g in g_full]


# --------------------------------------------------------------------------- the families on a fake mesh
_FAMILY_SCRIPT = r"""
import dataclasses, json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import fake_world, lower_cell

family = sys.argv[1]
arch = {"dense": "tinyllama-1.1b", "gemma3": "gemma3-1b", "deepseek-moe": "deepseek-moe-16b",
        "llama4": "llama4-maverick-400b-a17b", "mamba2": "mamba2-370m", "hymba": "hymba-1.5b",
        "seamless": "seamless-m4t-medium"}[family]
cfg = get_config(arch).reduced()
if family == "gemma3":  # two periods of 6, then 2 unrolled locals
    cfg = dataclasses.replace(cfg, num_layers=14)
if family == "hymba":  # global, a scanned run of 3 locals, global, 2 locals, global
    cfg = dataclasses.replace(cfg, num_layers=8,
                              hybrid=dataclasses.replace(cfg.hybrid, global_layers=(0, 4, 7)))
if family == "seamless":
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, num_layers=4))
fake_world(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out = {}
for kind, micro in ((k, int(m)) for k, m in (s.split(":") for s in sys.argv[2:])):
    for loops in ("all", "once"):
        counter, meta = lower_cell(arch, "loops", mesh, cfg=cfg,
                                   shape=ShapeConfig("loops", 64, 4, kind),
                                   micro_steps=micro, loops=loops)
        cost = counter.cost()
        out[f"{kind}:{micro}:{loops}"] = {
            "flops": cost.flops, "bytes": cost.bytes, "coll_bytes": cost.coll_bytes,
            "coll_ops": {k: dict(v) for k, v in cost.coll_ops.items()},
            "peak": meta["memory"]["temp_bytes"], "count_s": meta["count_s"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def family_counts():
    """Every family's steps counted both ways, one subprocess a family, all
    at once."""
    steps = [f"{k}:{m}" for k, m in STEPS]
    procs = {f: subprocess.Popen([sys.executable, "-c", _FAMILY_SCRIPT, f, *steps],
                                 env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"},
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for f in FAMILIES}
    out = {}
    for f, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        out[f] = (json.loads(stdout.strip().splitlines()[-1]) if proc.returncode == 0
                  else stderr[-3000:])
    return out


@pytest.mark.parametrize("kind,micro", STEPS)
@pytest.mark.parametrize("family", FAMILIES)
def test_the_loop_aware_count_is_the_full_count(family_counts, family, kind, micro):
    counts = family_counts[family]
    assert isinstance(counts, dict), counts
    full, once = counts[f"{kind}:{micro}:all"], counts[f"{kind}:{micro}:once"]
    for key in ("flops", "bytes", "coll_bytes"):
        assert once[key] == pytest.approx(full[key], rel=RTOL, abs=0), key
    assert set(once["coll_ops"]) == set(full["coll_ops"])
    for k, v in full["coll_ops"].items():
        assert once["coll_ops"][k]["count"] == v["count"], k
        assert once["coll_ops"][k]["bytes"] == pytest.approx(v["bytes"], rel=RTOL, abs=0), k
    if kind == "train":  # the mesh's data-parallel sums, its tensor-parallel ones
        assert full["coll_bytes"] > 0
    assert once["peak"] == pytest.approx(full["peak"], rel=PEAK_RTOL)


# --------------------------------------------------------------------------- against analyze_hlo
@pytest.fixture(scope="module")
def host_mesh():
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(device="cpu")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-moe-16b"])
def test_the_loop_aware_train_step_is_the_references_hlo_walk(arch, host_mesh):
    from test_torch_roofline import B, S, _reference_flops

    counter, meta = dryrun.lower_cell(arch, "parity", host_mesh,
                                      cfg=get_config(arch).reduced(),
                                      shape=ShapeConfig("parity", S, B, "train"))
    got, want = counter.cost().flops, _reference_flops(arch, "train")
    assert counter.loops == "once"
    assert round(got / want, 6) == 1.0, (got, want)


# --------------------------------------------------------------------------- the model unchanged
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "seamless-m4t-medium"])
def test_the_model_runs_every_trip_with_no_counter(arch):
    from repro_torch.models.api import build_model

    cfg = get_config(arch).reduced()
    model = build_model(cfg, remat=True, device="cpu")
    params = model.init(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=g)}
    if cfg.encoder is not None:
        batch["frame_embeds"] = torch.randn(2, cfg.encoder.source_len, cfg.d_model,
                                            generator=g) * 0.02

    def loss_and_grads():
        flat, treedef = ttree.flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        loss, _ = model.loss(ttree.unflatten(treedef, leaves), batch)
        return [loss] + list(torch.autograd.grad(loss, leaves))

    plain = loss_and_grads()
    with OpCounter(loops="all"):
        counted = loss_and_grads()
    assert len(plain) == len(counted) and all(torch.isfinite(plain[0]).reshape(-1))
    assert all(torch.equal(a, b) for a, b in zip(plain, counted))


# --------------------------------------------------------------------------- record and report
def test_the_record_says_how_it_counted_and_the_report_prints_it(host_mesh, tmp_path):
    cfg = get_config("tinyllama-1.1b").reduced()
    shape = ShapeConfig("train_4k", 64, 4, "train")
    recs = {loops: dryrun.dryrun_cell("tinyllama-1.1b", "train_4k", False, mesh=host_mesh,
                                      cfg=cfg, shape=shape, loops=loops)
            for loops in ("once", "all")}
    assert [r["loops"] for r in recs.values()] == ["once", "all"]
    assert all(r["status"] == "ok" for r in recs.values())
    assert recs["once"]["flops_per_dev"] == recs["all"]["flops_per_dev"]
    assert "loops counted: once=1" in report.summary([recs["once"]])
    full = {("single", "tinyllama-1.1b", "train_4k"): recs["all"]}
    line = report.full_departures([recs["once"]], full)
    assert line.startswith("against the full count (1 cells): FLOPs/rank within 0.00e+00")
    reference = {"single/tinyllama-1.1b/train_4k": {
        "status": "ok", "flops_per_dev": recs["all"]["flops_per_dev"]}}
    text = report.table([dict(recs["once"], counted_in="PR x")], "single", reference, full)
    row = [c.strip() for c in text.splitlines()[-1].strip("|").split("|")]
    assert row[9] == "1.000" and row[13] == "1.000000, %.3f" % (
        recs["once"]["hbm_per_dev_gb"] / recs["all"]["hbm_per_dev_gb"]) and row[14] == "PR x"
    back, = report.records_from_report(text, reference)
    assert back["counted_in"] == "PR x" and back["flops_per_dev"] == recs["all"]["flops_per_dev"]
    assert back["hbm_per_dev_gb"] == round(recs["once"]["hbm_per_dev_gb"], 1)
