"""The port's mesh path where the dry run counted more work per rank than
the JAX package in three cells, held against its unsharded run and the
reference's own counts:

* on a (2, 2) gloo mesh (4 ranks of ``_torch_dist_worker.py`` in each of
  two groups), in f32 to 1e-4 relative to the largest magnitude
  (``test_torch_distributed.py``'s ``MODEL_RTOL``), each against its own
  unsharded run:
  - (a) qwen2-vl, hymba and gemma3 with 3 query heads over 1 KV head
    (neither divides the model axis) under the dry run's "seq" rule:
    prefills (qwen2-vl's of 12 and 2304 tokens with patch embeddings;
    hymba's and gemma3's of 12 and 60, past their window of 16), each rank
    attending its two chunks of the query rows, then 3 decode steps;
  - (b) llama4-maverick under the dry run's "fsdp" rule: a prefill, 3
    decode steps and a ZeRO-1 train step, the experts' w1 and w3
    contracting over their FSDP shard of d_model;
  - (c) mamba2 at batch 1: a prefill, 3 decode steps and a train step, the
    d_inner projections contracting over the idle data axis as well;
* (d) FLOPs per rank on the 16x16 fake mesh (a subprocess: the fake world
  is a process's default group) against the reference's ``lower_cell`` of
  the same cell (a subprocess: importing its dry run sets ``XLA_FLAGS`` to
  512 devices): the port's count over the reference's, divided by the
  cell's one-rank ratio r1, is at most 1.25.  The cells, and their ratios
  on the parent commit:
  - qwen2-vl-2b ``reduced()`` (4 layers) prefill, 32 x 2048 tokens:
    11.34 (1.104e10 against 9.731e8);
  - llama4-maverick ``reduced()`` with 32 experts of 256 and d_model 256,
    which divide the mesh's axes as the full config's do (its name keeps
    the dry run's "fsdp" rule): decode, 128 rows at a 64-slot cache, 2.12
    (9.306e6 against 4.391e6); train, 256 x 64 tokens in 8 microbatches,
    2.35 (4.786e9 against 2.057e9, r1 0.98990);
  - mamba2-370m at full width, 8 layers, decode at batch 1 against a
    4096-slot cache: 1.90 (1.302e7 against 6.847e6);
* (e) the one-rank FLOPs of those cells against the reference's
  ``analyze_hlo`` (the ratio r1 that (d) divides by), pinned to 1e-6;
* (f) the recount's tools: ``roofline.report`` reads an earlier report's
  rows back (``--previous``), and ``launch.dryrun --cells``.
"""
import dataclasses
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch.multiprocessing as tmp

import _torch_dist_worker as W

SRC = str(Path(__file__).resolve().parent.parent / "src")
MODEL_RTOL = 1e-4
#: the bound on (port FLOPs / reference FLOPs) / r1 on the 16x16 mesh
FLOPS_RATIO_BOUND = 1.25


def close(got, want, rtol, err_msg=""):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * scale, err_msg=err_msg)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# --------------------------------------------------------------------------- (d), (e): the cells
#: name -> (arch, kind, seq, batch, config changes): "base" "reduced" or
#: "full", then ModelConfig fields ("top") and MoEConfig fields ("moe")
CELLS = {
    "qwen2-vl-prefill": ("qwen2-vl-2b", "prefill", 2048, 32, {"base": "reduced"}),
    "maverick-decode": ("llama4-maverick-400b-a17b", "decode", 64, 128,
                        {"base": "reduced", "top": {"d_model": 256},
                         "moe": {"num_experts": 32, "d_ff_expert": 256}}),
    "maverick-train": ("llama4-maverick-400b-a17b", "train", 64, 256,
                       {"base": "reduced", "top": {"d_model": 256},
                        "moe": {"num_experts": 32, "d_ff_expert": 256}}),
    "mamba2-batch1": ("mamba2-370m", "decode", 4096, 1, {"base": "full", "top": {"num_layers": 8}}),
}

#: the port's one-rank FLOPs over the reference's ``analyze_hlo``, as
#: measured (maverick's train step differs in the backward of its router
#: and shared expert)
R1 = {"qwen2-vl-prefill": 1.0, "maverick-decode": 1.0,
      "maverick-train": 210453397504 / 212600881152, "mamba2-batch1": 1.0}

#: builds a cell's config in either package (``get_config`` is the
#: package's own)
_CONFIG = r"""
import dataclasses

def cell_config(get_config, arch, change):
    cfg = get_config(arch)
    if change.get("base") == "reduced":
        cfg = cfg.reduced()
    if change.get("moe"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **change["moe"]))
    return dataclasses.replace(cfg, **change.get("top", {}))
"""

_PORT_COUNTS = _CONFIG + r"""
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.roofline.op_cost import analyze_log

cells, one_rank = json.loads(sys.argv[1]), sys.argv[2] == "1"
if one_rank:
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device="cpu")
else:
    from repro_torch.launch.mesh import make_production_mesh
    dryrun.fake_world()
    mesh = make_production_mesh(device_type="cpu")
out = {}
for name, (arch, kind, seq, batch, change) in cells.items():
    counter, _ = dryrun.lower_cell(arch, "cell", mesh, cfg=cell_config(get_config, arch, change),
                                   shape=ShapeConfig("cell", seq, batch, kind))
    out[name] = analyze_log(counter.records).flops
print(json.dumps(out))
"""

#: the reference's ``lower_cell``, its config and shape lookups pointed at
#: the cell
_REF_COUNTS = _CONFIG + r"""
import json, sys
import repro.launch.dryrun as D
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_host_mesh, make_production_mesh
from repro.roofline.hlo_cost import analyze_hlo

cells, one_rank = json.loads(sys.argv[1]), sys.argv[2] == "1"
mesh = make_host_mesh() if one_rank else make_production_mesh()
out = {}
for name, (arch, kind, seq, batch, change) in cells.items():
    cfg = cell_config(get_config, arch, change)
    D.get_config = lambda a: cfg
    D.SHAPES_BY_NAME = {"cell": ShapeConfig("cell", seq, batch, kind)}
    lowered, _ = D.lower_cell(arch, "cell", mesh)
    out[name] = analyze_hlo(lowered.compile().as_text()).flops
print(json.dumps(out))
"""


def _start(script, cells, one_rank):
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    return subprocess.Popen([sys.executable, "-c", script, json.dumps(cells),
                             "1" if one_rank else "0"], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _collect(procs) -> dict:
    got = {}
    for p in procs:
        out, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-3000:]
        got.update(json.loads(out.strip().splitlines()[-1]))
    return got


# --------------------------------------------------------------------------- (a)-(c) gloo runs
def _inputs(workdir: Path) -> dict:
    rng = np.random.default_rng(27)
    inp = {
        "rep_tokens": rng.integers(0, 1 << 30, (2, 12)).astype(np.int32),
        "rep_steps": rng.integers(0, 1 << 30, (W.REPAIR_DECODE, 2, 1)).astype(np.int32),
        "rep_train4": rng.integers(0, 1 << 30, (4, 64)).astype(np.int32),
        # reduced qwen2-vl: 8 patches of d_model 128
        "seq_patch_embeds": (rng.normal(size=(2, 8, 128)) * 0.02).astype(np.float32),
    }
    for S in W.SEQ_LENGTHS + W.SEQ_WINDOWED_LENGTHS:
        inp[f"seq_tokens{S}"] = rng.integers(0, 1 << 30, (2, S)).astype(np.int32)
        inp[f"seq_positions_thw{S}"] = rng.integers(0, S, (3, 2, S)).astype(np.int32)
    np.savez(workdir / "inputs.npz", **inp)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two groups of 4 port ranks and the count subprocesses of (d) and
    (e), all at once.  Returns ({check: port outputs}, {"port" |
    "reference": {cell: FLOPs on 16x16}}, {"port" | "reference": {cell:
    one-rank FLOPs}})."""
    workdir = tmp_path_factory.mktemp("seq_fsdp")
    _inputs(workdir)
    slow = {k: CELLS[k] for k in ("maverick-train",)}
    fast = {k: v for k, v in CELLS.items() if k not in slow}
    counts = {"port": [_start(_PORT_COUNTS, slow, False), _start(_PORT_COUNTS, fast, False)],
              "reference": [_start(_REF_COUNTS, CELLS, False)]}
    ones = {"port": [_start(_PORT_COUNTS, CELLS, True)],
            "reference": [_start(_REF_COUNTS, CELLS, True)]}
    halves = (["seq_prefill", "idle_ssm"], ["fsdp_moe"])
    try:
        groups = [tmp.start_processes(W.run, args=(4, _free_port(), str(workdir), checks),
                                      nprocs=4, join=False, start_method="spawn")
                  for checks in halves]
        for g in groups:
            while not g.join():
                pass
    except Exception:
        errors = sorted(workdir.glob("error_*.txt"))
        raise AssertionError(errors[0].read_text() if errors else "a rank failed")
    finally:
        counted = {side: _collect(ps) for side, ps in counts.items()}
        one = {side: _collect(ps) for side, ps in ones.items()}
    port = {n: dict(np.load(workdir / f"port_{n}.npz")) for h in halves for n in h}
    return port, counted, one


def _mesh_equals_plain(got: dict):
    keys = [k[len("plain_"):] for k in got if k.startswith("plain_")]
    assert keys
    for k in keys:
        close(got[f"mesh_{k}"], got[f"plain_{k}"], MODEL_RTOL, k)


@pytest.mark.parametrize("arch,S", [("qwen2-vl-2b", S) for S in W.SEQ_LENGTHS]
                         + [(a, S) for a in W.SEQ_WINDOWED for S in W.SEQ_WINDOWED_LENGTHS])
def test_prefill_with_the_query_rows_split_over_seq(runs, arch, S):
    """(a): the prefill's logits and 3 decode steps' after it."""
    got = runs[0]["seq_prefill"]
    i = (W.SEQ_LENGTHS if arch == "qwen2-vl-2b" else W.SEQ_WINDOWED_LENGTHS).index(S)
    close(got[f"{arch}/mesh_prompt{i}"], got[f"{arch}/plain_prompt{i}"], MODEL_RTOL,
          f"{arch}, {S} tokens")


def test_moe_experts_contracted_over_their_fsdp_shard(runs):
    """(b): prefill and decode logits, loss, grad norm and every new
    parameter."""
    got = runs[0]["fsdp_moe"]
    assert {"mesh_prompt0", "mesh_loss", "mesh_gnorm"} <= set(got)
    _mesh_equals_plain(got)


def test_ssm_projections_over_the_idle_data_axis_at_batch_1(runs):
    """(c): prefill and decode logits, loss, grad norm and every new
    parameter."""
    got = runs[0]["idle_ssm"]
    assert {"mesh_prompt0", "mesh_loss", "mesh_gnorm"} <= set(got)
    _mesh_equals_plain(got)


@pytest.mark.parametrize("cell", list(CELLS))
def test_flops_per_rank_on_16x16_against_the_reference(runs, cell):
    """(d)"""
    got, want = runs[1]["port"][cell], runs[1]["reference"][cell]
    assert got / want / R1[cell] <= FLOPS_RATIO_BOUND, (got, want, got / want)


@pytest.mark.parametrize("cell", list(CELLS))
def test_one_rank_flops_against_the_reference_hlo_walk(runs, cell):
    """(e)"""
    got, want = runs[2]["port"][cell], runs[2]["reference"][cell]
    assert got / want == pytest.approx(R1[cell], rel=1e-6), (got, want)


def test_the_cells_keep_the_dry_runs_rules():
    """The dry run's "seq" rule for qwen2-vl's prefill (2 KV heads at tp
    16), its "fsdp" rule for maverick (the reduced config keeps the name
    in FSDP_ARCHS), and mamba2's batch of one, which leaves the data axis
    idle."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import FSDP_ARCHS, make_cell_rules

    class Mesh:  # the production mesh's names and shape, without a world
        mesh_dim_names, shape = ("data", "model"), (16, 16)

    for name, (arch, kind, seq, batch, change) in CELLS.items():
        cfg = get_config(arch).reduced() if change["base"] == "reduced" else get_config(arch)
        cfg = dataclasses.replace(cfg, **change.get("top", {}))
        rules = make_cell_rules(Mesh, cfg, ShapeConfig("cell", seq, batch, kind))
        if arch == "qwen2-vl-2b":
            assert rules.table["seq"] == "model"
        if arch in FSDP_ARCHS:
            assert rules.table["fsdp"] == ("data",)
        if arch == "mamba2-370m":
            assert rules.spec((batch,), ("batch",))[0] is None


# --------------------------------------------------------------------------- the recount's tools
DOC = Path(__file__).resolve().parent.parent / "docs" / "dryrun_torch.md"
REFERENCE = DOC.parent / "dryrun_reference_counts.json"


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_an_earlier_reports_rows_come_back_as_they_were(mesh):
    """(f): ``report.records_from_report`` reads back the records behind
    ``docs/dryrun_torch.md``'s tables: ``report.table`` writes every row
    of them again as it stands, so a recount keeps the rows of the cells
    it did not count."""
    from repro_torch.roofline import report

    reference = report.load_reference(REFERENCE)
    text = DOC.read_text()
    recs = report.records_from_report(text, reference)
    assert {r["mesh"] for r in recs} == {"single", "multi"} and len(recs) == 80
    rows = [line for line in report.table(recs, mesh, reference).splitlines()
            if line.startswith("| ")]
    assert len(rows) == 41
    for row in rows:
        assert row in text, row


def test_the_dry_runs_cells_option(tmp_path):
    """(f): ``--cells`` counts the named cells in its order and refuses a cell
    the assignment does not hold."""
    from repro_torch.launch import dryrun

    with pytest.raises(SystemExit) as err:
        dryrun.main(["--cells", "tinyllama-1.1b:train_4k,nope:train_4k", "--out",
                     str(tmp_path)])
    assert err.value.code == 2
    with pytest.raises(SystemExit) as done:  # a skipped cell: no world, no count
        dryrun.main(["--cells", "tinyllama-1.1b:long_500k", "--mesh", "single", "--out",
                     str(tmp_path)])
    assert done.value.code == 0
    rec = json.loads((tmp_path / "single__tinyllama-1.1b__long_500k.json").read_text())
    assert rec["status"] == "skip"
