"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's ``repro.launch.dryrun``:

* the counterpart of ``test_system.py::test_dryrun_single_cell_tiny_mesh``:
  a reduced tinyllama-1.1b train step built with fake tensors on the
  one-rank host mesh and counted, with its roofline terms and memory;
* ``make_cell_rules``' tables equal the reference's for every arch x shape
  x production mesh (the reference runs in a subprocess: importing its
  dry run sets ``XLA_FLAGS`` to 512 devices);
* ``dryrun_cell``'s ``argument_bytes`` equal the local shard bytes of the
  parameters, the ZeRO-1 moments and step, and the batch, computed from
  the shapes and specs, for a reduced cell on the 16x16 fake mesh (a
  subprocess: the fake world is a process's default group), exactly;
* the record has the reference's keys, and cells that do not apply skip;
* ``main``'s cells in subprocesses (``--jobs``, ``--timeout``) write
  their own records, a cell past its limit a ``timeout`` one.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import ARCH_IDS, SHAPES
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.roofline.analysis import roofline_terms

SRC = str(Path(__file__).resolve().parent.parent / "src")
MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}
#: the keys of the reference's ok record (``repro.launch.dryrun.dryrun_cell``)
RECORD_KEYS = {"arch", "shape", "mesh", "status", "reason", "n_chips", "lower_s", "compile_s",
               "flops_per_dev", "bytes_per_dev", "collective_bytes_per_dev", "collective_ops",
               "model_flops_total", "useful_flops_ratio", "memory", "compute_s", "memory_s",
               "collective_s", "bottleneck", "roofline_fraction_compute", "hbm_per_dev_gb",
               "fits_hbm"}


@pytest.fixture(scope="module")
def host_mesh():
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(device="cpu")


def test_dryrun_single_cell_tiny_mesh(host_mesh):
    """The dry-run machinery end to end on the one-rank host mesh: fake
    parameters, optimizer state and batch, one counted train step, roofline
    terms."""
    cfg = get_config("tinyllama-1.1b").reduced()
    counter, meta = dryrun.lower_cell("tinyllama-1.1b", "train_4k", host_mesh, cfg=cfg,
                                      shape=ShapeConfig("tiny", 64, 4, "train"))
    cost = counter.cost()
    assert cost.flops > 0 and cost.bytes > 0 and cost.coll_bytes == 0
    terms = roofline_terms(cost.flops, cost.bytes, cost.coll_bytes)
    assert terms["bottleneck"] in ("compute", "memory", "collective")
    mem = meta["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    # the new parameters and state, and four f32 metrics, for the batch
    assert mem["output_bytes"] == mem["argument_bytes"] - 4 * 64 * (4 + 4) + 4 * 4


def test_a_cell_record_has_the_references_keys(host_mesh):
    cfg = get_config("mamba2-370m").reduced()
    rec = dryrun.dryrun_cell("mamba2-370m", "decode_32k", False, mesh=host_mesh, cfg=cfg,
                             shape=ShapeConfig("decode_32k", 64, 2, "decode"))
    assert rec["status"] == "ok", rec.get("traceback")
    assert RECORD_KEYS <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "alias_bytes"}
    # the decode step writes the cache in place: its outputs alias it
    assert rec["memory"]["alias_bytes"] > 0
    assert rec["hbm_per_dev_gb"] == round(
        (rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]) / 1e9, 3)


def test_an_inapplicable_cell_skips():
    rec = dryrun.dryrun_cell("tinyllama-1.1b", "long_500k", False)
    assert rec["status"] == "skip" and rec["reason"]


def _stale(out_dir: Path, status: str) -> Path:
    path = out_dir / "single__tinyllama-1.1b__decode_32k.json"
    path.write_text(json.dumps({"arch": "tinyllama-1.1b", "shape": "decode_32k",
                                "mesh": "single", "status": status, "stale": True}))
    return path


def test_cells_in_subprocesses_write_their_own_records(tmp_path, monkeypatch):
    """``--jobs``: each cell counted in a process of its own; a record left
    by an earlier run in ``--out`` is replaced, never read back."""
    monkeypatch.setenv("PYTHONPATH", SRC)
    path = _stale(tmp_path, "error")
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--mesh", "single",
                     "--jobs", "2", "--out", str(tmp_path)])
    assert done.value.code == 0
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and "stale" not in rec and rec["n_chips"] == 256


def test_a_cell_past_its_timeout_is_not_counted(tmp_path, monkeypatch):
    """``--timeout``: a cell whose process outlives it gets a ``timeout``
    record (not an error, and not the stale record) and the run exits 1."""
    monkeypatch.setenv("PYTHONPATH", SRC)
    path = _stale(tmp_path, "ok")
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--mesh", "single",
                     "--timeout", "0.5", "--out", str(tmp_path)])
    assert done.value.code == 1
    rec = json.loads(path.read_text())
    assert rec["status"] == "timeout" and rec["reason"] == "not counted within 0.5 s"


# --------------------------------------------------------------------------- make_cell_rules
_REF_RULES = r"""
import json
from repro.launch.dryrun import make_cell_rules
from repro.launch.mesh import make_production_mesh
from repro.configs import ARCH_IDS, SHAPES, get_config

out = {}
for mesh_name, multi in (("single", False), ("multi", True)):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ARCH_IDS:
        for shape in SHAPES:
            table = make_cell_rules(mesh, get_config(arch), shape).table
            out[f"{arch}/{shape.name}/{mesh_name}"] = {
                k: list(v) if isinstance(v, tuple) else v for k, v in table.items()}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_rules():
    res = subprocess.run([sys.executable, "-c", _REF_RULES],
                         env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"},
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


class _Mesh:
    """A mesh's names and sizes: all ``make_cell_rules`` reads."""

    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = names, shape


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_rules_equal_the_references(arch, shape, mesh_name, reference_rules):
    from repro_torch.configs.base import SHAPES_BY_NAME

    rules = dryrun.make_cell_rules(_Mesh(*MESHES[mesh_name]), get_config(arch),
                                   SHAPES_BY_NAME[shape])
    got = {k: list(v) if isinstance(v, tuple) else v for k, v in rules.table.items()}
    assert got == reference_rules[f"{arch}/{shape}/{mesh_name}"]


# --------------------------------------------------------------------------- argument bytes
_ARG_BYTES = r"""
import json, math
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.params import tree_pspecs, zero1_pspec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import build_model

cfg = get_config("tinyllama-1.1b").reduced()
shape = ShapeConfig("train_4k", 64, 32, "train")
dryrun.fake_world()
mesh = make_production_mesh(device_type="cpu")
rec = dryrun.dryrun_cell("tinyllama-1.1b", "train_4k", False, mesh=mesh, cfg=cfg, shape=shape)
assert rec["status"] == "ok", rec.get("traceback")
rules = dryrun.make_cell_rules(mesh, cfg, shape)
sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

def local(shape, spec, itemsize):
    n = 1
    for d, entry in zip(shape, list(spec) + [None] * len(shape)):
        ways = math.prod(sizes[a] for a in ((entry,) if isinstance(entry, str) else entry or ()))
        n *= -(-d // ways)
    return n * itemsize

with FakeTensorMode():
    params = build_model(cfg, device="cpu").init(torch.Generator())
leaves = tree.leaves(params)
specs = tree.leaves(tree_pspecs(params, rules))
want = sum(local(p.shape, s, p.element_size()) for p, s in zip(leaves, specs))
want += 2 * sum(local(p.shape, zero1_pspec(s, p.shape, rules), 4) for p, s in zip(leaves, specs))
want += 4  # the int32 step
batch = shape.global_batch // sizes["data"] * shape.seq_len
want += batch * 4 + batch * 4  # int32 tokens, f32 loss mask
print(json.dumps({"got": rec["memory"]["argument_bytes"], "want": want,
                  "n_chips": rec["n_chips"]}))
"""


def test_argument_bytes_are_the_local_shards():
    res = subprocess.run([sys.executable, "-c", _ARG_BYTES],
                         env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["n_chips"] == 256
    assert out["got"] == out["want"]
