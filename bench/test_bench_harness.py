"""The harness itself: the result line's shape, cells found by name from
files alone, the import guard, and the card check."""
import ast
import json
import shutil
import sys

import pytest
import torch

from bench.harness import core, small, weights
from bench.harness.model import as_dict, model_config

SOURCES = sorted(p for p in core.BENCH.rglob("*.py"))


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(core.BENCH)))
def test_no_jax_or_jax_package_imported(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert core.forbidden_modules(tops) == []
    if path.parent.name == "reference":
        assert "repro_torch" not in tops


def test_setup_guard(monkeypatch):
    """The benchmark's own process stops after set-up if JAX or the JAX
    package is loaded (a test process, which loads them, runs unguarded)."""
    run = core.Run(small.small_cell("dsmoe16b.chat"), 1, 1.0, 0, 0.0, device="cpu")
    monkeypatch.setattr(core, "forbidden_modules", lambda names=None: [])
    run.finish_setup()
    assert run.setup_s > 0
    monkeypatch.setattr(core, "forbidden_modules", lambda names=None: ["jax"])
    with pytest.raises(SystemExit):
        run.finish_setup()
    core.Run(run.cell, 1, 1.0, 0, 0.0, device="cpu", guard=False).finish_setup()


def test_forbidden_names_compare_whole():
    assert core.forbidden_modules(["repro_torch", "repro_torch.models", "reprox", "jaxtyping"]) == []
    assert core.forbidden_modules(["repro.core", "jax.numpy", "flax", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_every_metric_cell_and_file_is_found():
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    assert spec["paths"] == ["bench"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (core.BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for w in spec["workloads"]:
        cell = core.Cell(w["name"])
        assert cell.metrics(0) and cell.metrics(1), w["name"]
        assert cell.reference().logits
        assert (core.BENCH / "harness" / f"{cell.traffic['kind']}.py").is_file()
        assert "setup_s" in {m["name"] for m in cell.metrics(0)}
    for c in spec["configs"]:
        assert (core.ROOT / c["file"]).is_file()


def test_new_config_mix_and_metric_from_files_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and entries in BENCHMARK.json are found by name, with no edit
    to a file that was there."""
    root = tmp_path / "repo"
    shutil.copytree(core.BENCH, root / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    cfg = core.load_json(core.BENCH / "configs" / "deepseek-moe-16b.json")
    cfg["name"], cfg["model"]["num_layers"] = "deepseek-moe-16b-half", 14
    (root / "bench" / "configs" / "deepseek-moe-16b-half.json").write_text(json.dumps(cfg))
    mix = dict(core.load_json(core.BENCH / "traffic" / "chat.json"), clients=8)
    (root / "bench" / "traffic" / "chat8.json").write_text(json.dumps(mix))
    (root / "bench" / "limits" / "half.chat8.json").write_text(
        (core.BENCH / "limits" / "dsmoe16b.chat.json").read_text())
    (root / "bench" / "metrics" / "serve.steps.py").write_text(
        "def read(run):\n    return run.records.get('steps')\n")
    spec["configs"].append({"name": "deepseek-moe-16b-half", "source": "x",
                            "file": "bench/configs/deepseek-moe-16b-half.json", "reduced": [],
                            "why": "x"})
    spec["workloads"].append({"name": "half.chat8", "config": "deepseek-moe-16b-half",
                              "traffic": "chat8", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "serve.steps", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "service",
                              "moves": "serve_tok_s", "workloads": ["half.chat8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    # and one of another family (an encoder-decoder), its model section
    # made from the program's own configuration
    from repro_torch.configs import registry
    from repro_torch.models.api import build_model

    encdec = registry.get_config("seamless-m4t-medium")
    (root / "bench" / "configs" / "seamless-m4t-medium.json").write_text(json.dumps(
        {"name": "seamless-m4t-medium", "reference": "seamless_m4t_medium",
         "model": as_dict(encdec)}))
    spec["configs"].append({"name": "seamless-m4t-medium", "source": "x",
                            "file": "bench/configs/seamless-m4t-medium.json", "reduced": [],
                            "why": "x"})
    spec["workloads"].append({"name": "seamless.chat8", "config": "seamless-m4t-medium",
                              "traffic": "chat8", "chips": 1, "why": "x"})
    (root / "bench" / "limits" / "seamless.chat8.json").write_text("{}")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = core.Cell("half.chat8", root=root)
    assert cell.config["model"]["num_layers"] == 14 and cell.traffic["clients"] == 8
    other = model_config(core.Cell("seamless.chat8", root=root).config["model"])
    assert other == encdec
    assert weights.Layout(other.reduced(), build_model).program_params(1, "cpu")["enc_layers"]
    assert [m["name"] for m in cell.metrics(1)] == ["serve.steps"]
    run = core.Run(cell, 1, 1.0, 1, 0.0, device="cpu")
    run.records["steps"] = 12
    reader = core.load_module(root / "bench" / "metrics" / "serve.steps.py", "serve_steps")
    assert reader.read(run) == 12


def test_result_line_of_a_small_run(capsys):
    cell = small.small_cell("dsmoe16b.chat", dtype="float32")
    run = small.small_run(cell, seed=2**32 + 9, seconds=1.0)
    metrics = core.read_metrics(run)
    assert {"serve_tok_s", "setup_s"} <= set(metrics)
    device = {"platform": "gpu", "kind": "test", "count": 1, "memory_peak_bytes": 1}
    core.print_result(core.result_line(run, metrics, device))
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == {"served_outside_vocab"} | set(cell.limits)
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert err.strip().splitlines()[-1].startswith(f"check {list(line['checks'])[-1]}:")


def test_no_card_no_result(monkeypatch, capsys):
    sys.path.insert(0, str(core.ROOT))
    run_py = core.load_module(core.BENCH / "run.py", "bench_run_main")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run_py.main(["--workload", "dsmoe16b.chat", "--seed", "1", "--seconds", "1",
                     "--trace", "0"])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""



def _arch_ids():
    from repro_torch.configs import registry

    return registry.ARCH_IDS


@pytest.mark.parametrize("arch", _arch_ids())
def test_every_program_config_from_a_file(arch):
    """Every family's configuration, nested groups and all, comes back
    whole from a configuration file's ``model`` section."""
    from repro_torch.configs import registry

    for cfg in (registry.get_config(arch), registry.get_config(arch).reduced()):
        assert model_config(json.loads(json.dumps(as_dict(cfg)))) == cfg


@pytest.mark.parametrize("arch", _arch_ids())
def test_every_program_config_gets_its_weights(arch):
    """The benchmark's weights for every family of the program: its
    layout read from the program's tree at full size, and at the reduced
    size the tree drawn, laid out as the program's own ``init`` lays it,
    each leaf drawn again alike from the seed."""
    from torch.utils import _pytree as pt

    from repro_torch.configs import registry
    from repro_torch.models.api import build_model

    assert weights.Layout(registry.get_config(arch), build_model).n_layers > 0
    cfg = registry.get_config(arch).reduced()
    layout = weights.Layout(cfg, build_model)
    params = layout.program_params(7, "cpu")
    own = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    got, tree = pt.tree_flatten(params)
    want, own_tree = pt.tree_flatten(own)
    assert tree == own_tree
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in want]
    views = layout.views(params)
    assert sum(t.numel() for t in views.values()) == sum(t.numel() for t in got)
    for (path, layer), t in views.items():
        assert torch.equal(layout.leaf(7, path, layer, "cpu", t.dtype), t), (path, layer)
