"""The port's user tools on the CPU, held against the JAX package's tools:
``tools/trace_view_torch.py``, ``tools/pcm_repro_torch.py``,
``tools/dsalint_torch.py`` and ``tools/check_docs_torch.py``; and an AST
check that no entry point of the port imports ``jax`` or ``repro``."""
from __future__ import annotations

import ast
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
TOOLS = ROOT / "tools"

#: the port's entry points (and the script that drives them on the card):
#: none may import the JAX package or JAX
PORT_SCRIPTS = (
    "examples/quickstart_torch.py", "examples/incremental_checkpointing_torch.py",
    "examples/serve_continuous_batching_torch.py", "examples/train_e2e_torch.py",
    "tools/trace_view_torch.py", "tools/pcm_repro_torch.py", "tools/dsalint_torch.py",
    "tools/check_docs_torch.py", "src/repro_torch/launch/serve.py", "chip_smoke.py",
)


def load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(mod, argv, capsys):
    rc = mod.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


# --------------------------------------------------------------------------- imports
def imported_modules(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value)
    return names


@pytest.mark.parametrize("script", PORT_SCRIPTS)
def test_the_port_entry_points_import_neither_jax_nor_repro(script):
    names = imported_modules(ROOT / script)
    bad = sorted(n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not bad, f"{script} imports {bad}"
    if script != "tools/dsalint_torch.py":
        assert any(n.split(".")[0] == "repro_torch" for n in names)


# --------------------------------------------------------------------------- trace_view
@pytest.fixture(scope="module")
def trace_tools():
    return load(TOOLS / "trace_view.py"), load(TOOLS / "trace_view_torch.py")


@pytest.mark.parametrize("workload", ["burst", "openloop"])
def test_trace_view_check_json_matches_the_reference(trace_tools, capsys, workload):
    ref_tool, port_tool = trace_tools
    argv = ["--workload", workload, "--check", "--json"]
    rc, out, err = run_main(port_tool, argv + ["--device", "cpu"], capsys)
    assert rc == 0 and "all trace checks passed" in err, err
    rc_ref, out_ref, _ = run_main(ref_tool, argv, capsys)
    assert rc_ref == 0
    got, want = json.loads(out), json.loads(out_ref)
    assert sorted(got) == sorted(want)
    assert sorted(got["phases"]) == sorted(want["phases"]) == sorted(port_tool.PHASES)
    assert sorted(got["critical_path"]) == sorted(want["critical_path"])
    assert sorted(got["host_free"]) == sorted(want["host_free"])
    assert got["host_free"]["delta"] <= 0.05 * got["host_free"]["spans"]
    assert [sorted(r) for r in got["slowest"]] == [sorted(r) for r in want["slowest"]]
    if workload == "openloop":
        assert got["slowest"] and all(re.fullmatch(r"req\d+", r["trace_id"])
                                      for r in got["slowest"])


def test_trace_view_tables_and_perfetto(trace_tools, capsys, tmp_path):
    _, port_tool = trace_tools
    path = tmp_path / "trace.json"
    rc, out, _ = run_main(port_tool, ["--device", "cpu", "--descriptors", "16", "--top", "3",
                                      "--perfetto", str(path)], capsys)
    assert rc == 0
    assert out.startswith("phase breakdown:") and "host-free fraction: spans=" in out
    assert len(re.findall(r"^  desc \d+ ", out, re.MULTILINE)) == 3
    assert json.loads(path.read_text())["traceEvents"]


# --------------------------------------------------------------------------- pcm_repro
def test_pcm_repro_once_csv_header_is_the_references(capsys, tmp_path):
    argv = ["--once", "-numa", "--trace", "-csv"]
    rc, out, err = run_main(load(TOOLS / "pcm_repro_torch.py"),
                            argv + [str(tmp_path / "port.csv"), "--device", "cpu"], capsys)
    assert rc == 0 and "note" not in err, err
    assert "pcm_repro frame 1" in out and "CROSS-GB/s" in out and "trace: sampled=" in out
    rc_ref, _, _ = run_main(load(TOOLS / "pcm_repro.py"), argv + [str(tmp_path / "ref.csv")],
                            capsys)
    assert rc_ref == 0
    header = (tmp_path / "port.csv").read_text().splitlines()[0]
    assert header == (tmp_path / "ref.csv").read_text().splitlines()[0]
    rows = (tmp_path / "port.csv").read_text().splitlines()
    assert len(rows) == 2 and len(rows[1].split(",")) == len(header.split(","))


# --------------------------------------------------------------------------- dsalint
def dsalint(tool: str, *args):
    r = subprocess.run([sys.executable, str(TOOLS / tool), *map(str, args)],
                       capture_output=True, text=True, timeout=120)
    return r.returncode, r.stdout, r.stderr


@pytest.mark.parametrize("case", ["bad", "good", "list-rules", "select"])
def test_dsalint_torch_prints_what_the_reference_prints(tmp_path, case):
    src = {"bad": "def f(d, buf):\n    d.memcpy_async(buf)\n"
                  "    for b in buf:\n        x = d.crc32_async(b)\n",
           "good": "x = 1\n", "select": "def f(d, buf):\n    d.memcpy_async(buf)\n"}
    args = ["--list-rules"]
    if case in src:
        f = tmp_path / f"{case}.py"
        f.write_text(src[case])
        args = [f] if case != "select" else ["--select", "DSA106", f]
    got, want = dsalint("dsalint_torch.py", *args), dsalint("dsalint.py", *args)
    assert got == want
    assert got[0] == {"bad": 1, "good": 0, "list-rules": 0, "select": 0}[case]


# --------------------------------------------------------------------------- check_docs
CPU_BLOCK = """```python
import torch
from repro_torch.core import make_device

d = make_device(device="cpu")
assert torch.equal(d.memcpy_async(torch.arange(8.0)).result(), torch.arange(8.0))
```
"""
CARD_BLOCK = """``` python card
from repro_torch.core import make_device

make_device().memcpy_async(__import__("torch").zeros(8, device="cuda")).result()
```
"""
FAILING_BLOCK = """```python
from repro_torch.core import make_device

make_device(device="cpu").memcpy_async(undefined_name).result()
```
"""


def docs_tree(tmp_path: Path, readme: str) -> Path:
    """A git tree holding the checker, a .gitignore and ``readme``."""
    root = tmp_path / "tree"
    (root / "tools").mkdir(parents=True)
    shutil.copy(TOOLS / "check_docs_torch.py", root / "tools")
    (root / ".gitignore").write_text("__pycache__/\n*.py[cod]\n")
    (root / "README.md").write_text(readme)
    subprocess.run(["git", "init", "-q"], cwd=root, check=True)
    subprocess.run(["git", "add", "-A"], cwd=root, check=True)
    return root


def check_docs(root: Path, *args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, str(root / "tools" / "check_docs_torch.py"), *args],
                       capture_output=True, text=True, env=env, timeout=300)
    return r.returncode, r.stdout, r.stderr


def test_check_docs_torch_names_a_failing_block(tmp_path):
    rc, out, err = check_docs(docs_tree(tmp_path, "# t\n\n" + CPU_BLOCK + "\n" + FAILING_BLOCK),
                              "--device", "cpu")
    assert rc == 1
    assert "ok   README.md block 1 (line 4)" in out
    assert "FAIL README.md block 2 (line 12)" in err and "NameError" in err


def test_check_docs_torch_passes_a_good_tree_and_leaves_card_blocks_to_the_card(tmp_path):
    root = docs_tree(tmp_path, "# t\n\n" + CPU_BLOCK + "\n" + CARD_BLOCK)
    rc, out, err = check_docs(root, "--device", "cpu")
    assert rc == 0, err
    assert "ok   README.md block 1" in out and "ok   dsalint (repro_torch) clean over 1 python files" in out
    assert "note README.md block 2 (line 12): needs the card, not run (--device cpu)" in out
    rc, _, err = check_docs(root)  # the card by default: raises without one
    if not __import__("torch").cuda.is_available():
        assert rc == 1 and "needs a CUDA device" in err


def test_the_card_fence_is_left_to_the_port_checker():
    ref_re = load(TOOLS / "check_docs.py").BLOCK_RE
    port = load(TOOLS / "check_docs_torch.py")
    assert ref_re.findall(CARD_BLOCK) == []
    assert [card for _, _, card, _ in port.port_blocks(CARD_BLOCK + CPU_BLOCK)] == [True, False]
    readme = (ROOT / "README.md").read_text()
    card_blocks = [b for b in port.port_blocks(readme) if b[2]]
    assert card_blocks, "README.md has no block fenced for the card"
    assert all(b[3] not in {m.group(1) for m in ref_re.finditer(readme)} for b in card_blocks)
