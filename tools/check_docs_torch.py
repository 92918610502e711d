"""Docs checker for the PyTorch + CUDA port: every python code block in
README.md and docs/*.md that imports ``repro_torch`` must execute cleanly
against the current sources, so the port's documentation can never drift
from its API.

    PYTHONPATH=src python tools/check_docs_torch.py [--device cpu]

Three checks, as ``tools/check_docs.py`` makes them for the JAX package:
no bytecode is tracked by git (and .gitignore covers it), the
``repro_torch.analysis.apilint`` rules find nothing in the git-tracked
python files, and the blocks run.  In a copy of the tree that is not a git
checkout, nothing is tracked: the bytecode check says so and passes, and
the lint takes every python file of the tree outside ``build/``,
``chiprun_out/``, ``results/`` and hidden directories.

Fences.  A block fenced ```` ```python ```` (or ```` ```py ````) runs here
when it imports ``repro_torch``, and ``tools/check_docs.py`` runs it too, so
such a block must run on the CPU (``device="cpu"``).  A block that needs the
card is fenced

    ``` python card

(a space after the backticks, then ``python card``): Markdown renders it
as python, and the JAX package's checker, whose pattern takes only fences
that start ```` ```py ````, leaves it alone.  This checker runs it on the
card.  With ``--device cpu`` the card's blocks are listed as not run, and
the rest run; without it and with no card, the checker raises.

Each block runs in its own namespace, in a temporary working directory (a
block may write a file such as ``trace.json``); a failure prints the file,
block index and traceback, and exits non-zero.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

#: ```python / ```py fences (what tools/check_docs.py runs) and the card's
#: ``` python card fence, tolerating CRLF endings
BLOCK_RE = re.compile(
    r"```(?P<card> python card|py(?:thon)?)[^\n]*\r?\n(?P<code>.*?)```", re.DOTALL)
IMPORTS_PORT_RE = re.compile(r"^\s*(?:from|import)\s+repro_torch\b", re.MULTILINE)
#: bytecode artifacts that must never be committed — directories or files
BYTECODE_RE = re.compile(r"(^|/)__pycache__(/|$)|\.py[cod]$")
#: outside a git checkout, the lint leaves out these directories' files
UNTRACKED_DIRS = {"build", "chiprun_out", "results", "__pycache__"}


def git_checkout() -> bool:
    """Whether ROOT is the top of a git work tree (a copy of the tree without
    .git, even one inside another checkout, is not)."""
    if shutil.which("git") is None:
        return False
    top = subprocess.run(["git", "rev-parse", "--show-toplevel"], cwd=ROOT,
                         capture_output=True, text=True)
    return top.returncode == 0 and Path(top.stdout.strip()).resolve() == ROOT


def tracked(pattern: str | None = None) -> list[str]:
    cmd = ["git", "ls-files"] + ([pattern] if pattern else [])
    return subprocess.run(cmd, cwd=ROOT, check=True, capture_output=True,
                          text=True).stdout.splitlines()


def python_files() -> list[str]:
    """The git-tracked python files; outside a checkout, the tree's."""
    if git_checkout():
        return tracked("*.py")
    return sorted(str(f.relative_to(ROOT)) for f in ROOT.rglob("*.py")
                  if not any(p in UNTRACKED_DIRS or p.startswith(".")
                             for p in f.relative_to(ROOT).parts[:-1]))


def check_bytecode() -> int:
    """Fail when bytecode artifacts are git-tracked, or when .gitignore
    does not cover them."""
    if not git_checkout():
        print("ok   not a git checkout: no tracked bytecode to check")
        return 0
    bad = [f for f in tracked() if BYTECODE_RE.search(f)]
    for f in bad:
        print(f"FAIL tracked bytecode artifact: {f}", file=sys.stderr)
    ignored = subprocess.run(
        ["git", "check-ignore", "-q", "src/__pycache__/x.cpython-310.pyc"],
        cwd=ROOT).returncode == 0
    if not ignored:
        print("FAIL .gitignore does not cover __pycache__/*.pyc", file=sys.stderr)
    if bad or not ignored:
        return len(bad) + (0 if ignored else 1)
    print("ok   no tracked bytecode artifacts; .gitignore covers them")
    return 0


def check_dsalint() -> int:
    """The port's apilint rules over every git-tracked python file."""
    from repro_torch.analysis import apilint

    files = python_files()
    violations = apilint.lint_paths([ROOT / f for f in files])
    for v in violations:
        print(f"FAIL {v}", file=sys.stderr)
    if violations:
        return len(violations)
    print(f"ok   dsalint (repro_torch) clean over {len(files)} python files")
    return 0


def doc_files() -> list[Path]:
    files = [ROOT / "README.md"]
    files += sorted((ROOT / "docs").glob("*.md"))
    return [f for f in files if f.exists()]


def port_blocks(text: str):
    """(index, first line, needs the card, code) of each python block of
    ``text`` that imports repro_torch; the index counts every python block,
    as tools/check_docs.py does for the ones it runs."""
    for i, m in enumerate(BLOCK_RE.finditer(text), 1):
        code = m.group("code").replace("\r\n", "\n")
        if IMPORTS_PORT_RE.search(code):
            line = text[: m.start()].count("\n") + 2  # first line inside the fence
            yield i, line, m.group("card") == " python card", code


def check_file(path: Path, card: bool) -> int:
    failures = 0
    name = path.relative_to(ROOT)
    for i, line, needs_card, code in port_blocks(path.read_text()):
        if needs_card and not card:
            print(f"note {name} block {i} (line {line}): needs the card, not run (--device cpu)")
            continue
        here = os.getcwd()
        with tempfile.TemporaryDirectory() as work:
            os.chdir(work)
            try:
                exec(compile(code, f"{path.name}:block{i}", "exec"), {"__name__": "__docs__"})
            except Exception:
                failures += 1
                print(f"FAIL {name} block {i} (line {line}):", file=sys.stderr)
                traceback.print_exc()
            else:
                print(f"ok   {name} block {i} (line {line})")
            finally:
                os.chdir(here)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="check_docs_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="the card by default (every block runs); 'cpu' runs the "
                         "blocks that need no card")
    args = ap.parse_args(argv)

    from repro_torch.core.engine import resolve_device

    card = resolve_device(args.device).type == "cuda"
    failures = check_bytecode()  # repo hygiene first: cheap and unambiguous
    failures += check_dsalint()
    files = doc_files()
    if not files:
        print("no documentation files found", file=sys.stderr)
        return 1
    failures += sum(check_file(f, card) for f in files)
    if failures:
        print(f"{failures} check(s) failed", file=sys.stderr)
        return 1
    print(f"all repro_torch python blocks in {len(files)} file(s) executed cleanly")
    return 0


if __name__ == "__main__":
    sys.exit(main())
