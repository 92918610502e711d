"""The port's ``repro_torch.analysis.apilint`` against the JAX package's
``repro.analysis.apilint`` (pure AST, copied rule for rule): identical
violations (code, line, column, message) on every source string the
reference's ``tests/test_apilint.py`` lints, and on every Python file of
the repository's ``src/``, ``tests/``, ``benchmarks/``, ``examples/`` and
``tools/``."""
import ast
import pathlib
import textwrap

import pytest

from repro.analysis import apilint as ref
from repro_torch.analysis import apilint as port

ROOT = pathlib.Path(__file__).resolve().parent.parent
TREES = ("src", "tests", "benchmarks", "examples", "tools")


def _fixtures():
    """Every string literal the reference's apilint tests lint: the sources
    passed to ``_codes(...)``, ``lint_source(...)`` and assigned to ``src``."""
    tree = ast.parse((ROOT / "tests" / "test_apilint.py").read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = getattr(node.func, "id", None) or getattr(node.func, "attr", None)
            if name in ("_codes", "lint_source") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    out.append(textwrap.dedent(arg.value))
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
                and any(getattr(t, "id", "") == "src" for t in node.targets)):
            out.append(node.value.value)
    return out


FIXTURES = _fixtures()


def _found(mod, source, path="<string>"):
    return [(v.code, v.line, v.col, v.message) for v in mod.lint_source(source, path=path)]


def test_the_fixtures_were_found():
    # the reference's file lints 25 sources; each rule fires among them
    assert len(FIXTURES) >= 25
    codes = {c for src in FIXTURES for c, *_ in _found(ref, src)}
    assert {"DSA100", "DSA101", "DSA102", "DSA103", "DSA104", "DSA105"} <= codes


@pytest.mark.parametrize("i", range(len(FIXTURES)))
def test_fixture_violations_are_identical(i):
    src = FIXTURES[i]
    assert _found(port, src) == _found(ref, src)


@pytest.mark.parametrize("tree", TREES)
def test_repository_tree_violations_are_identical(tree):
    files = sorted(f for f in (ROOT / tree).rglob("*.py") if "__pycache__" not in f.parts)
    assert files
    for f in files:
        src = f.read_text(encoding="utf-8")
        assert _found(port, src, str(f)) == _found(ref, src, str(f)), f


def test_rule_tables_are_the_references():
    assert port.RULES == ref.RULES
    assert port.SUBMIT_METHODS == ref.SUBMIT_METHODS
    assert port.BATCH_SUBMIT_METHODS == ref.BATCH_SUBMIT_METHODS
    assert port.BLOCKING_METHODS == ref.BLOCKING_METHODS
    assert port.CALLBACK_REGISTRARS == ref.CALLBACK_REGISTRARS
    assert port.TRACE_RATE_KWARGS == ref.TRACE_RATE_KWARGS


def test_lint_paths_and_select_match(tmp_path):
    (tmp_path / "a.py").write_text("def f(d, b):\n    d.submit(b)\n")
    (tmp_path / "b.py").write_text("def f(d, r):\n    while not r.is_done():\n        d.kick()\n")
    for select in (None, ["DSA103"]):
        got = [(v.code, v.line, v.col) for v in port.lint_paths([tmp_path], select=select)]
        want = [(v.code, v.line, v.col) for v in ref.lint_paths([tmp_path], select=select)]
        assert got == want and got


def test_the_port_lists_apilint_among_its_analyses():
    import repro_torch.analysis as analysis

    assert "apilint" in analysis.__all__ and analysis.apilint is port
