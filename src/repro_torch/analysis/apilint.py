"""AST lint for Future/Device API misuse (DSA1xx codes); the JAX package's
``repro.analysis.apilint``, which is pure Python (``ast``), carried over
rule for rule so that the port imports nothing of the reference.

The asynchronous submission API has four misuse patterns that type-check
fine, run fine in the small, and rot a real deployment:

  DSA101  dropped-future        the result of ``submit`` / an ``*_async``
                                helper is discarded as a bare statement.
                                The completion record leaks (nothing will
                                ever ``pop_completed`` it) and errors are
                                silently lost.
  DSA102  blocking-in-callback  ``result()`` / ``wait()`` / ``wait_all()``
                                etc. inside a ``then`` / ``add_done_callback``
                                / ``add_listener`` body.  Callbacks run on
                                the completion path — blocking there stalls
                                (or deadlocks) the engine that must make
                                the awaited work complete.  ``timeout=0``
                                polls are exempt.
  DSA103  raw-kick-loop         a ``while`` loop that drives progress by
                                calling ``.kick()`` directly instead of a
                                ``WaitPolicy`` — busy-spins the host CPU
                                the offload was supposed to free (paper
                                §3.3/Fig. 5).  The WaitPolicy internals
                                themselves carry suppressions.
  DSA104  swallowed-queuefull   a submit call inside ``try`` whose bare /
                                ``Exception`` handler neither re-raises nor
                                names ``QueueFull`` — overload becomes
                                silent data loss instead of backpressure.
  DSA105  trace-rate            a literal ``trace=`` / ``rate=`` sampling
                                rate outside [0, 1] at a ``make_device`` /
                                ``Device`` / ``TraceConfig`` call site.
                                The runtime rejects it too (the typed
                                ``TraceRateError``), but the lint catches
                                it before anything runs.
  DSA106  unbatched-submit-loop a ``for`` loop submitting one descriptor
                                per iteration — every iteration pays a full
                                doorbell (and on shared WQs the ENQCMD
                                round trip) that ``submit_many`` / a
                                ``submit_ring`` would amortize across the
                                burst (paper Fig. 3 / G1).  Conditional
                                submits (under ``if``/``try``), retry loops
                                (containing ``break``), and the batch entry
                                points themselves are exempt.

Suppression: append ``# dsalint: disable`` (all rules) or
``# dsalint: disable=DSA103`` / ``=DSA101,DSA104`` to the offending line.

Entry points: :func:`lint_source`, :func:`lint_file`, :func:`lint_paths`
(the reference's CLI, ``tools/dsalint.py``, drives the reference's copy).
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Union

#: rule code -> one-line description (the docs/analysis.md catalogue)
RULES: Dict[str, str] = {
    "DSA101": "dropped-future: submit result discarded, completion record "
              "leaks",
    "DSA102": "blocking-in-callback: result()/wait() inside a completion "
              "callback body",
    "DSA103": "raw-kick-loop: while-loop driving progress via .kick() "
              "instead of a WaitPolicy",
    "DSA104": "swallowed-queuefull: submit inside a bare/Exception handler "
              "that neither re-raises nor handles QueueFull",
    "DSA105": "trace-rate: literal trace=/rate= sampling rate outside "
              "[0, 1] at a make_device/Device/TraceConfig call site",
    "DSA106": "unbatched-submit-loop: per-descriptor submit in a loop — "
              "batch via submit_many/submit_ring to amortize the doorbell",
}

#: callee name -> keyword carrying a sampling rate in [0, 1] (DSA105)
TRACE_RATE_KWARGS: Dict[str, str] = {
    "make_device": "trace",
    "Device": "trace",
    "TraceConfig": "rate",
}

#: Device/engine methods whose return value is a Future (or a completion
#: handle) that must not be dropped.
SUBMIT_METHODS: Set[str] = {
    "submit", "submit_many",
    "memcpy_async", "dualcast_async", "fill_async", "compare_async",
    "compare_pattern_async", "crc32_async", "delta_create_async",
    "delta_apply_async", "dif_insert_async", "dif_check_async",
    "dif_strip_async", "batch_copy_async", "batch_async",
    "cache_flush_async", "copy_crc_async", "fill_verify_async",
}

#: batched submit entry points — one doorbell per burst, so calling them in
#: a loop is already amortized (exempt from DSA106).
BATCH_SUBMIT_METHODS: Set[str] = {
    "submit_many", "batch_async", "batch_copy_async",
}

#: Calls that block on completion (illegal inside callback bodies).
BLOCKING_METHODS: Set[str] = {
    "result", "wait", "wait_all", "wait_any", "as_completed", "drain",
}

#: Methods whose callable arguments are completion callbacks.
CALLBACK_REGISTRARS: Set[str] = {
    "then", "add_done_callback", "done_callback", "add_listener",
    "on_done",
}

_SUPPRESS_RE = re.compile(
    r"#\s*dsalint:\s*disable(?:\s*=\s*(?P<codes>[A-Z0-9,\s]+))?")


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str
    line: int
    col: int
    code: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"


def _suppressions(source: str) -> Dict[int, Optional[Set[str]]]:
    """line number -> None (suppress all) or the set of suppressed codes."""
    out: Dict[int, Optional[Set[str]]] = {}
    for lineno, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        codes = m.group("codes")
        if codes is None:
            out[lineno] = None
        else:
            out[lineno] = {c.strip() for c in codes.split(",") if c.strip()}
    return out


def _call_attr(node: ast.AST) -> Optional[str]:
    """The attribute name if ``node`` is a ``x.attr(...)`` call."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def _is_zero_timeout(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "timeout" and isinstance(kw.value, ast.Constant):
            if kw.value.value == 0:
                return True
    return False


def _callee_name(call: ast.Call) -> Optional[str]:
    """Bare or dotted callee name: ``make_device(...)`` / ``m.Device(...)``."""
    if isinstance(call.func, ast.Name):
        return call.func.id
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


def _const_number(node: ast.AST) -> Optional[float]:
    """The numeric value of a literal, seeing through unary +/- (a negative
    literal like ``-0.5`` parses as UnaryOp(USub, Constant), not Constant).
    Bools are excluded — ``trace=True`` means rate 1.0 and is always legal."""
    sign = 1.0
    while isinstance(node, ast.UnaryOp) and isinstance(
            node.op, (ast.UAdd, ast.USub)):
        if isinstance(node.op, ast.USub):
            sign = -sign
        node = node.operand
    if (isinstance(node, ast.Constant)
            and isinstance(node.value, (int, float))
            and not isinstance(node.value, bool)):
        return sign * float(node.value)
    return None


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.violations: List[Violation] = []
        self._suppress = _suppressions(source)
        # bodies of named functions registered as callbacks, found lazily
        self._local_funcs: Dict[str, ast.AST] = {}
        self._callback_checked: Set[int] = set()  # id() of visited bodies

    # ------------------------------------------------------------------ plumbing
    def _emit(self, node: ast.AST, code: str, message: str) -> None:
        line = getattr(node, "lineno", 0)
        sup = self._suppress.get(line)
        if sup is not None or line in self._suppress:
            if sup is None or code in sup:
                return
        self.violations.append(
            Violation(self.path, line, getattr(node, "col_offset", 0),
                      code, message))

    # ------------------------------------------------------------------ collection
    def visit_Module(self, node: ast.Module) -> None:
        for child in ast.walk(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._local_funcs[child.name] = child
        self.generic_visit(node)

    # ------------------------------------------------------------------ DSA101
    def visit_Expr(self, node: ast.Expr) -> None:
        attr = _call_attr(node.value)
        if attr in SUBMIT_METHODS:
            self._emit(node, "DSA101",
                       f"result of '{attr}(...)' discarded — the Future (and "
                       f"its completion record) leaks; bind it or wait on it")
        self.generic_visit(node)

    # ------------------------------------------------------------------ DSA102 / DSA105
    def visit_Call(self, node: ast.Call) -> None:
        attr = _call_attr(node)
        if attr in CALLBACK_REGISTRARS:
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                self._check_callback_body(arg)
        self._check_trace_rate(node)
        self.generic_visit(node)

    def _check_trace_rate(self, node: ast.Call) -> None:
        callee = _callee_name(node)
        kwarg = TRACE_RATE_KWARGS.get(callee or "")
        if kwarg is None:
            return
        for kw in node.keywords:
            if kw.arg != kwarg:
                continue
            value = _const_number(kw.value)
            if value is not None and not (0.0 <= value <= 1.0):
                self._emit(kw.value, "DSA105",
                           f"sampling rate {kwarg}={value:g} passed to "
                           f"'{callee}' is outside [0, 1] — the runtime "
                           f"raises TraceRateError; use a fraction of "
                           f"descriptors to sample")

    def _check_callback_body(self, arg: ast.AST) -> None:
        body: Optional[ast.AST] = None
        if isinstance(arg, ast.Lambda):
            body = arg.body
        elif isinstance(arg, ast.Name) and arg.id in self._local_funcs:
            body = self._local_funcs[arg.id]
        if body is None or id(body) in self._callback_checked:
            return
        self._callback_checked.add(id(body))
        for child in ast.walk(body):
            attr = _call_attr(child)
            if attr in BLOCKING_METHODS and not _is_zero_timeout(child):
                self._emit(child, "DSA102",
                           f"blocking '{attr}()' inside a completion "
                           f"callback — callbacks run on the completion "
                           f"path; use then()-chaining or timeout=0 polls")

    # ------------------------------------------------------------------ DSA103
    def visit_While(self, node: ast.While) -> None:
        for child in ast.walk(node):
            if _call_attr(child) == "kick":
                self._emit(node, "DSA103",
                           "while-loop drives progress via raw '.kick()' — "
                           "busy-spins the host; use a WaitPolicy "
                           "(wait/wait_all) instead")
                break
        self.generic_visit(node)

    # ------------------------------------------------------------------ DSA106
    #: subtrees skipped when hunting per-descriptor submits: conditional
    #: paths (if/try), nested scopes, and inner loops (which get their own
    #: visit_For pass and verdict)
    _DSA106_PRUNE = (ast.If, ast.IfExp, ast.Try, ast.For, ast.AsyncFor,
                     ast.While, ast.FunctionDef, ast.AsyncFunctionDef,
                     ast.Lambda)

    def visit_For(self, node: ast.For) -> None:
        self._check_submit_loop(node)
        self.generic_visit(node)

    visit_AsyncFor = visit_For

    def _check_submit_loop(self, node: ast.For) -> None:
        # a loop that can break or return out is a retry/backoff wrapper
        # around one logical submit, not a homogeneous fan-out — exempt
        own_exit = self._walk_pruned(
            node.body, (ast.For, ast.AsyncFor, ast.While,
                        ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
        if any(isinstance(n, (ast.Break, ast.Return)) for n in own_exit):
            return
        for child in self._walk_pruned(node.body, self._DSA106_PRUNE):
            attr = _call_attr(child)
            if attr in SUBMIT_METHODS and attr not in BATCH_SUBMIT_METHODS:
                self._emit(child, "DSA106",
                           f"per-descriptor '{attr}(...)' inside a loop — "
                           f"every iteration pays a full doorbell; batch "
                           f"the burst via submit_many()/submit_ring() "
                           f"(or batch_async) to amortize it")

    @staticmethod
    def _walk_pruned(stmts: Sequence[ast.AST], prune) -> Iterable[ast.AST]:
        """Walk statement subtrees, skipping pruned-type nodes entirely —
        whether they appear as direct body statements or deeper down."""
        stack = list(stmts)
        while stack:
            n = stack.pop()
            if isinstance(n, prune):
                continue
            yield n
            stack.extend(ast.iter_child_nodes(n))

    # ------------------------------------------------------------------ DSA104
    def visit_Try(self, node: ast.Try) -> None:
        has_submit = any(
            _call_attr(child) in SUBMIT_METHODS
            for stmt in node.body for child in ast.walk(stmt))
        if has_submit:
            for handler in node.handlers:
                if not self._catches_broadly(handler):
                    continue
                if self._handler_reraises_or_names_queuefull(handler):
                    continue
                self._emit(handler, "DSA104",
                           "submit wrapped in a bare/broad except that "
                           "neither re-raises nor handles QueueFull — "
                           "overload becomes silent loss")
        self.generic_visit(node)

    @staticmethod
    def _catches_broadly(handler: ast.ExceptHandler) -> bool:
        t = handler.type
        if t is None:
            return True
        names: List[str] = []
        for n in [t] + (list(t.elts) if isinstance(t, ast.Tuple) else []):
            if isinstance(n, ast.Name):
                names.append(n.id)
            elif isinstance(n, ast.Attribute):
                names.append(n.attr)
        return any(n in ("Exception", "BaseException") for n in names)

    @staticmethod
    def _handler_reraises_or_names_queuefull(
            handler: ast.ExceptHandler) -> bool:
        for child in ast.walk(handler):
            if isinstance(child, ast.Raise):
                return True
            if isinstance(child, ast.Name) and child.id == "QueueFull":
                return True
            if isinstance(child, ast.Attribute) and child.attr == "QueueFull":
                return True
        return False


# --------------------------------------------------------------------------- entry points
def lint_source(source: str, path: str = "<string>",
                select: Optional[Iterable[str]] = None) -> List[Violation]:
    """Lint one source string; returns violations sorted by position."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Violation(path, exc.lineno or 0, exc.offset or 0, "DSA100",
                          f"syntax error: {exc.msg}")]
    linter = _Linter(path, source)
    linter.visit(tree)
    out = sorted(linter.violations, key=lambda v: (v.line, v.col, v.code))
    if select is not None:
        wanted = set(select)
        out = [v for v in out if v.code in wanted]
    return out


def lint_file(path: Union[str, pathlib.Path],
              select: Optional[Iterable[str]] = None) -> List[Violation]:
    p = pathlib.Path(path)
    return lint_source(p.read_text(encoding="utf-8"), str(p), select=select)


def lint_paths(paths: Sequence[Union[str, pathlib.Path]],
               select: Optional[Iterable[str]] = None) -> List[Violation]:
    """Lint files and/or directory trees (``*.py``, skipping __pycache__)."""
    files: List[pathlib.Path] = []
    for raw in paths:
        p = pathlib.Path(raw)
        if p.is_dir():
            files.extend(sorted(
                f for f in p.rglob("*.py") if "__pycache__" not in f.parts))
        elif p.suffix == ".py":
            files.append(p)
    out: List[Violation] = []
    for f in files:
        out.extend(lint_file(f, select=select))
    return out
