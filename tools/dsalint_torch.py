#!/usr/bin/env python
"""dsalint on the PyTorch port: Future/Device API lint over the repo's own
source.

Runs the ``repro_torch.analysis.apilint`` AST rules (DSA1xx) over files and
directory trees and prints ``path:line:col: CODE message`` per finding.
Exit status 1 if any violations, 0 on a clean tree.  It imports no torch
and needs no card.

    python tools/dsalint_torch.py                      # default: src tests benchmarks examples tools
    python tools/dsalint_torch.py src/repro_torch/core # specific trees/files
    python tools/dsalint_torch.py --list-rules         # rule catalogue (see docs/analysis.md)
    python tools/dsalint_torch.py --select DSA101,DSA103 src

Suppress a finding in place with ``# dsalint: disable=DSA103`` (or a bare
``# dsalint: disable`` for all rules) on the offending line.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis import apilint  # noqa: E402

DEFAULT_PATHS = ("src", "tests", "benchmarks", "examples", "tools")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dsalint_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", help="files or directory trees "
                    f"(default: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule codes to enable (default all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code in sorted(apilint.RULES):
            print(f"{code}  {apilint.RULES[code]}")
        return 0

    paths = args.paths or [str(ROOT / p) for p in DEFAULT_PATHS
                           if (ROOT / p).exists()]
    select = ([c.strip() for c in args.select.split(",") if c.strip()]
              if args.select else None)
    violations = apilint.lint_paths(paths, select=select)
    for v in violations:
        print(v)
    if violations:
        print(f"dsalint: {len(violations)} violation(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
