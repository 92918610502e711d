"""The JAX package's dry-run counts, cell by cell, for the port to be held
against.

    PYTHONPATH=src python tools/dryrun_reference_counts.py --jobs 3 \
        --out docs/dryrun_reference_counts.json

Runs ``python -m repro.launch.dryrun`` once for each (arch x shape x mesh)
cell, each in a process of its own (the module sets ``XLA_FLAGS`` to 512
virtual devices at import, before JAX starts), ``--jobs`` at a time, and
keeps from each record only its counts: ``status``, ``n_chips``,
``flops_per_dev``, ``collective_bytes_per_dev`` and ``useful_flops_ratio``.
The reference's times, memory sizes and ``fits_hbm`` are figures for its
own accelerator's constants; they are dropped here and never written.

The output is one JSON object keyed ``"<mesh>/<arch>/<shape>"`` (mesh
``single`` = 16x16, ``multi`` = 2x16x16), read by
``repro_torch.roofline.report --reference`` and by ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

#: the record keys kept: counts only
KEPT = ("status", "n_chips", "flops_per_dev", "collective_bytes_per_dev", "useful_flops_ratio")
MESHES = ("single", "multi")


def cells() -> list:
    """Every (arch, shape) the reference's ``all_cells`` lists, read in a
    subprocess so this process never imports JAX."""
    code = "import json; from repro.configs import all_cells; print(json.dumps(all_cells()))"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return [tuple(c) for c in json.loads(res.stdout.strip().splitlines()[-1])]


def count_cell(arch: str, shape: str, mesh: str, timeout: float) -> dict:
    """One cell's counts from a ``repro.launch.dryrun`` process of its own."""
    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, "-m", "repro.launch.dryrun", "--arch", arch, "--shape", shape,
               "--mesh", mesh, "--out", out]
        t0 = time.perf_counter()
        try:
            subprocess.run(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                           timeout=timeout, env=dict(os.environ, JAX_PLATFORMS="cpu"))
        except subprocess.TimeoutExpired:
            return {"status": "timeout"}
        path = Path(out) / f"{mesh}__{arch}__{shape}.json"
        if not path.exists():
            return {"status": "error"}
        rec = json.loads(path.read_text())
    kept = {k: rec[k] for k in KEPT if k in rec}
    print(f"[{kept['status']:7s}] {mesh:6s} {arch:28s} {shape:12s} "
          f"{time.perf_counter() - t0:7.1f} s", flush=True)
    return kept


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="docs/dryrun_reference_counts.json")
    ap.add_argument("--jobs", type=int, default=2, help="cells counted side by side")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds a cell's process may take")
    args = ap.parse_args(argv)

    todo = [(a, s, m) for a, s in cells() for m in MESHES]
    with ThreadPoolExecutor(args.jobs) as pool:
        recs = list(pool.map(lambda c: count_cell(*c, args.timeout), todo))
    got = {f"{m}/{a}/{s}": rec for (a, s, m), rec in zip(todo, recs)}
    Path(args.out).write_text(json.dumps(dict(sorted(got.items())), indent=1) + "\n")
    bad = [k for k, r in got.items() if r["status"] not in ("ok", "skip")]
    print(f"{len(got)} cells, {len(bad)} not ok: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
