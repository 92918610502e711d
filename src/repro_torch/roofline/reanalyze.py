"""Recompute roofline terms from saved op logs without running the step
again (the JAX package's ``repro.roofline.reanalyze`` in PyTorch).

    PYTHONPATH=src python -m repro_torch.roofline.reanalyze \
        --ops results/ops --dryrun results/dryrun_torch

The dry run writes one ``<cell>.ops.jsonl.gz`` per cell with ``--save-ops``
(the counterpart of the reference's ``--save-hlo``): the op counter's
records, one JSON object a line.  This updates the per-cell JSONs in place
with the current cost model (``op_cost``) and ``H100``; used when the cost
model improves after an expensive sweep.
"""
from __future__ import annotations

import argparse
import gzip
import json
from pathlib import Path

from repro_torch.roofline.analysis import roofline_terms
from repro_torch.roofline.op_cost import analyze_log


def read_ops(path: Path) -> list:
    with gzip.open(path, "rt") as f:
        return [json.loads(line) for line in f]


def reanalyze(ops_dir: Path, dryrun_dir: Path) -> int:
    n = 0
    for gz in sorted(ops_dir.glob("*.ops.jsonl.gz")):
        cell = gz.name.replace(".ops.jsonl.gz", "")
        jpath = dryrun_dir / f"{cell}.json"
        if not jpath.exists():
            print(f"[skip] no json for {cell}")
            continue
        rec = json.loads(jpath.read_text())
        cost = analyze_log(read_ops(gz))
        rec["flops_per_dev"] = float(cost.flops)
        rec["bytes_per_dev"] = float(cost.bytes)
        rec["collective_bytes_per_dev"] = float(cost.coll_bytes)
        rec["collective_ops"] = {k: dict(v) for k, v in cost.coll_ops.items()}
        rec.update(roofline_terms(cost.flops, cost.bytes, cost.coll_bytes))
        mf = rec.get("model_flops_total", 0.0)
        n_chips = rec.get("n_chips", 1)
        rec["useful_flops_ratio"] = round(mf / (cost.flops * n_chips), 4) if cost.flops else 0.0
        jpath.write_text(json.dumps(rec, indent=1, default=str))
        n += 1
    return n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ops", default="results/ops")
    ap.add_argument("--dryrun", default="results/dryrun_torch")
    args = ap.parse_args()
    n = reanalyze(Path(args.ops), Path(args.dryrun))
    print(f"reanalyzed {n} cells")


if __name__ == "__main__":
    main()
