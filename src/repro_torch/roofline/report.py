"""Roofline report generator (the JAX package's ``repro.roofline.report``
in PyTorch): reads the dry run's per-cell JSONs and prints the dry-run and
roofline tables.  It reads both packages' records; the capacity column is
``H100.hbm_bytes``'s.  With ``--reference`` (the reference's own counts,
``tools/dryrun_reference_counts.py``) each table gains the reference's
FLOPs per rank and the port's over it.

    PYTHONPATH=src python -m repro_torch.roofline.report --dryrun results/dryrun_torch \
        --reference docs/dryrun_reference_counts.json
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.roofline.analysis import H100


def _advice(rec: dict) -> str:
    b = rec.get("bottleneck", "")
    kind = rec["shape"].split("_")[0]
    if b == "compute":
        if rec.get("useful_flops_ratio", 1) < 0.5:
            return "compute-bound with low useful-flops: cut remat recompute / replicated attention math"
        return "compute-bound near roofline: only larger per-chip batch or quantization moves it"
    if b == "memory":
        if kind in ("decode", "long"):
            return "HBM-bound on KV reads: shrink cache dtype (int8 KV) or shard cache seq further"
        return "HBM-bound: raise arithmetic intensity (fuse, larger microbatch) or cut remat traffic"
    if b == "collective":
        return "ICI-bound: reshard to cut all-gathers (seq-parallel attention / a2a MoE dispatch), overlap with compute"
    return ""


def load(dryrun_dir: Path, tag: str = "") -> List[dict]:
    recs = []
    for p in sorted(dryrun_dir.glob("*.json")):
        name = p.stem
        if tag and not name.endswith(tag):
            continue
        recs.append(json.loads(p.read_text()))
    return recs


def fmt_seconds(s) -> str:
    if s is None:
        return "-"
    if s >= 1:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s*1e3:.2f}ms"
    return f"{s*1e6:.1f}us"


def load_reference(path: Path) -> Dict[str, dict]:
    """The reference's counts, ``{"<mesh>/<arch>/<shape>": {...}}``, as
    ``tools/dryrun_reference_counts.py`` writes them."""
    return json.loads(Path(path).read_text())


def _vs_reference(r: dict, reference: Dict[str, dict]) -> str:
    """The two reference columns of a row: the reference's FLOPs per rank,
    and the port's over it."""
    ref = reference.get(f"{r.get('mesh')}/{r['arch']}/{r['shape']}", {})
    want = ref.get("flops_per_dev") if ref.get("status") == "ok" else None
    got = r.get("flops_per_dev") if r["status"] == "ok" else None
    return " {} | {} |".format(f"{want:.4g}" if want else "-",
                               f"{got / want:.3f}" if want and got else "-")


def table(recs: List[dict], mesh: str, reference: Optional[Dict[str, dict]] = None) -> str:
    """One mesh's table (the reference's layout); given ``reference``
    counts, two more columns after useful-FLOPs: the reference's FLOPs per
    rank and the port's over it."""
    rows = [r for r in recs if r.get("mesh") == mesh]
    ref_head, ref_rule = (" ref FLOPs/rank | port ÷ ref |", "---|---|") if reference else ("", "")
    out = [
        f"### Mesh: {mesh} ({'2x16x16=512' if mesh == 'multi' else '16x16=256'} chips)",
        "",
        f"| arch | shape | status | compute | memory | collective | bottleneck | useful-FLOPs |"
        f"{ref_head} HBM/dev | fits {H100.hbm_bytes / 1e9:.0f}GB | next lever |",
        "|---|---|---|---|---|---|---|---|" + ref_rule + "---|---|---|",
    ]
    for r in rows:
        ref = _vs_reference(r, reference) if reference else ""
        if r["status"] != "ok":
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['status'].upper()} "
                f"| - | - | - | - | - |{ref} - | - | {r.get('reason','')[:80]} |"
            )
            continue
        out.append(
            "| {arch} | {shape} | ok | {c} | {m} | {k} | **{b}** | {u:.2f} |{ref} {h:.1f}GB | {f} | {adv} |".format(
                arch=r["arch"], shape=r["shape"],
                c=fmt_seconds(r.get("compute_s")), m=fmt_seconds(r.get("memory_s")),
                k=fmt_seconds(r.get("collective_s")), b=r.get("bottleneck", "?"),
                u=r.get("useful_flops_ratio", 0), ref=ref, h=r.get("hbm_per_dev_gb", 0),
                f="yes" if r.get("fits_hbm") else "NO",
                adv=_advice(r),
            )
        )
    return "\n".join(out)


def summary(recs: List[dict]) -> str:
    n_ok = sum(r["status"] == "ok" for r in recs)
    n_skip = sum(r["status"] == "skip" for r in recs)
    n_err = sum(r["status"] == "error" for r in recs)
    n_late = sum(r["status"] == "timeout" for r in recs)
    by_bottleneck = defaultdict(int)
    for r in recs:
        if r["status"] == "ok":
            by_bottleneck[r["bottleneck"]] += 1
    worst = sorted(
        (r for r in recs if r["status"] == "ok" and r["shape"] == "train_4k"),
        key=lambda r: r.get("useful_flops_ratio", 0),
    )[:3]
    lines = [
        f"cells: {n_ok} ok / {n_skip} skip / {n_err} error"
        + (f" / {n_late} not counted (timeout)" if n_late else ""),
        "bottleneck histogram: " + ", ".join(f"{k}={v}" for k, v in sorted(by_bottleneck.items())),
        "lowest useful-FLOPs train cells: "
        + ", ".join(f"{r['arch']}({r['useful_flops_ratio']:.2f})" for r in worst),
    ]
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="results/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--reference", default=None,
                    help="the reference's counts (docs/dryrun_reference_counts.json): adds "
                         "its FLOPs per rank and the port's over it")
    args = ap.parse_args()
    recs = load(Path(args.dryrun), args.tag)
    reference = load_reference(Path(args.reference)) if args.reference else None
    print(summary(recs))
    print()
    for mesh in ("single", "multi"):
        print(table(recs, mesh, reference))
        print()


if __name__ == "__main__":
    main()
