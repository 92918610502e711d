"""Roofline report generator (the JAX package's ``repro.roofline.report``
in PyTorch): reads the dry run's per-cell JSONs and prints the dry-run and
roofline tables.  It reads both packages' records; the capacity column is
``H100.hbm_bytes``'s.  With ``--reference`` (the reference's own counts,
``tools/dryrun_reference_counts.py``) each table gains the reference's
FLOPs per rank and the port's over it.  With ``--full`` (the records of a
count that ran every loop trip, ``launch/dryrun.py --loops all``) each
table gains the records' FLOPs and HBM a rank over that count's, and the
summary the largest departure of each.  With ``--previous`` (an earlier
report, as written here with ``--reference``) the cells the records do not
hold keep that report's rows, and a last column says which run counted
each cell (``--label`` / ``--previous-label``).  The summary says how the
records counted loops (``loops``: "once" a trip times the trip count,
"all" every trip), where they say.

    PYTHONPATH=src python -m repro_torch.roofline.report --dryrun results/dryrun_torch \
        --reference docs/dryrun_reference_counts.json
"""
from __future__ import annotations

import argparse
import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

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


def _key(r: dict) -> tuple:
    return (r.get("mesh"), r["arch"], r["shape"])


def vs_full(r: dict, full: Dict[tuple, dict]) -> Optional[Tuple[float, float]]:
    """A record's FLOPs and HBM a rank over those of the full count of the
    same cell, or None where either is not an ok count."""
    f = full.get(_key(r))
    if r["status"] != "ok" or not f or f.get("status") != "ok" or "flops_per_dev" not in r:
        return None
    return r["flops_per_dev"] / f["flops_per_dev"], r["hbm_per_dev_gb"] / f["hbm_per_dev_gb"]


def table(recs: List[dict], mesh: str, reference: Optional[Dict[str, dict]] = None,
          full: Optional[Dict[tuple, dict]] = None) -> str:
    """One mesh's table (the reference's layout); given ``reference``
    counts, two more columns after useful-FLOPs: the reference's FLOPs per
    rank and the port's over it; given ``full`` records (by ``(mesh, arch,
    shape)``), a column of the FLOPs and HBM a rank over theirs; where the
    records say which run counted them (``counted_in``), a last column
    with it."""
    rows = [r for r in recs if r.get("mesh") == mesh]
    ref_head, ref_rule = (" ref FLOPs/rank | port ÷ ref |", "---|---|") if reference else ("", "")
    full_head, full_rule = (" FLOPs, HBM ÷ full |", "---|") if full is not None else ("", "")
    runs = any("counted_in" in r for r in rows)
    run_head, run_rule = (" counted in |", "---|") if runs else ("", "")
    out = [
        f"### Mesh: {mesh} ({'2x16x16=512' if mesh == 'multi' else '16x16=256'} chips)",
        "",
        f"| arch | shape | status | compute | memory | collective | bottleneck | useful-FLOPs |"
        f"{ref_head} HBM/dev | fits {H100.hbm_bytes / 1e9:.0f}GB | next lever |{full_head}"
        f"{run_head}",
        "|---|---|---|---|---|---|---|---|" + ref_rule + "---|---|---|" + full_rule + run_rule,
    ]
    for r in rows:
        ref = _vs_reference(r, reference) if reference else ""
        run = f" {r.get('counted_in', '-')} |" if runs else ""
        if full is not None:
            ratios = vs_full(r, full)
            run = (f" {ratios[0]:.6f}, {ratios[1]:.3f} |" if ratios else " - |") + run
        if r["status"] != "ok":
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['status'].upper()} "
                f"| - | - | - | - | - |{ref} - | - | {r.get('reason','')[:80]} |{run}"
            )
            continue
        out.append(
            "| {arch} | {shape} | ok | {c} | {m} | {k} | **{b}** | {u:.2f} |{ref} {h:.1f}GB | {f} | {adv} |{run}".format(
                arch=r["arch"], shape=r["shape"],
                c=fmt_seconds(r.get("compute_s")), m=fmt_seconds(r.get("memory_s")),
                k=fmt_seconds(r.get("collective_s")), b=r.get("bottleneck", "?"),
                u=r.get("useful_flops_ratio", 0), ref=ref, h=r.get("hbm_per_dev_gb", 0),
                f="yes" if r.get("fits_hbm") else "NO",
                adv=_advice(r), run=run,
            )
        )
    return "\n".join(out)


def _seconds(text: str) -> Optional[float]:
    """``fmt_seconds``'s text back to seconds ("-" is None)."""
    m = re.fullmatch(r"([0-9.]+)(s|ms|us)", text)
    return float(m.group(1)) * {"s": 1.0, "ms": 1e-3, "us": 1e-6}[m.group(2)] if m else None


def records_from_report(text: str, reference: Dict[str, dict]) -> List[dict]:
    """The records behind an earlier report's tables (``table``'s rows with
    the reference's columns), as far as its rows show them: the status,
    the three terms, the bottleneck, useful-FLOPs, HBM a rank and whether
    it fits, the FLOPs a rank (the reference's count times the row's
    ratio, which the row shows to 3 decimals), or the reason a cell was
    not counted; and the run that counted it, where the row says.  Columns
    are found by their heads."""
    recs, mesh, col = [], None, {}
    for line in text.splitlines():
        head = re.match(r"### Mesh: (single|multi)", line)
        if head:
            mesh, col = head.group(1), {}
            continue
        cols = [c.strip() for c in line.strip().strip("|").split("|")]
        if mesh is None or len(cols) < 13 or cols[0] == "" or cols[0].startswith("-"):
            continue
        if cols[0] == "arch":
            col = {name: i for i, name in enumerate(cols)}
            continue
        arch, shape, status = cols[0], cols[1], cols[2].lower()
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": status}
        if status != "ok":
            rec["reason"] = cols[col["next lever"]]
        else:
            ref = reference.get(f"{mesh}/{arch}/{shape}", {}).get("flops_per_dev")
            hbm = col["HBM/dev"]
            rec.update(compute_s=_seconds(cols[3]), memory_s=_seconds(cols[4]),
                       collective_s=_seconds(cols[5]), bottleneck=cols[6].strip("*"),
                       useful_flops_ratio=float(cols[7]),
                       hbm_per_dev_gb=float(cols[hbm].rstrip("GB")),
                       fits_hbm=cols[hbm + 1] == "yes")
            if ref and cols[col["port ÷ ref"]] != "-":
                rec["flops_per_dev"] = ref * float(cols[col["port ÷ ref"]])
        if "counted in" in col:
            rec["counted_in"] = cols[col["counted in"]]
        recs.append(rec)
    return recs


def full_departures(recs: List[dict], full: Dict[tuple, dict]) -> str:
    """The line on the records against a full count: how many cells both
    counted, and the largest departure of their FLOPs and HBM a rank."""
    ratios = [(vs_full(r, full), r) for r in recs]
    ratios = [(q, r) for q, r in ratios if q]
    if not ratios:
        return "against the full count: no cell counted by both"
    (f, _), rf = max(ratios, key=lambda qr: abs(qr[0][0] - 1))
    (_, h), rh = max(ratios, key=lambda qr: abs(qr[0][1] - 1))
    return (f"against the full count ({len(ratios)} cells): FLOPs/rank within "
            f"{abs(f - 1):.2e} ({' '.join(_key(rf))}), HBM/rank within {abs(h - 1):.2%} "
            f"({' '.join(_key(rh))}: {h:.4f})")


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
    runs = defaultdict(int)
    for r in recs:
        if "counted_in" in r:
            runs[r["counted_in"]] += 1
    modes = defaultdict(int)
    for r in recs:
        if r["status"] == "ok" and "loops" in r:
            modes[r["loops"]] += 1
    lines = [
        f"cells: {n_ok} ok / {n_skip} skip / {n_err} error"
        + (f" / {n_late} not counted (timeout)" if n_late else ""),
    ] + ([", ".join(f"counted in {k}: {v}" for k, v in runs.items())] if runs else []) + (
        ["loops counted: " + ", ".join(f"{k}={v}" for k, v in sorted(modes.items()))]
        if modes else []) + [
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
    ap.add_argument("--previous", default=None,
                    help="an earlier report with --reference: the cells the records do not "
                         "hold keep its rows")
    ap.add_argument("--full", default=None,
                    help="records of a count that ran every loop trip (--loops all): adds "
                         "the FLOPs and HBM a rank over theirs")
    ap.add_argument("--label", default="this run", help="names the records' run")
    ap.add_argument("--previous-label", default="earlier", help="names the earlier run")
    args = ap.parse_args()
    recs = load(Path(args.dryrun), args.tag)
    reference = load_reference(Path(args.reference)) if args.reference else None
    if args.previous:
        if reference is None:
            ap.error("--previous needs --reference")
        have = {(r["mesh"], r["arch"], r["shape"]) for r in recs}
        recs = [dict(r, counted_in=args.label) for r in recs] + [
            {"counted_in": args.previous_label, **r}
            for r in records_from_report(Path(args.previous).read_text(), reference)
            if (r["mesh"], r["arch"], r["shape"]) not in have]
        recs.sort(key=lambda r: (r["mesh"], r["arch"], r["shape"]))
    full = {_key(r): r for r in load(Path(args.full))} if args.full else None
    print(summary(recs))
    if full is not None:
        print(full_departures(recs, full))
    print()
    for mesh in ("single", "multi"):
        print(table(recs, mesh, reference, full))
        print()


if __name__ == "__main__":
    main()
