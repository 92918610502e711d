"""Multi-pod dry run: build every (architecture x input shape) step on the
production meshes with NO memory, and count it (the JAX package's
``repro.launch.dryrun`` in PyTorch).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch

The reference lowers and compiles each cell with XLA over abstract inputs
on 512 virtual devices and walks the compiled HLO.  The port has no
compiler.  Here the world is the fake process group (512 ranks, set up by
``main`` / ``dryrun_cell`` when a cell needs it, never at import); every
tensor is a fake one (``FakeTensorMode``: shapes, no storage); parameters,
optimizer state (ZeRO-1 by default), batch and cache are laid out as
DTensors by the reference's rules; and one train, prefill or decode step
runs eagerly under ``repro_torch.roofline.op_cost.OpCounter``, which sees
the ops rank 0 runs on its shards.  Nothing touches a card, so the dry run
runs the same in any process with torch.

Attention takes the chunked path, the reference's ``lower_cell`` default:
the flash kernel is an opaque ctypes launch, which a fake tensor cannot
feed and a count cannot see into.
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from repro_torch import tree as ttree
from repro_torch.configs import SHAPES_BY_NAME, all_cells, applicable, get_config
from repro_torch.distributed.annotate import use_rules
from repro_torch.distributed.params import opt_state_shardings, tree_shardings
from repro_torch.distributed.sharding import place, rules_for_mesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.roofline.analysis import H100, model_flops_for_cell, roofline_terms

# per-arch training knobs (memory realism at 256/512 chips)
MICRO_STEPS = {"deepseek-67b": 8, "llama4-maverick-400b-a17b": 8}
FSDP_ARCHS = {"llama4-maverick-400b-a17b"}

#: ranks of the fake world: the multi-pod mesh's; the single-pod mesh uses
#: the first 256
WORLD = 512


def make_cell_rules(mesh, cfg, shape, overrides=None):
    """Sharding rules for one cell, including the divisibility-driven
    seq-sharded-KV fallback and FSDP for very large MoE."""
    ov = dict(overrides or {})
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    if shape.kind in ("decode", "prefill") and cfg.num_kv_heads and cfg.num_kv_heads % tp != 0:
        # KV heads not TP-shardable -> shard the cache sequence dim instead
        ov.setdefault("seq", "model")
    if cfg.name in FSDP_ARCHS:
        # 400B params don't fit at TP16 even for serving: shard expert
        # weights over the data axes too (weights all-gather per layer)
        data_axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
        ov.setdefault("fsdp", data_axes)
    return rules_for_mesh(mesh, overrides=ov)


def batch_specs(cfg, shape) -> dict:
    """name -> (global shape, dtype) of one cell's batch (the reference's
    ``make_batch_specs``).  A decode cell's batch is its new tokens; the
    cache is an input of its own."""
    bsz, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((bsz, 1), torch.int32)}
    specs = {"tokens": ((bsz, S), torch.int32)}
    if shape.kind == "train":
        specs["loss_mask"] = ((bsz, S), torch.float32)
    dt = getattr(torch, cfg.dtype)
    if cfg.vlm is not None:
        specs["patch_embeds"] = ((bsz, cfg.vlm.num_patches, cfg.d_model), dt)
        specs["positions_thw"] = ((3, bsz, S), torch.int32)
    if cfg.encoder is not None:
        specs["frame_embeds"] = ((bsz, cfg.encoder.source_len, cfg.d_model), dt)
    return specs


def _local(x):
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of the tensors in ``tree``."""
    return sum(_local(t).numel() * _local(t).element_size() for t in ttree.leaves(tree)
               if isinstance(t, torch.Tensor))


def _storages(tree) -> dict:
    out = {}
    for t in ttree.leaves(tree):
        if isinstance(t, torch.Tensor):
            st = _local(t).untyped_storage()
            out[id(st)] = st
    return out


@contextlib.contextmanager
def _strided_offsets_outside_modes():
    """DTensor finds a strided shard's offsets by ``.tolist()`` of an index
    tensor it makes with ``torch.arange``; under ``FakeTensorMode`` that
    tensor is fake and has no values.  Within the block that index
    arithmetic runs outside the dispatch modes, on real tensors: it reads
    no data of the step, and the counter does not see it."""
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils._python_dispatch import _disable_current_modes

    orig = _StridedShard.__dict__["local_shard_size_and_offset"]

    def outside(*args, **kwargs):
        with _disable_current_modes():
            return orig(*args, **kwargs)

    _StridedShard.local_shard_size_and_offset = outside
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def _laid_out(tree, mesh, rules):
    return ttree.tree_map(place, tree, tree_shardings(tree, mesh, rules))


def cell_step(model, shape, mesh, rules, gen, *, micro_steps=1, zero1=True, zero2=False):
    """One cell's step and its inputs, laid out on ``mesh`` by ``rules``:
    (step, args), with the parameters drawn from ``gen`` on its device, a
    batch of zeros (a loss mask of ones), AdamW state (ZeRO-1 unless ``zero1`` is False; ZeRO-2
    gradients with ``zero2``) for a train step and an empty cache for a
    decode step.  Call it under ``use_rules`` (and ``FakeTensorMode`` for
    the dry run; with real tensors it builds the same step on a card)."""
    cfg, dev = model.cfg, gen.device
    params = _laid_out(model.init(gen), mesh, rules)
    batch = {k: (torch.ones if k == "loss_mask" else torch.zeros)(s, dtype=d, device=dev)
             for k, (s, d) in batch_specs(cfg, shape).items()}
    batch = _laid_out(batch, mesh, rules)
    if shape.kind == "train":
        opt = AdamW(lr=cosine_schedule(3e-4, 100, 10_000))
        opt_sh = opt_state_shardings(None, params, mesh, rules, zero1=zero1)
        opt_state = ttree.tree_map(place, opt.init(params), opt_sh)
        step = make_train_step(model, opt, micro_steps=micro_steps,
                               grad_shardings=opt_sh.m if zero2 else None)
        return step, (params, opt_state, batch)
    if shape.kind == "prefill":
        return make_prefill_step(model, max_cache_len=shape.seq_len), (params, batch)
    cache = _laid_out(model.init_cache(shape.global_batch, shape.seq_len), mesh, rules)
    return make_decode_step(model), (params, cache, batch["tokens"])


def lower_cell(arch: str, shape_name: str, mesh, *, moe_dispatch="dense", zero1=True,
               remat=True, rules_overrides=None, micro_steps=None, attn_impl="chunked",
               no_fsdp=False, tp_comm="auto", remat_group=1, zero2=False, cfg=None,
               shape=None, device="cpu"):
    """Build one cell's step with fake tensors laid out on ``mesh`` and run
    it once under the op counter.  Returns (counter, meta): ``meta`` holds
    the cell's ``cfg``, ``shape`` and ``rules``, its ``memory`` (this rank's
    argument, output, aliased and peak temporary bytes) and the seconds to
    build (``build_s``) and count (``count_s``).  ``cfg`` and ``shape``
    replace the arch's config and the named shape (a reduced config on a
    small mesh); ``device`` is where the fake tensors claim to live (the
    mesh's device type)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.roofline.op_cost import OpCounter

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES_BY_NAME[shape_name]
    if no_fsdp:
        rules_overrides = dict(rules_overrides or {})
        rules_overrides.setdefault("fsdp", None)
    rules = make_cell_rules(mesh, cfg, shape, rules_overrides)
    t0 = time.perf_counter()
    model = build_model(cfg, mesh=mesh, moe_dispatch=moe_dispatch, remat=remat,
                        attn_impl=attn_impl, tp_comm=tp_comm, remat_group=remat_group,
                        device=device)
    ms = micro_steps if micro_steps is not None else MICRO_STEPS.get(arch, 1)
    with FakeTensorMode(), use_rules(mesh, rules), _strided_offsets_outside_modes():
        step, args = cell_step(model, shape, mesh, rules, torch.Generator(device=device),
                               micro_steps=ms, zero1=zero1, zero2=zero2)
        build_s = time.perf_counter() - t0
        arg_storages = _storages(args)
        t0 = time.perf_counter()
        with OpCounter() as counter:
            out = step(*args)
        count_s = time.perf_counter() - t0
        out_storages = _storages(out)
        aliased = [st for k, st in out_storages.items() if k in arg_storages]
        memory = dict(argument_bytes=local_bytes(args), output_bytes=local_bytes(out),
                      temp_bytes=counter.peak_bytes,
                      alias_bytes=sum(st.nbytes() for st in aliased))
    return counter, dict(cfg=cfg, shape=shape, rules=rules, memory=memory,
                         build_s=build_s, count_s=count_s)


def fake_world(world: int = WORLD) -> None:
    """The fake process group of ``world`` ranks (this process is rank 0),
    unless a group of at least that size already exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() < world:
            raise RuntimeError(f"the process group has {dist.get_world_size()} ranks; the "
                               f"dry run needs {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool, save_ops: Optional[str] = None,
                mesh=None, **opts) -> dict:
    """One cell's record, with the reference's keys (``report.py`` reads
    both packages').  ``mesh`` replaces the production mesh (the fake
    world is then the caller's); ``opts`` go to ``lower_cell``."""
    from repro_torch.roofline.op_cost import analyze_log

    mesh_name = "multi" if multi_pod else "single"
    cfg = opts.get("cfg") or get_config(arch)
    shape = opts.get("shape") or SHAPES_BY_NAME[shape_name]
    ok, reason = applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "skip",
           "reason": reason}
    if not ok:
        return rec
    try:
        if mesh is None:
            fake_world()
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        n_chips = mesh.size()
        counter, meta = lower_cell(arch, shape_name, mesh, **opts)
        if save_ops:
            Path(save_ops).mkdir(parents=True, exist_ok=True)
            with gzip.open(Path(save_ops) / f"{mesh_name}__{arch}__{shape_name}.ops.jsonl.gz",
                           "wt") as f:
                for r in counter.records:
                    f.write(json.dumps(r) + "\n")
        cost = analyze_log(counter.records)
        flops, byts = float(cost.flops), float(cost.bytes)
        coll_total = float(cost.coll_bytes)
        terms = roofline_terms(flops, byts, coll_total)
        mf = model_flops_for_cell(meta["cfg"], meta["shape"], meta["shape"].kind)
        useful = mf / (flops * n_chips) if flops > 0 else 0.0
        rec.update(
            status="ok",
            reason="",
            n_chips=n_chips,
            lower_s=round(meta["build_s"], 2),
            compile_s=round(meta["count_s"], 2),
            flops_per_dev=flops,
            bytes_per_dev=byts,
            collective_bytes_per_dev=coll_total,
            collective_ops={k: dict(v) for k, v in cost.coll_ops.items()},
            model_flops_total=mf,
            useful_flops_ratio=round(useful, 4),
            memory=meta["memory"],
            **terms,
        )
        # eager PyTorch donates nothing: the peak is the arguments plus the
        # largest sum of storages the step held at once (its outputs among
        # them)
        args, temps = meta["memory"]["argument_bytes"], meta["memory"]["temp_bytes"]
        rec["hbm_per_dev_gb"] = round((args + temps) / 1e9, 3)
        rec["fits_hbm"] = rec["hbm_per_dev_gb"] <= H100.hbm_bytes / 1e9
    except Exception as e:  # noqa: BLE001 — a failing cell is a fault we record
        rec.update(status="error", reason=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def _cell_line(rec: dict) -> str:
    msg = rec.get("reason", "")
    extra = (
        f"count={rec.get('compile_s')}s flops/dev={rec.get('flops_per_dev', 0):.3g} "
        f"coll/dev={rec.get('collective_bytes_per_dev', 0):.3g}B "
        f"hbm={rec.get('hbm_per_dev_gb', 0)}GB bottleneck={rec.get('bottleneck', '')}"
        if rec["status"] == "ok"
        else msg[:160]
    )
    return f"[{rec['status']:5s}] {rec['mesh']:6s} {rec['arch']:28s} {rec['shape']:12s} {extra}"


def _in_subprocesses(jobs, timeout, cells, meshes, args, out_dir: Path, tag: str) -> list:
    """Each (cell, mesh) in a process of its own, ``jobs`` at a time: a
    cell's count is host time in one thread (DTensor's dispatch and the
    fake tensors), so cells run side by side on a host's cores.  A cell not
    counted within ``timeout`` seconds gets a ``timeout`` record: it was
    not counted, which is not a fault found in the cell."""
    import subprocess
    import sys
    from concurrent.futures import ThreadPoolExecutor

    def one(arch, shape_name, mesh):
        path = out_dir / f"{mesh}__{arch}__{shape_name}{tag}.json"
        path.unlink(missing_ok=True)  # no stale record from an earlier run
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape_name, "--mesh", mesh, "--out", str(out_dir),
               "--moe-dispatch", args.moe_dispatch, "--tag", args.tag,
               "--save-ops", args.save_ops] + (["--no-zero1"] if args.no_zero1 else [])
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh}
        try:
            subprocess.run(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                           timeout=timeout)
        except subprocess.TimeoutExpired:
            rec.update(status="timeout", reason=f"not counted within {timeout} s")
            path.write_text(json.dumps(rec))
        else:
            rec = (json.loads(path.read_text()) if path.exists() else
                   dict(rec, status="error", reason="its process wrote no record"))
        print(_cell_line(rec), flush=True)
        return rec

    todo = [(arch, shape_name, "multi" if mp else "single")
            for arch, shape_name in cells for mp in meshes]
    with ThreadPoolExecutor(jobs) as pool:
        return list(pool.map(lambda cell: one(*cell), todo))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--moe-dispatch", choices=["dense", "a2a"], default="dense")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--save-ops", default="")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run side by side, each in a process of its own")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds a cell's process may count before it is left uncounted")
    args = ap.parse_args(argv)

    cells = all_cells()
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f".{args.tag}" if args.tag else ""
    if args.jobs > 1 or args.timeout is not None:
        recs = _in_subprocesses(args.jobs, args.timeout, cells, meshes, args, out_dir, tag)
    else:
        recs = []
        try:
            for arch, shape_name in cells:
                for mp in meshes:
                    rec = dryrun_cell(
                        arch, shape_name, mp,
                        moe_dispatch=args.moe_dispatch, zero1=not args.no_zero1,
                        save_ops=args.save_ops or None,
                    )
                    name = f"{rec['mesh']}__{arch}__{shape_name}{tag}.json"
                    (out_dir / name).write_text(json.dumps(rec, indent=1, default=str))
                    recs.append(rec)
                    print(_cell_line(rec), flush=True)
        finally:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
    n_ok = sum(r["status"] == "ok" for r in recs)
    n_err = sum(r["status"] == "error" for r in recs)
    n_skip = sum(r["status"] == "skip" for r in recs)
    n_late = sum(r["status"] == "timeout" for r in recs)
    print(f"\nok={n_ok} error={n_err} skip={n_skip}" + (f" timeout={n_late}" if n_late else ""))
    raise SystemExit(1 if n_err or n_late else 0)


if __name__ == "__main__":
    main()
