"""The training driver (traffic ``kind: "train"``): one training step
object, ``make_train_step`` over the model (flash forward, per-layer
remat) and AdamW, fed a new batch each step through the program's
``Prefetcher``.

Set-up builds the step and its state, and drives it from the seed
through its first ``check_steps`` steps, the window's own call and feed:
each step's loss, the first step's gradient as AdamW took it (its first
moment after one step over 1 - b1) and, after the last, each leaf's
change from the seed's weights are kept.  The window then runs whole
steps for ``--seconds`` on the same object.  After the window the
program's state is freed and the plain reference follows the same first
steps from the same weights and batches in float32.
"""
from __future__ import annotations

import gc
import statistics
import sys
import time

import torch

from bench.harness import core, traffic, weights
from bench.harness.model import model_config
from bench.harness.profiling import Spans


def run_cell(run: core.Run) -> None:
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW

    spec, cfg = run.cell.traffic, run.cell.config["model"]
    opt_spec = spec["optimizer"]
    dev = torch.device(run.device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    model_cfg = model_config(cfg)
    layout = weights.Layout(model_cfg, build_model)
    model = build_model(model_cfg, remat=True, attn_impl="flash", device=dev)
    params = layout.program_params(run.seed, dev)
    opt = AdamW(lr=opt_spec["lr"], b1=opt_spec["b1"], b2=opt_spec["b2"], eps=opt_spec["eps"],
                weight_decay=opt_spec["weight_decay"])
    state = opt.init(params)
    step_fn = make_train_step(model, opt, clip_norm=opt_spec["clip_norm"])
    feed = Prefetcher(traffic.TrainBatches(spec, run.seed, cfg["vocab_size"]),
                      device=dev)
    try:
        losses, grad_norms = [], None
        for _ in range(spec["check_steps"]):
            _, batch = next(feed)
            params, state, metrics = step_fn(params, state, batch)
            losses.append(float(metrics["loss"]))
            if grad_norms is None:
                grad_norms = {k: float(m.norm()) / (1.0 - opt_spec["b1"])
                              for k, m in layout.views(state.m).items()}
        change = {k: float((p.float() - layout.leaf(run.seed, k[0], k[1], dev)).norm())
                  for k, p in layout.views(params).items()}
        sync()
        run.finish_setup()

        tokens_a_step = spec["batch"] * spec["seq"]
        steps, step_s = 0, []
        spans = Spans(run, sync, 0.0, 0.0, 0.0)  # the 2nd step the device's, the 3rd named
        t_open = t = time.perf_counter()
        while t - t_open < run.seconds:
            _, batch = next(feed)
            t_step = time.perf_counter()
            params, state, metrics = step_fn(params, state, batch)
            float(metrics["loss"])  # waits for the step
            step_s.append(time.perf_counter() - t_step)
            steps += 1
            spans.tick(t_open)
            t = time.perf_counter()
        spans.finish()
        if dev.type == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    finally:
        feed.stop()
    run.records.update(window_s=t - t_open, steps=steps, tokens=steps * tokens_a_step,
                       step_s=step_s, losses=losses)
    run.attempted = steps
    del params, state, metrics, batch, model, step_fn, opt, feed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(run, layout, losses, grad_norms, change)


def worst_leaf(got: dict, want: dict, skip=()):
    """The widest gap between the program's norm and the reference's over
    the leaves, each over the reference's norm of that leaf or of the
    median leaf, whichever is larger; and that leaf."""
    keys = [k for k in want if k not in skip]
    median = statistics.median(want[k] for k in keys)
    return max(((abs(got[k] - want[k]) / max(want[k], median), k) for k in keys),
               key=lambda vk: vk[0])


def compare(losses, grad_norms, change, ref: dict) -> dict:
    """The numbers compared, each with the leaf (or step) that reads it:
    the widest relative gap of a step's loss, and the worst leaf's gap of
    the first gradient's norm and of the change's norm.  Leaves whose
    first gradient in the reference is under a thousandth of the median
    leaf's (nought but for rounding: they move by round-off alone under
    AdamW) are left out of the change."""
    n = len(ref["losses"])
    out = {"loss_gap": max(((abs(a - b) / abs(b), f"step {k + 1}")
                            for k, (a, b) in enumerate(zip(losses[:n], ref["losses"]))),
                           key=lambda vk: vk[0])}
    g = ref["grad_norms"]
    median = statistics.median(g.values())
    still = {k for k, v in g.items() if v < 1e-3 * median}
    out["grad_norm_gap"] = worst_leaf(grad_norms, g)
    if n == len(losses):  # the change compares the program's state after as many steps
        out["change_norm_gap"] = worst_leaf(change, ref["change_norms"], still)
    return out


def reference_steps(run: core.Run, layout, prec=None, rows=None) -> dict:
    """The plain reference's first steps from the seed's weights on the
    run's batches (``prec``: in a lower precision; ``rows``: the first
    ``rows`` of each batch alone)."""
    spec, cfg = run.cell.traffic, run.cell.config["model"]
    dev = torch.device(run.device)
    batches = [torch.as_tensor(traffic.train_batch(spec, run.seed, s, cfg["vocab_size"])
                               ["tokens"][:rows], device=dev).long()
               for s in range(spec["check_steps"])]
    W = weights.Weights(layout, run.seed, dev)
    kw = {} if prec is None else {"prec": prec}
    return run.cell.reference().train(cfg, W, batches, spec["optimizer"], **kw)


def judge(run: core.Run, losses, grad_norms, change, ref: dict) -> dict:
    """The numbers that have a limit in the cell's limits file are
    compared; the others (and where each was read) are kept and printed."""
    readings = compare(losses, grad_norms, change, ref)
    for name, (value, where) in readings.items():
        print(f"reading {name}: {value!r} at {where}", file=sys.stderr)
        if name in run.cell.limits:
            run.check(name, value, run.cell.limits[name]["limit"])
    return readings


def check(run: core.Run, layout, losses, grad_norms, change) -> None:
    judge(run, losses, grad_norms, change, reference_steps(run, layout))
