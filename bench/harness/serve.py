"""The serving driver (traffic ``kind: "serve"``): a closed loop of
``clients`` clients, each sending its next request as soon as its last one
finishes, through ``VhostStyleServer`` on the program's engines.

Set-up draws the weights on the card, builds the server and admits every
client's first request.  The window then steps the server for
``--seconds``; after each step the harness reads, on its own clock, which
requests gained tokens.  After the window: the peak memory, the program's
state freed, and the check: a sample of the finished requests drawn from
the seed, the longest among them, each prompt with its served tokens run
through the plain reference, and the widest gap by which a served token's
logit lies below the reference's best at its position.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench.harness import core, traffic, weights
from bench.harness.model import model_config
from bench.harness.profiling import Spans


class Flight:
    """One request as the harness sees it."""

    __slots__ = ("req", "enq_t", "first_t", "steps", "seen")

    def __init__(self, req, t: float):
        self.req, self.enq_t = req, t
        self.first_t: Optional[float] = None
        self.steps: List[tuple] = []  # (end of a step that gave it tokens, how many)
        self.seen = 0


class Loop:
    """The closed loop: the clients' requests in the traffic's order, the
    requests in flight, and what each step gave."""

    def __init__(self, server, requests, clients: int):
        from repro_torch.serving.pipeline import Request

        self.server, self.requests, self.Request = server, iter(requests), Request
        self.inflight: Dict[int, Flight] = {}
        self.finished: List[Flight] = []
        for _ in range(clients):
            self.send()

    def send(self) -> None:
        i, prompt, n_out = next(self.requests)
        req = self.Request(req_id=i, prompt=prompt, max_new_tokens=n_out)
        self.inflight[i] = Flight(req, time.perf_counter())
        self.server.enqueue(req)

    def step(self) -> int:
        """One server step; returns the tokens it gave."""
        self.server.step()
        t = time.perf_counter()
        gained = 0
        for i, f in list(self.inflight.items()):
            n = len(f.req.output)
            if n > f.seen:
                gained += n - f.seen
                f.steps.append((t, n - f.seen))
                f.seen = n
                if f.first_t is None:
                    f.first_t = t
            if f.req.done_at is not None:
                del self.inflight[i]
                self.finished.append(f)
                self.send()
        return gained


def run_cell(run: core.Run) -> None:
    from repro_torch.core import make_device
    from repro_torch.models.api import build_model
    from repro_torch.serving.pipeline import SERVING_WQ_CONFIGS, VhostStyleServer

    spec, cfg = run.cell.traffic, run.cell.config["model"]
    dev = torch.device(run.device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    model_cfg = model_config(cfg)
    layout = weights.Layout(model_cfg, build_model)
    model = build_model(model_cfg, remat=False, attn_impl="flash", device=dev)
    params = layout.program_params(run.seed, dev)
    engines = make_device(wq_configs=SERVING_WQ_CONFIGS, device=dev)
    gauges = core.Gauges()
    server = VhostStyleServer(model, params, slots=spec["slots"],
                              max_cache_len=spec["max_cache_len"], device=engines,
                              observer=gauges)
    loop = Loop(server, traffic.ServeTraffic(spec, run.seed, cfg["vocab_size"]),
                spec["clients"])
    # set-up ends when every client's request is admitted and decoding
    while any(f.first_t is None for f in loop.inflight.values()):
        loop.step()
    sync()
    run.finish_setup()

    gauges.values.clear()
    n_done0 = len(loop.finished)
    tokens, steps = 0, 0
    spans = Spans(run, sync, spec["profile_after_s"], spec["profile_s"], spec["profile_host_s"])
    t_open = t = time.perf_counter()
    while t - t_open < run.seconds:
        tokens += loop.step()
        steps += 1
        spans.tick(t_open)
        t = time.perf_counter()
    t_close = t
    spans.finish()
    sync()
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)

    finished = loop.finished[n_done0:]
    window = [f for f in loop.finished + list(loop.inflight.values())]
    run.gauges = gauges.values
    run.records.update(
        window_s=t_close - t_open, tokens=tokens, steps=steps,
        ttft_s=[f.first_t - f.enq_t for f in window
                if f.first_t is not None and t_open <= f.first_t <= t_close],
        itl_s=[b - a for f in window for (a, _), (b, _) in zip(f.steps, f.steps[1:])
               if t_open <= b <= t_close],
        processed=_processed(window, t_open, t_close),
        profiled=None if spans.device_span is None else {
            "prefills": [len(f.req.prompt) for f in window if f.first_t is not None
                         and spans.device_span[0] <= f.first_t <= spans.device_span[1]]})
    run.attempted = len(finished) + len(loop.inflight)
    run.failed = sum(len(f.req.output) != f.req.max_new_tokens for f in finished)
    sample = _sample(finished, run.seed, spec["check"])
    del loop, server, params, model, engines
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(run, layout, sample)


def _processed(flights, t_open: float, t_close: float) -> dict:
    """The prompts prefilled and the tokens decoded in the window, with
    the position each decoded token was fed at: what the model's FLOPs
    count.  Output token 0 comes from the prefill; token j >= 1 from the
    decode step that fed token j - 1 at position P + j - 1."""
    prefills, decode_positions = [], []
    for f in flights:
        P, j = len(f.req.prompt), 0
        for t, n in f.steps:
            for _ in range(n):
                if t_open <= t <= t_close:
                    if j == 0:
                        prefills.append(P)
                    else:
                        decode_positions.append(P + j - 1)
                j += 1
    return {"prefills": prefills, "decode_positions": decode_positions}


def _sample(finished: List[Flight], seed: int, spec: dict) -> List[dict]:
    """Requests to check, drawn from the seed: the one with the most
    served tokens first, then others until ``served_tokens`` tokens or
    ``requests`` requests."""
    if not finished:
        return []
    order = sorted(range(len(finished)), key=lambda i: -len(finished[i].req.output))
    first, rest = order[0], order[1:]
    picks = [first] + list(traffic.rng(seed, 4).permutation(rest)) if rest else [first]
    out, total = [], 0
    for i in picks:
        r = finished[int(i)].req
        out.append({"prompt": np.asarray(r.prompt, np.int64), "output": list(r.output)})
        total += len(r.output)
        if total >= spec["served_tokens"] or len(out) >= spec["requests"]:
            break
    return out


def gap_stats(gaps: torch.Tensor) -> dict:
    """Numbers a check can compare, from the gaps of every checked token:
    the widest, the mean, and the share of tokens that are not the
    reference's first choice."""
    return {"max_logit_gap": float(gaps.max()), "mean_logit_gap": float(gaps.mean()),
            "off_top_share": float((gaps > 0).float().mean())}


def logit_gap(ref, cfg: dict, W, sample: List[dict], prec=None) -> dict:
    """The reference's logits at each served token's position, and the gap
    by which each served token's logit lies below the reference's best
    ("served"); with ``prec``, the gap of the token that ``prec``'s
    reference puts first at the same positions ("control")."""
    dev = W.device
    seqs = [torch.as_tensor(np.concatenate([s["prompt"], s["output"][:-1]]), device=dev)
            for s in sample]
    starts = [len(s["prompt"]) - 1 for s in sample]
    served = torch.cat([torch.as_tensor(s["output"], device=dev) for s in sample])
    exact = torch.cat(ref.logits(cfg, W, seqs, starts))
    best = exact.amax(-1)
    out = {"served": gap_stats(best - exact.gather(1, served.long()[:, None])[:, 0]),
           "tokens": int(served.numel())}
    if prec is not None:
        first = torch.cat(ref.logits(cfg, W, seqs, starts, prec)).argmax(-1)
        out["control"] = gap_stats(best - exact.gather(1, first[:, None])[:, 0])
    return out


def check(run: core.Run, layout, sample: List[dict], prec=None) -> dict:
    """Judge the served tokens of ``sample`` by the cell's limits.  With
    ``prec`` (the control), the tokens judged are those that ``prec``'s
    reference puts first at each served position, in the served tokens'
    place: the same comparison, the same limits."""
    cfg = run.cell.config["model"]
    vocab = cfg["vocab_size"]
    outside = sum(not (0 <= t < vocab) for s in sample for t in s["output"])
    run.check("served_outside_vocab", outside, 0)
    if not sample:
        run.check("requests_checked", 0, -1)
        return {}
    W = weights.Weights(layout, run.seed, torch.device(run.device))
    gap = logit_gap(run.cell.reference(), cfg, W, sample, prec)
    judged = gap["served"] if prec is None else gap["control"]
    run.records["checked_tokens"] = gap["tokens"]
    run.records["gaps"] = judged
    for name, value in judged.items():
        if name in run.cell.limits:
            run.check(name, value, run.cell.limits[name]["limit"])
    return gap
