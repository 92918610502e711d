"""A run with the timed path broken underneath must come out not correct:
each cell's faults planted in the program at the small size, the rest of
the run (drivers, check, limits) as it is.  And the control, the
reference in float8 products in the program's place, must read well
above the program."""
import statistics

import torch

from bench.harness import serve, small, train


def _serve_with(monkeypatch, wrap):
    import repro_torch.launch.steps as steps

    make = steps.make_decode_step
    monkeypatch.setattr(steps, "make_decode_step", lambda model, **kw: wrap(model, make(model)))


def test_serve_token_altered(monkeypatch):
    """Each decoded token replaced by the least likely one where the
    decode step produces it."""
    def wrap(model, decode):
        def step(params, cache, tokens):
            logits, cache = model.decode_step(params, cache, tokens)
            return torch.argmin(logits, dim=-1).to(torch.int32)[:, None], cache
        return step

    _serve_with(monkeypatch, wrap)
    run = small.small_run(small.small_cell("dsmoe16b.chat"), seed=31, seconds=1.5)
    assert run.records["checked_tokens"] > 0 and not run.correct


def test_serve_unchanged_state(monkeypatch):
    """A decode step that hands back the token it was fed."""
    _serve_with(monkeypatch, lambda model, decode: (
        lambda params, cache, tokens: (tokens.clone(), decode(params, cache, tokens)[1])))
    run = small.small_run(small.small_cell("dsmoe16b.rag"), seed=32, seconds=1.5)
    assert not run.correct


def _train_with(monkeypatch, wrap):
    import repro_torch.launch.steps as steps

    make = steps.make_train_step
    monkeypatch.setattr(steps, "make_train_step",
                        lambda model, opt, **kw: wrap(model, make(model, opt, **kw)))


def test_train_state_unchanged(monkeypatch):
    def wrap(model, step):
        def same(params, state, batch):
            _, _, metrics = step(params, state, batch)
            return params, state, metrics
        return same

    _train_with(monkeypatch, wrap)
    run = small.small_run(small.small_cell("hymba1.5b.train"), seed=33, seconds=0.1)
    assert run.checks["change_norm_gap"]["value"] == 1.0
    assert not run.correct


def test_train_half_batch(monkeypatch):
    def wrap(model, step):
        loss = model.loss
        model.loss = lambda params, batch: loss(
            params, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
        return step

    _train_with(monkeypatch, wrap)
    run = small.small_run(small.small_cell("hymba1.5b.train"), seed=34, seconds=0.1)
    assert not run.correct


def test_serve_control_through_the_cells_check(monkeypatch):
    """The control's first choices judged in the served tokens' place by
    the cell's own check and limits (``bench/calibrate.py`` does the same
    on the card at the cell's size, where the control has to fail): its
    compared number reads above the program's on every seed, and by 3x
    at the median."""
    import bench.calibrate as calibrate

    got = {}

    def readings(run, layout, sample):
        calibrate.serve_readings(run, layout, sample)
        got[run.seed] = run.records["readings"]

    monkeypatch.setattr(serve, "check", readings)
    for seed in (41, 42, 43, 44):
        # a window long enough that requests finish on a loaded test host
        small.small_run(small.small_cell("dsmoe16b.rag"), seed=seed, seconds=3.0)
    assert sorted(got) == [41, 42, 43, 44]
    assert all("mean_logit_gap" in r["program"]["checks"] for r in got.values())
    gap = {who: [r[who]["checks"]["mean_logit_gap"]["value"] for r in got.values()]
           for who in ("program", "control")}
    assert all(r["program"]["correct"] for r in got.values())
    assert all(c > p for c, p in zip(gap["control"], gap["program"]))
    assert statistics.median(gap["control"]) > 3 * statistics.median(gap["program"])


def test_train_control_and_fault_through_the_cells_check(monkeypatch):
    import bench.calibrate as calibrate

    got = {}

    def readings(run, layout, losses, grad_norms, change):
        calibrate.train_readings(run, layout, losses, grad_norms, change)
        got[run.seed] = run.records["readings"]

    monkeypatch.setattr(train, "check", readings)
    for seed in (44, 45, 46):
        small.small_run(small.small_cell("hymba1.5b.train"), seed=seed, seconds=0.1)
    assert all(r["program"]["correct"] and not r["half_batch"]["correct"]
               for r in got.values())
    for name in ("loss_gap", "grad_norm_gap"):
        program = max(r["program"]["readings"][name]["value"] for r in got.values())
        assert min(r["control"]["readings"][name]["value"] for r in got.values()) > 3 * program
