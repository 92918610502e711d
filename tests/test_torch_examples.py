"""The port's examples and its serve CLI, run on the CPU the way a user runs
them (``main([... "--device", "cpu"])``), held against the JAX package.

- the quickstart against the same flow on ``repro.core`` from the same
  numpy inputs (``delta_apply`` on its ``use_kernel=False`` path: the
  reference's Pallas kernel cannot run on the installed jax, and the
  record leaves word 0 alone, where that path is exact);
- the incremental-checkpointing example against the reference script's own
  run, stat for stat;
- the serving example against the reference example's values with the
  prompt copies' admission pinned (see ``SERVE_PINNED``);
- train_e2e cut to 4 steps: both checkpoint directories restore step 4, with
  the reference script's checkpoint stats;
- ``python -m repro_torch.launch.serve``: every request completes.
"""
from __future__ import annotations

import functools
import importlib.util
import runpy
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import pin_admission

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"


def load(path: Path):
    """Import a script of the repo by its path (examples/ and tools/ are not
    packages)."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------------- quickstart
def reference_quickstart() -> dict:
    """examples/quickstart.py's flow on repro.core, returning what the port's
    ``main`` returns."""
    import repro.core as J
    import repro.kernels.ops as jops

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "delta_apply", functools.partial(jops.delta_apply, use_kernel=False))
        device = J.make_device(n_instances=2, policy="least_loaded")
        x = jnp.asarray(np.random.default_rng(0).normal(size=(1024, 128)), jnp.float32)
        fut = device.memcpy_async(x)
        fut.result()
        crc_hex = device.crc32_async(x).then(lambda c: f"0x{int(c):08x}")
        gate = device.promise()
        fenced = device.memcpy_async(x, after=[gate])
        device.kick()
        held = not fenced.done()
        gate.set_result(None)
        fenced.result()
        base = jnp.asarray(np.random.default_rng(1).integers(0, 2**31, 4096), jnp.uint32)
        changed = base.at[jnp.asarray([7, 99, 2048])].add(1)
        offsets, data, count, overflow = device.delta_create_async(changed, base,
                                                                   cap=64).result()
        restored = device.delta_apply(base, offsets, data)
        assert (np.asarray(restored) == np.asarray(changed)).all()
        descs = [J.WorkDescriptor(op=J.OpType.MEMCPY, src=jnp.full((8, 128), i, jnp.float32))
                 for i in range(8)]
        outs = device.batch_async(descs).result()
        device.drain()
        return {"memcpy_bytes": fut.record.bytes_processed, "crc32": crc_hex.result(),
                "fence_held": held, "delta_count": int(count),
                "delta_overflow": bool(overflow), "batch": [np.asarray(o) for o in outs],
                "placements": dict(device.policy_stats["decisions"])}


@pytest.fixture(scope="module")
def quickstart():
    port = load(EXAMPLES / "quickstart_torch.py").main(["--device", "cpu"])
    return port, reference_quickstart(), reference_quickstart()


@pytest.mark.parametrize("key", ["memcpy_bytes", "crc32", "fence_held", "delta_count",
                                 "delta_overflow"])
def test_quickstart_prints_the_references_values(quickstart, key):
    port, ref, _ = quickstart
    assert port[key] == ref[key]


def test_quickstart_values_are_right(quickstart):
    port, _, _ = quickstart
    assert port["memcpy_bytes"] == 1024 * 128 * 4
    assert port["crc32"] == "0xce5197c7"
    assert port["fence_held"] is True
    assert (port["delta_count"], port["delta_overflow"]) == (3, False)


def test_quickstart_batch_outputs_are_the_references(quickstart):
    port, ref, _ = quickstart
    assert len(port["batch"]) == len(ref["batch"]) == 8
    for got, want in zip(port["batch"], ref["batch"]):
        assert got.dtype == torch.float32 and got.numpy().tobytes() == want.tobytes()


def test_quickstart_placements(quickstart):
    """The total always; the per-engine split where the reference's is the
    same in two runs of its flow."""
    port, ref, ref_again = quickstart
    assert sum(port["placements"].values()) == sum(ref["placements"].values()) == 6
    if ref["placements"] == ref_again["placements"]:
        assert port["placements"] == ref["placements"]


# --------------------------------------------------------------------------- checkpointing
def test_incremental_checkpointing_matches_the_reference_script(capsys):
    got = load(EXAMPLES / "incremental_checkpointing_torch.py").main(["--device", "cpu"])
    ref = runpy.run_path(str(EXAMPLES / "incremental_checkpointing.py"))
    capsys.readouterr()
    assert got["stats"] == ref["mgr"].stats == {
        "full_leaves": 2, "delta_leaves": 2, "delta_overflows": 0,
        "bytes_written": 2128536, "bytes_saved_by_delta": 4162920}
    assert got["step"] == ref["step"] == 3
    assert got["exact"] is True and bool(ref["ok"]) is True


# --------------------------------------------------------------------------- serving
#: examples/serve_continuous_batching.py's values.  Its pipeline step count
#: depends on when the engines finish the prompt copies: 18 or 19 from run
#: to run of the reference here (19 when measured for the issue, 18 and 19
#: in later runs), and 18 in every run with each copy burst waited for at
#: its submit (``pin_admission``).  The reference takes 10-17 s here, so
#: its values are pinned rather than taken in the test.
SERVE_PINNED = {"completed": 10, "steps": 18, "decoded_tokens": 50, "copy_bursts": 10,
                "pages_moved": 8, "batch_copies": 2, "round_trip": True}
SERVE_STEPS_UNPINNED = (18, 19)


@pytest.mark.parametrize("pinned", [True, False], ids=["admission_pinned", "free"])
def test_serving_example_matches_the_reference(monkeypatch, pinned):
    mod = load(EXAMPLES / "serve_continuous_batching_torch.py")
    if pinned:
        make = mod.make_device
        monkeypatch.setattr(mod, "make_device", lambda *a, **kw: pin_admission(make(*a, **kw)))
    got = mod.main(["--device", "cpu"])
    if pinned:
        assert got == SERVE_PINNED
    else:
        assert got["steps"] in SERVE_STEPS_UNPINNED
        assert {k: v for k, v in got.items() if k != "steps"} == {
            k: v for k, v in SERVE_PINNED.items() if k != "steps"}


# --------------------------------------------------------------------------- training
def test_train_e2e_reaches_its_steps_and_both_directories_restore(tmp_path, capsys):
    """examples/train_e2e.py --steps 4 (the reference) reaches step 4 and
    saves 37 full leaves, 7220484 bytes, in one full snapshot."""
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager

    final = load(EXAMPLES / "train_e2e_torch.py").main(
        ["--steps", "4", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert final == 4 and "reached step 4" in out
    assert ("ckpt stats {'full_leaves': 37, 'delta_leaves': 0, 'delta_overflows': 0, "
            "'bytes_written': 7220484, 'bytes_saved_by_delta': 0}") in out
    for d in ("ckpt", "ckpt-replica"):
        step, tree = CheckpointManager(CheckpointConfig(directory=str(tmp_path / d))).restore()
        assert step == 4 and len(tree) == 37


# --------------------------------------------------------------------------- serve CLI
def test_the_serve_cli_completes_every_request(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--requests", "6", "--slots", "3", "--max-new", "4", "--prompt-len",
                       "16", "--max-cache", "64", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("served 6/6 requests") and out.rstrip().endswith("on the CPU")


def test_entry_points_mean_the_card_unless_asked_for_the_cpu():
    """With no --device the examples and the serve CLI run on CUDA, and
    raise where no card is present."""
    from repro_torch.launch import serve

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    for run in (load(EXAMPLES / "quickstart_torch.py").main,
                load(EXAMPLES / "incremental_checkpointing_torch.py").main,
                load(EXAMPLES / "serve_continuous_batching_torch.py").main, serve.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            run([])
