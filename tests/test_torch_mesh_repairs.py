"""The port's mesh path where the dry run found it failing or doing more
work per rank than the JAX package, held against its unsharded run, the
reference, and the reference's own counts:

* on a (2, 2) gloo mesh (4 ranks of ``_torch_dist_worker.py``, at the same
  time as one JAX subprocess on 8 virtual CPU devices), in f32 to 1e-4
  relative to the largest magnitude (``test_torch_distributed.py``'s
  ``MODEL_RTOL``):
  - (a) a reduced hymba whose 3 SSD heads divide no model axis of 2:
    prefill, 3 decode steps and one ZeRO-1 train step equal its unsharded
    run (on the parent the head split raised);
  - (b) reduced qwen2-vl's ZeRO-1 train step with patch embeddings, its
    batch laid out by the rules: loss and grad norm equal the reference's
    (on the parent its backward met a DTensor where it took a tensor);
  - (c) reduced mamba2's train step with the SSD scan per rank (heads over
    "model") equals its unsharded run;
  - (d) 1- and 2-token prompts to reduced mamba2 and hymba equal their
    unsharded runs;
  - the dense MoE dispatch per rank (reduced deepseek-moe, 4 experts over
    "model"): prefill, decode and a train step equal the unsharded run;
* (e) FLOPs per rank of reduced tinyllama, mamba2 and deepseek-moe train
  steps and mamba2's prefill on the 16x16 fake mesh (a subprocess: the
  fake world is a process's default group) against the reference's
  ``lower_cell`` of the same reduced cell on its 16x16 mesh (a subprocess:
  importing its dry run sets ``XLA_FLAGS`` to 512 devices): the port's
  count over the reference's, divided by the arch's one-rank ratio r1, is
  at most 1.25 (on the parent: 1.89, 55.8, 1.45 and 55.7);
* (f) the one-rank FLOPs of reduced mamba2, hymba and qwen2-vl train and
  prefill steps against the reference's ``analyze_hlo`` (the comparison
  ``test_torch_roofline.py`` makes for tinyllama and deepseek-moe): the
  ratio r1 that (e) divides by, pinned to 1e-6.
"""
import dataclasses
import json
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch.multiprocessing as tmp

import _torch_dist_worker as W
from repro.checkpoint.manager import _tree_flatten_with_names as j_names
from repro.configs import get_config as j_get_config
from repro.models.api import build_model as j_build
from _torch_ref import moved_norms

SRC = str(Path(__file__).resolve().parent.parent / "src")
MODEL_RTOL = 1e-4
#: the bound on (port FLOPs / reference FLOPs) / r1 on the 16x16 mesh
FLOPS_RATIO_BOUND = 1.25
VLM = "qwen2-vl-2b"


def close(got, want, rtol, err_msg=""):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * scale, err_msg=err_msg)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# --------------------------------------------------------------------------- (2, 2) gloo runs
def _inputs(workdir: Path) -> dict:
    rng = np.random.default_rng(26)
    f32 = np.float32
    inp = {
        "rep_tokens": rng.integers(0, 1 << 30, (2, 12)).astype(np.int32),
        "rep_steps": rng.integers(0, 1 << 30, (W.REPAIR_DECODE, 2, 1)).astype(np.int32),
        "rep_train4": rng.integers(0, 1 << 30, (4, 64)).astype(np.int32),
    }
    cfg = dataclasses.replace(j_get_config(VLM).reduced(), dtype="float32")
    params = moved_norms(j_build(cfg).init(jax.random.key(26)), seed=26)
    for name, leaf in j_names(params):
        inp["vlm_p/" + name] = np.asarray(leaf)
        inp["vlm_o/m/" + name] = (rng.normal(size=leaf.shape) * 1e-3).astype(f32)
        inp["vlm_o/v/" + name] = rng.uniform(1e-6, 1e-5, size=leaf.shape).astype(f32)
    inp["vlm_o/step"] = np.array(10, np.int32)
    S = 16
    inp["vlm_tokens"] = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    inp["vlm_patch_embeds"] = rng.normal(size=(2, cfg.vlm.num_patches, cfg.d_model)).astype(f32)
    inp["vlm_positions_thw"] = rng.integers(0, S, (3, 2, S)).astype(np.int32)
    np.savez(workdir / "inputs.npz", **inp)
    return inp


#: the reference's side of (b): its ZeRO-1 train step on the (2, 2) mesh of
#: the first 4 of 8 virtual devices, as ``test_torch_distributed``'s
#: reference script takes it, with the VLM batch laid out by its rules
_REF_VLM = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from repro.checkpoint.manager import _tree_flatten_with_names as names_of
from repro.configs import get_config
from repro.distributed.annotate import use_rules
from repro.distributed.params import opt_state_shardings, tree_shardings
from repro.distributed.sharding import rules_for_mesh
from repro.launch.mesh import axis_types_kw
from repro.launch.steps import make_train_step
from repro.models.api import build_model
from repro.optim.adamw import AdamW, AdamWState

workdir, arch = sys.argv[1], sys.argv[2]
inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4], **axis_types_kw(2))
rules = rules_for_mesh(mesh)
cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
model = build_model(cfg, mesh=mesh)
p_abs = jax.eval_shape(model.init, jax.random.key(0))
tree = lambda pre: jax.tree.unflatten(jax.tree.structure(p_abs), [  # noqa: E731
    jnp.asarray(inp[pre + n]) for n, _ in names_of(p_abs)])
batch = {k: jnp.asarray(inp["vlm_" + k]) for k in ("tokens", "patch_embeds", "positions_thw")}
with mesh, use_rules(mesh, rules):
    params = jax.device_put(tree("vlm_p/"), tree_shardings(p_abs, mesh, rules))
    state = AdamWState(step=jnp.asarray(inp["vlm_o/step"]), m=tree("vlm_o/m/"), v=tree("vlm_o/v/"))
    state = jax.device_put(state, opt_state_shardings(state, params, mesh, rules))
    batch = jax.device_put(batch, tree_shardings(batch, mesh, rules))
    _, _, met = jax.jit(make_train_step(model, AdamW(lr=1e-3)))(params, state, batch)
np.savez(os.path.join(workdir, "ref_vlm.npz"), loss=np.asarray(met["loss"]),
         gnorm=np.asarray(met["grad_norm"]))
print("REF OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and two groups of 4 port ranks, at once.
    Returns (reference outputs, {check: port outputs})."""
    workdir = tmp_path_factory.mktemp("repairs")
    _inputs(workdir)
    ref = subprocess.Popen([sys.executable, "-c", _REF_VLM, str(workdir), VLM],
                           env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin",
                                "JAX_PLATFORMS": "cpu"},
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    halves = (["odd_heads", "short_prompts", "vlm_train"], ["ssm_scan", "moe_dense"])
    try:
        groups = [tmp.start_processes(W.run, args=(4, _free_port(), str(workdir), checks),
                                      nprocs=4, join=False, start_method="spawn")
                  for checks in halves]
        for g in groups:
            while not g.join():
                pass
    except Exception:
        errors = sorted(workdir.glob("error_*.txt"))
        raise AssertionError(errors[0].read_text() if errors else "a rank failed")
    finally:
        out, err = ref.communicate(timeout=900)
    assert ref.returncode == 0 and "REF OK" in out, err[-3000:]
    port = {n: dict(np.load(workdir / f"port_{n}.npz")) for h in halves for n in h}
    return dict(np.load(workdir / "ref_vlm.npz")), port


def _mesh_equals_plain(got: dict, prefix: str = ""):
    keys = [k[len(prefix) + len("plain_"):] for k in got
            if k.startswith(prefix + "plain_")]
    assert keys
    for k in keys:
        close(got[f"{prefix}mesh_{k}"], got[f"{prefix}plain_{k}"], MODEL_RTOL, prefix + k)


def test_hymba_with_ssd_heads_the_model_axis_does_not_divide(runs):
    """(a): prefill and decode logits, loss, grad norm and new parameters."""
    got = runs[1]["odd_heads"]
    assert {"mesh_prompt0", "mesh_loss", "mesh_gnorm"} <= set(got)
    _mesh_equals_plain(got)


def test_qwen2_vl_train_step_with_patch_embeds_matches_the_reference(runs):
    """(b)"""
    ref, port = runs
    close(port["vlm_train"]["loss"], ref["loss"], MODEL_RTOL, "loss")
    close(port["vlm_train"]["gnorm"], ref["gnorm"], MODEL_RTOL, "grad norm")


def test_mamba2_train_step_with_the_scan_per_rank(runs):
    """(c): loss, grad norm and every new parameter, and a prefill."""
    _mesh_equals_plain(runs[1]["ssm_scan"])


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_one_and_two_token_prompts_on_the_mesh(runs, arch):
    """(d): prefill and 3 decode steps after prompts of 1 and 2 tokens."""
    got = runs[1]["short_prompts"]
    assert {f"{arch}/mesh_prompt0", f"{arch}/mesh_prompt1"} <= set(got)
    _mesh_equals_plain(got, arch + "/")


def test_dense_moe_dispatch_per_rank(runs):
    _mesh_equals_plain(runs[1]["moe_dense"])


# --------------------------------------------------------------------------- (e) FLOPs on 16x16
#: (arch, kind) of the reduced cells counted on the 16x16 meshes
CELLS = [("tinyllama-1.1b", "train"), ("mamba2-370m", "train"), ("deepseek-moe-16b", "train"),
         ("mamba2-370m", "prefill")]
SEQ, BATCH = 64, 32

_PORT_COUNTS = r"""
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline.op_cost import analyze_log

cells, seq, batch = json.loads(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
dryrun.fake_world()
mesh = make_production_mesh(device_type="cpu")
out = {}
for arch, kind in cells:
    counter, _ = dryrun.lower_cell(arch, "reduced", mesh, cfg=get_config(arch).reduced(),
                                   shape=ShapeConfig("reduced", seq, batch, kind))
    out[f"{arch}/{kind}"] = analyze_log(counter.records).flops
print(json.dumps(out))
"""

#: the reference's ``lower_cell``, its config and shape lookups pointed at
#: the reduced cell
_REF_COUNTS = r"""
import json, sys
import repro.launch.dryrun as D
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_production_mesh
from repro.roofline.hlo_cost import analyze_hlo

cells, seq, batch = json.loads(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
mesh = make_production_mesh()
out = {}
for arch, kind in cells:
    D.get_config = lambda a: get_config(a).reduced()
    D.SHAPES_BY_NAME = {"reduced": ShapeConfig("reduced", seq, batch, kind)}
    lowered, _ = D.lower_cell(arch, "reduced", mesh)
    out[f"{arch}/{kind}"] = analyze_hlo(lowered.compile().as_text()).flops
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def counts_16x16():
    """{"port" | "reference": {"arch/kind": FLOPs per rank}}, the port's
    cells counted in two processes beside the reference's."""
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}

    def start(script, cells):
        return subprocess.Popen([sys.executable, "-c", script, json.dumps(cells), str(SEQ),
                                 str(BATCH)], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    procs = {"reference": [start(_REF_COUNTS, CELLS)],
             "port": [start(_PORT_COUNTS, CELLS[:2]), start(_PORT_COUNTS, CELLS[2:])]}
    got = {}
    for side, ps in procs.items():
        got[side] = {}
        for p in ps:
            out, err = p.communicate(timeout=900)
            assert p.returncode == 0, err[-3000:]
            got[side].update(json.loads(out.strip().splitlines()[-1]))
    return got


#: r1 of tinyllama-1.1b and deepseek-moe-16b (``test_torch_roofline.py``)
R1_HELD_ELSEWHERE = {("tinyllama-1.1b", "train"): 1.0, ("deepseek-moe-16b", "train"): 1.0}


@pytest.mark.parametrize("arch,kind", CELLS)
def test_flops_per_rank_on_16x16_against_the_reference(arch, kind, counts_16x16):
    """(e)"""
    r1 = R1_HELD_ELSEWHERE.get((arch, kind)) or R1[(arch, kind)]
    got, want = counts_16x16["port"][f"{arch}/{kind}"], counts_16x16["reference"][f"{arch}/{kind}"]
    assert got / want / r1 <= FLOPS_RATIO_BOUND, (got, want, got / want)


# --------------------------------------------------------------------------- (f) one rank
#: the port's one-rank FLOPs over ``analyze_hlo``'s (B 4, S 64), as
#: measured: the train steps differ by the SSD's few one-row products
R1 = {("mamba2-370m", "train"): 1090519040 / 1091567616, ("mamba2-370m", "prefill"): 1.0,
      ("hymba-1.5b", "train"): 2404646912 / 2405482496, ("hymba-1.5b", "prefill"): 1.0,
      ("qwen2-vl-2b", "train"): 1.0, ("qwen2-vl-2b", "prefill"): 1.0}


@pytest.fixture(scope="module")
def host_mesh():
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(device="cpu")


@pytest.mark.parametrize("arch,kind", list(R1))
def test_one_rank_flops_against_the_reference_hlo_walk(arch, kind, host_mesh):
    """(f)"""
    from test_torch_roofline import B, S, _reference_flops

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.roofline.op_cost import analyze_log

    counter, _ = lower_cell(arch, "parity", host_mesh, cfg=get_config(arch).reduced(),
                            shape=ShapeConfig("parity", S, B, kind))
    got, want = analyze_log(counter.records).flops, _reference_flops(arch, kind)
    assert got / want == pytest.approx(R1[(arch, kind)], rel=1e-6), (got, want)
