"""The port's mesh paths on several ranks against the JAX package's on
several devices: collectives at 4 ranks, the MoE all-to-all dispatch on a
(4, 2) mesh, the manual-bf16 tensor-parallel MLP and attention output at
tp 2, the sharded flash attention (KV heads sharded, and KV heads
replicated under sharded query heads), reduced tinyllama-1.1b and
deepseek-moe-16b on a (2, 2) mesh (prefill, 4 decode steps, one ZeRO-1
train step; tinyllama's decode also with the KV cache's sequence dim
sharded), gemma3, hymba and mamba2 reduced on that mesh against their
unsharded run, and ``restore(shardings=)`` / ``Prefetcher(shardings=)``.

The reference runs in one subprocess on 8 virtual CPU devices
(``--xla_force_host_platform_device_count=8``), its meshes built with Auto
axes as ``repro.launch.mesh`` builds them (JAX's default Explicit axes
fail in ``moe_block``'s reshape).  The port runs in gloo ranks started by
``torch.multiprocessing`` (``_torch_dist_worker.py``): 8 for the (4, 2)
MoE mesh and 4 for the rest, at the same time as the reference.  Both
read the same inputs, made here from numpy seeds and the reference's
``init``.

Tolerances: f32 1e-5 relative to the largest magnitude for blocks (the
same arithmetic; the all-reduces sum partial products in another order),
1e-4 for model logits, loss, gradient norm and the train step's new
parameters and moments; collectives exact (integer sums, and f32 sums of
4 values in the ring's order); specs and placements exact.

Where the KV heads are replicated and the query heads sharded the
reference's sharded flash is wrong (its kernel recomputes the group size
from the local head count, so local query head j reads KV head j //
(H_local / KV)); the port gives each rank the KV heads its global query
heads read and equals the unsharded result.  The test pins both.
"""
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as tmp

import _torch_dist_worker as W
from repro.checkpoint.manager import _tree_flatten_with_names as j_names
from repro.configs import get_config as j_get_config
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as JM
from repro.models.api import build_model as j_build
from _torch_ref import moved_norms

SRC = str(Path(__file__).resolve().parent.parent / "src")
BLOCK_RTOL = 1e-5
MODEL_RTOL = 1e-4
N_DECODE = 4


def close(got, want, rtol, err_msg=""):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * scale, err_msg=err_msg)


# --------------------------------------------------------------------------- inputs
def _inputs(workdir: Path) -> dict:
    rng = np.random.default_rng(24)
    f32 = np.float32
    inp = {
        "coll_x": rng.normal(size=(4, 5, 7)).astype(f32),
        "coll_g": rng.normal(size=(4, 64, 48)).astype(f32),
        "coll_e": (rng.normal(size=(4, 64, 48)) * 1e-3).astype(f32),
        "moe_x": rng.normal(size=(2, 16, 16)).astype(f32),
        "tp_x": rng.normal(size=(4, 8, 16)).astype(f32),
        "tp_w1": (rng.normal(size=(16, 32)) * 0.25).astype(f32),
        "tp_w3": (rng.normal(size=(16, 32)) * 0.25).astype(f32),
        "tp_w2": (rng.normal(size=(32, 16)) * 0.18).astype(f32),
        "tp_ct": rng.normal(size=(4, 8, 16)).astype(f32),
        "tp_o": rng.normal(size=(4, 8, 64)).astype(f32),
        "tp_wo": (rng.normal(size=(64, 16)) * 0.125).astype(f32),
        # KV heads sharded with the query heads on a (2, 2) mesh: 8 over 4
        "fl_q": rng.normal(size=(2, 128, 8, 64)).astype(f32),
        "fl_k": rng.normal(size=(2, 128, 4, 64)).astype(f32),
        "fl_v": rng.normal(size=(2, 128, 4, 64)).astype(f32),
        # KV heads replicated on a (1, 4) mesh: 8 query heads over 2 KV heads
        "fr_q": rng.normal(size=(1, 128, 8, 64)).astype(f32),
        "fr_k": rng.normal(size=(1, 128, 2, 64)).astype(f32),
        "fr_v": rng.normal(size=(1, 128, 2, 64)).astype(f32),
        "fr_ct": rng.normal(size=(1, 128, 8, 64)).astype(f32),
        "fam_tokens": rng.integers(0, 1 << 30, (2, 12)).astype(np.int32),
        "fam_steps": rng.integers(0, 1 << 30, (W.FAMILY_DECODE, 2, 1)).astype(np.int32),
        "ck_w": rng.normal(size=(8, 6)).astype(f32),
        "ck_wq": rng.normal(size=(8, 12)).astype(f32),
    }
    cfg = JMoEConfig(num_experts=8, top_k=2, d_ff_expert=32, num_shared_experts=1,
                     capacity_factor=8.0)
    for k, v in JM.init_moe_params(jax.random.key(0), cfg, 16, jnp.float32).items():
        inp["moe_p_" + k] = np.asarray(v)
    for i, (arch, _) in enumerate(W.MODELS):
        cfg = _model_cfg(arch)
        pre = f"m_{arch}_"
        params = moved_norms(j_build(cfg).init(jax.random.key(i)), seed=i)
        for name, leaf in j_names(params):
            inp[pre + "p/" + name] = np.asarray(leaf)
        for name, leaf in j_names(params):
            inp[pre + "o/m/" + name] = (rng.normal(size=leaf.shape) * 1e-3).astype(f32)
            inp[pre + "o/v/" + name] = rng.uniform(1e-6, 1e-5, size=leaf.shape).astype(f32)
        inp[pre + "o/step"] = np.array(10, np.int32)
        inp[pre + "tokens"] = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        inp[pre + "decode_tokens"] = rng.integers(0, cfg.vocab_size,
                                                  (N_DECODE, 2, 1)).astype(np.int32)
        inp[pre + "train_tokens"] = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    np.savez(workdir / "inputs.npz", **inp)
    return inp


def _model_cfg(arch):
    import dataclasses

    return dataclasses.replace(j_get_config(arch).reduced(), dtype="float32")


# --------------------------------------------------------------------------- the reference's side
_REF_SCRIPT = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from repro.checkpoint.manager import _tree_flatten_with_names as names_of
from repro.configs import get_config
from repro.configs.base import MoEConfig
from repro.distributed.annotate import use_rules
from repro.distributed.collectives import compressed_psum_tree, ring_all_reduce
from repro.distributed.params import opt_state_shardings, tree_shardings
from repro.distributed.sharding import rules_for_mesh
from repro.launch.mesh import axis_types_kw
from repro.launch.steps import make_train_step
from repro.models import layers as L
from repro.models import moe as M
from repro.models.api import build_model
from repro.optim.adamw import AdamW, AdamWState

workdir = sys.argv[1]
models = eval(sys.argv[2])
seq_sharded = sys.argv[3]
inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
out = {}


def mesh_of(shape, names=("data", "model")):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, names, devices=jax.devices()[:n], **axis_types_kw(len(names)))


# collectives, the same (replicated) value on every device
m4 = mesh_of((4,), ("data",))
g = jnp.asarray(inp["coll_g"][0])
red, fb = compressed_psum_tree({"w": g}, m4, "data")
out["cmp_same_red"], out["cmp_same_fb"] = np.asarray(red["w"]), np.asarray(fb["w"])
out["ring_same"] = np.asarray(ring_all_reduce(g, m4, "data"))

# MoE
mesh = mesh_of((4, 2))
p = {k[len("moe_p_"):]: jnp.asarray(v) for k, v in inp.items() if k.startswith("moe_p_")}
x = jnp.asarray(inp["moe_x"])
for cf in (8.0, 1.0):
    cfg = MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, num_shared_experts=1,
                    capacity_factor=cf)
    with mesh:
        y, aux = jax.jit(lambda x: M.moe_block(x, p, cfg, "silu", dispatch="a2a", mesh=mesh))(x)
        out[f"a2a_{cf}"], out[f"a2a_aux_{cf}"] = np.asarray(y), np.asarray(aux)
        with use_rules(mesh, rules_for_mesh(mesh)):
            y, aux = jax.jit(lambda x: M.moe_block(x, p, cfg, "silu", dispatch="a2a",
                                                   mesh=mesh))(x)
        out[f"a2a_rules_{cf}"], out[f"a2a_rules_aux_{cf}"] = np.asarray(y), np.asarray(aux)
    y, _ = jax.jit(lambda x: M.moe_block(x, p, cfg, "silu", dispatch="dense"))(x)
    out[f"dense_{cf}"] = np.asarray(y)

# manual TP at tp 2 and the sharded flash
mesh = mesh_of((2, 2))
rules = rules_for_mesh(mesh)
tx = jnp.asarray(inp["tp_x"])
tp = {k: jnp.asarray(inp["tp_" + k]) for k in ("w1", "w3", "w2")}
with mesh, use_rules(mesh, rules):
    out["mlp"] = np.asarray(jax.jit(lambda x: L.gated_mlp(x, tp, "silu", tp_comm="manual_bf16"))(tx))
    out["rpo"] = np.asarray(jax.jit(lambda o, w: L.row_parallel_out(o, w, tp_comm="manual_bf16"))(
        jnp.asarray(inp["tp_o"]), jnp.asarray(inp["tp_wo"])))
    ct = jnp.asarray(inp["tp_ct"])
    gx, gp = jax.jit(jax.grad(lambda x, p: jnp.sum(L.gated_mlp(x, p, "silu", tp_comm="manual_bf16") * ct),
                              argnums=(0, 1)))(tx, tp)
    out["mlp_gx"], out["mlp_gw1"], out["mlp_gw2"] = np.asarray(gx), np.asarray(gp["w1"]), np.asarray(gp["w2"])
    q, k, v = (jnp.asarray(inp["fl_" + n]) for n in "qkv")
    out["flash_kv_sharded"] = np.asarray(jax.jit(
        lambda q, k, v: L.attention_trainable(q, k, v, impl="flash"))(q, k, v))
out["flash_kv_sharded_plain"] = np.asarray(L.attention_trainable(q, k, v, impl="flash"))
mesh14 = mesh_of((1, 4))
q, k, v = (jnp.asarray(inp["fr_" + n]) for n in "qkv")
with mesh14, use_rules(mesh14, rules_for_mesh(mesh14)):
    out["flash_kv_replicated"] = np.asarray(jax.jit(
        lambda q, k, v: L.attention_trainable(q, k, v, impl="flash"))(q, k, v))
out["flash_rep_plain"] = np.asarray(L.attention_trainable(q, k, v, impl="flash"))
ct = jnp.asarray(inp["fr_ct"])
gq, gk = jax.grad(lambda q, k: jnp.sum(L.attention_trainable(q, k, v, impl="flash") * ct),
                  argnums=(0, 1))(q, k)
out["flash_rep_gq"], out["flash_rep_gk"] = np.asarray(gq), np.asarray(gk)

# the reduced models on the (2, 2) mesh
for arch, kw in models:
    pre = f"m_{arch}_"
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = build_model(cfg, mesh=mesh, **kw)
    p_abs = jax.eval_shape(model.init, jax.random.key(0))
    leaves = [jnp.asarray(inp[pre + "p/" + n]) for n, _ in names_of(p_abs)]
    params = jax.tree.unflatten(jax.tree.structure(p_abs), leaves)
    with mesh, use_rules(mesh, rules):
        params = jax.device_put(params, tree_shardings(params, mesh, rules))
        cache, logits, _ = jax.jit(model.prefill, static_argnums=(2,))(
            params, {"tokens": jnp.asarray(inp[pre + "tokens"])}, 32)
        out[pre + "prefill"] = np.asarray(logits)
        dec = jax.jit(model.decode_step)
        for i, tok in enumerate(inp[pre + "decode_tokens"]):
            logits, cache = dec(params, cache, jnp.asarray(tok))
            out[pre + f"decode{i}"] = np.asarray(logits)
        moment = lambda w: jax.tree.unflatten(jax.tree.structure(p_abs), [  # noqa: E731
            jnp.asarray(inp[pre + f"o/{w}/" + n]) for n, _ in names_of(p_abs)])
        opt_state = AdamWState(step=jnp.asarray(inp[pre + "o/step"]), m=moment("m"),
                               v=moment("v"))
        opt_state = jax.device_put(opt_state, opt_state_shardings(opt_state, params, mesh, rules))
        out[pre + "zero1_m_specs"] = np.array(
            [str(tuple(s.spec)) for s in jax.tree.leaves(opt_state_shardings(opt_state, params, mesh, rules).m)])
        opt = AdamW(lr=1e-3)
        new_p, new_o, met = jax.jit(make_train_step(model, opt))(
            params, opt_state, {"tokens": jnp.asarray(inp[pre + "train_tokens"])})
        out[pre + "loss"], out[pre + "gnorm"] = np.asarray(met["loss"]), np.asarray(met["grad_norm"])
        for n, leaf in names_of(new_p):
            out[pre + "np/" + n] = np.asarray(leaf)
        for n, leaf in names_of(new_o.m):
            out[pre + "nm/" + n] = np.asarray(leaf)
    if arch == seq_sharded:
        seq_rules = rules_for_mesh(mesh, overrides={"seq": "model"})
        with mesh, use_rules(mesh, seq_rules):
            p2 = jax.device_put(params, tree_shardings(params, mesh, seq_rules))
            cache, logits, _ = jax.jit(model.prefill, static_argnums=(2,))(
                p2, {"tokens": jnp.asarray(inp[pre + "tokens"])}, 32)
            out[pre + "seq_prefill"] = np.asarray(logits)
            dec = jax.jit(model.decode_step)
            for i, tok in enumerate(inp[pre + "decode_tokens"]):
                logits, cache = dec(p2, cache, jnp.asarray(tok))
                out[pre + f"seq_decode{i}"] = np.asarray(logits)
np.savez(os.path.join(workdir, "ref.npz"), **out)
print("REF OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides, run at the same time: the reference's subprocess and the
    port's 4 ranks.  Returns (reference outputs, {check: port outputs}, inputs)."""
    workdir = tmp_path_factory.mktemp("dist")
    inp = _inputs(workdir)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, str(workdir), repr(W.MODELS), W.SEQ_SHARDED],
        env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # the (4, 2) MoE mesh takes 8 ranks, the rest 4: both groups at once
        groups = [tmp.start_processes(W.run, args=(n, _free_port(), str(workdir), checks),
                                      nprocs=n, join=False, start_method="spawn")
                  for n, checks in ((8, ["moe"]),
                                    (4, [c for c in W.CHECKS if c != "moe"]))]
        for g in groups:
            while not g.join():
                pass
    except Exception:
        errors = sorted(workdir.glob("error_*.txt"))
        raise AssertionError(errors[0].read_text() if errors else "a rank failed")
    finally:
        out, err = ref.communicate(timeout=900)
    assert ref.returncode == 0 and "REF OK" in out, err[-3000:]
    port = {n: dict(np.load(workdir / f"port_{n}.npz")) for n in W.CHECKS}
    ref_out = dict(np.load(workdir / "ref.npz"))
    port["placement_locals"] = [np.load(workdir / f"placement_local_{r}.npy") for r in range(4)]
    return ref_out, port, inp


# --------------------------------------------------------------------------- collectives
def test_ring_all_reduce_4_ranks_is_the_exact_sum(runs):
    ref, port, inp = runs
    np.testing.assert_allclose(port["collectives"]["ring"], inp["coll_x"].sum(0), rtol=1e-6)
    # the same value on every rank: the reference's 4 devices' psum of it
    np.testing.assert_allclose(port["collectives"]["ring_same"], ref["ring_same"], rtol=1e-6)


def test_compressed_psum_4_ranks(runs):
    """Each rank its own gradient and error feedback: int8 values summed as
    int32, scales averaged, feedback g32 - decompress(q, scale), with the
    reference's own quantizer; the replicated case against the
    reference's 4-device reduction bit for bit."""
    from repro.optim.gradients import compress_int8, decompress_int8

    ref, port, inp = runs
    qs, scales, fbs = [], [], []
    for r in range(4):
        g32 = inp["coll_g"][r] + inp["coll_e"][r]
        q, s = compress_int8(jnp.asarray(g32))
        qs.append(np.asarray(q, np.int32))
        scales.append(float(s))
        fbs.append(g32 - np.asarray(decompress_int8(q, s, jnp.float32)))
    want = (np.sum(qs, 0).astype(np.float32) * np.float32(np.mean(np.float32(scales))) / 4)
    np.testing.assert_allclose(port["collectives"]["cmp_red"], want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(port["collectives"]["cmp_fb"], fbs[0])
    np.testing.assert_array_equal(port["collectives"]["cmp_same_red"], ref["cmp_same_red"])
    np.testing.assert_array_equal(port["collectives"]["cmp_same_fb"], ref["cmp_same_fb"])


# --------------------------------------------------------------------------- MoE a2a
@pytest.mark.parametrize("rules", ["no rules", "rules"])
@pytest.mark.parametrize("cf", [8.0, 1.0], ids=["no-drop", "dropping"])
def test_moe_a2a_4x2_matches_the_reference(runs, cf, rules):
    ref, port, _ = runs
    pre = "a2a_" if rules == "no rules" else "a2a_rules_"
    close(port["moe"][f"{pre}{cf}"], ref[f"{pre}{cf}"], BLOCK_RTOL)
    close(port["moe"][f"{pre}aux_{cf}"], ref[f"{pre}aux_{cf}"], 1e-6)


def test_moe_a2a_equals_dense_without_drops_and_differs_with_them(runs):
    ref, port, _ = runs
    close(port["moe"]["a2a_8.0"], ref["dense_8.0"], BLOCK_RTOL)
    close(port["moe"]["a2a_8.0"], port["moe"]["dense_8.0"], BLOCK_RTOL)
    # capacity 1 token an expert per data shard: the a2a drops (its own
    # capacity, int(cf k t_local / E) + 1 on each shard's tokens)
    assert np.abs(port["moe"]["a2a_1.0"] - port["moe"]["dense_1.0"]).max() > 1e-3


# --------------------------------------------------------------------------- manual TP
@pytest.mark.parametrize("what", ["mlp", "rpo", "mlp_gx", "mlp_gw1", "mlp_gw2"])
def test_manual_bf16_tp2_matches_the_reference(runs, what):
    ref, port, _ = runs
    close(port["layers"][what], ref[what], BLOCK_RTOL)


def test_manual_bf16_equals_the_plain_mlp(runs):
    _, port, _ = runs
    close(port["layers"]["mlp"], port["layers"]["mlp_plain"], BLOCK_RTOL)


# --------------------------------------------------------------------------- sharded flash
def test_sharded_flash_kv_sharded_matches_the_reference(runs):
    ref, port, _ = runs
    close(port["layers"]["flash_kv_sharded"], ref["flash_kv_sharded"], BLOCK_RTOL)
    close(port["layers"]["flash_kv_sharded"], ref["flash_kv_sharded_plain"], BLOCK_RTOL)


def test_sharded_flash_kv_replicated_equals_the_unsharded_result(runs):
    """KV heads replicated, query heads sharded: the port equals the
    unsharded attention, forward and gradients; the reference's sharded
    result is pinned as far off it."""
    ref, port, _ = runs
    close(port["layers"]["flash_kv_replicated"], ref["flash_rep_plain"], BLOCK_RTOL)
    close(port["layers"]["flash_kv_replicated"], port["layers"]["flash_rep_plain"], BLOCK_RTOL)
    close(port["layers"]["flash_rep_gq"], ref["flash_rep_gq"], BLOCK_RTOL)
    close(port["layers"]["flash_rep_gk"], ref["flash_rep_gk"], BLOCK_RTOL)
    off = float(np.abs(ref["flash_kv_replicated"] - ref["flash_rep_plain"]).max())
    assert off > 1.0, off


# --------------------------------------------------------------------------- reduced models
ARCHS = [a for a, _ in W.MODELS]


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_model_prefill_and_decode_on_2x2(runs, arch):
    ref, port, _ = runs
    pre = f"m_{arch}_"
    close(port["models"][pre + "prefill"], ref[pre + "prefill"], MODEL_RTOL, "prefill")
    for i in range(N_DECODE):
        close(port["models"][pre + f"decode{i}"], ref[pre + f"decode{i}"], MODEL_RTOL,
              f"decode step {i}")


def test_reduced_model_decode_with_a_sequence_sharded_cache(runs):
    """The KV cache's sequence dim over "model": the prefill fills rank 0's
    16 slots, the decode writes rank 1's (each rank writes its own shard in
    place), against the reference under the same rule."""
    ref, port, _ = runs
    pre = f"m_{W.SEQ_SHARDED}_"
    # (data, model): batch over "data", sequence over "model" (the KV heads
    # lose "model" to it)
    assert str(port["models"][pre + "seq_cache_placements"]) == "(Shard(dim=1), Shard(dim=2))"
    close(port["models"][pre + "seq_prefill"], ref[pre + "seq_prefill"], MODEL_RTOL, "prefill")
    for i in range(N_DECODE):
        close(port["models"][pre + f"seq_decode{i}"], ref[pre + f"seq_decode{i}"], MODEL_RTOL,
              f"decode step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_model_zero1_train_step_on_2x2(runs, arch):
    ref, port, _ = runs
    pre = f"m_{arch}_"
    got = port["models"]
    close(got[pre + "loss"], ref[pre + "loss"], MODEL_RTOL, "loss")
    close(got[pre + "gnorm"], ref[pre + "gnorm"], MODEL_RTOL, "grad norm")
    names = [k for k in ref if k.startswith(pre + "np/") or k.startswith(pre + "nm/")]
    assert names and all(k in got for k in names)
    for k in names:
        close(got[k], ref[k], MODEL_RTOL, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_moments_are_laid_out_by_the_reference_specs(runs, arch):
    """The moments' DTensor placements are the reference's ZeRO-1 specs on
    the (2, 2) mesh, leaf for leaf."""
    from repro_torch.distributed.sharding import placements

    ref, port, _ = runs
    pre = f"m_{arch}_"
    mesh = type("M", (), {"mesh_dim_names": ("data", "model")})()
    want = [str(tuple(placements(mesh, eval(s)))) for s in ref[pre + "zero1_m_specs"]]
    got = [s for s in port["models"][pre + "zero1_m_placed"]]
    assert len(got) == len(want) and got == want
    assert any("Shard" in s for s in got)


@pytest.mark.parametrize("arch", W.FAMILIES)
def test_other_families_on_2x2_equal_their_unsharded_run(runs, arch):
    """Prefill and 12 decode steps on the (2, 2) mesh: the ring caches
    wrap (window 8), hymba keeps its meta tokens, the SSM state carries."""
    _, port, _ = runs
    got = port["families"]
    for i, (m, p) in enumerate(zip(got[arch + "_mesh"], got[arch + "_plain"])):
        close(m, p, MODEL_RTOL, f"{'prefill' if i == 0 else f'decode step {i - 1}'}")


# --------------------------------------------------------------------------- restore / prefetch
def test_restore_with_shardings_on_2x2(runs):
    _, port, inp = runs
    got = port["placement"]
    assert int(got["ck_step"]) == 1
    np.testing.assert_array_equal(got["ck_w"], inp["ck_w"])
    np.testing.assert_array_equal(got["ck_wq"], inp["ck_wq"])
    # "wq" is (None, "qkv_flat"): columns over "model", replicated over "data"
    assert str(got["ck_wq_placements"]) == "(Replicate(), Shard(dim=1))"
    locs = port["placement_locals"]
    for r in range(4):
        np.testing.assert_array_equal(locs[r], np.split(inp["ck_wq"], 2, axis=1)[r % 2])


def test_prefetcher_with_shardings_on_2x2(runs):
    from repro.configs import get_config
    from repro.data.pipeline import SyntheticLMDataset

    _, port, _ = runs
    got = port["placement"]
    want = SyntheticLMDataset(get_config("tinyllama-1.1b").reduced(), 4, 16, seed=3).batch_at(2)
    assert int(got["pf_step"]) == 2
    np.testing.assert_array_equal(got["pf_tokens"], want["tokens"])
    # tokens are ("batch", None): rows over "data"
    assert str(got["pf_placements"]) == "(Shard(dim=0), Replicate())"
    np.testing.assert_array_equal(got["pf_local"], want["tokens"][:2])
