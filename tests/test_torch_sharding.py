"""The port's sharding rules, parameter / cache / batch specs, annotations,
meshes and one-rank collectives (``repro_torch.distributed``,
``repro_torch.launch.mesh``) against the JAX package's.

* every case of ``test_distributed.py``'s sharding and ZeRO-1 tests, on
  both packages' ``ShardingRules``;
* for all ten architectures at full width, every leaf's spec of the
  parameter tree, the decode caches (decode_32k and long_500k) and the
  train / prefill / decode batches, and every ZeRO-1 moment spec, on the
  16x16 and 2x16x16 production meshes, with the default rules and with the
  dry-run's per-cell overrides (sequence-sharded KV where the KV heads do
  not divide, FSDP experts for llama4): equal entry for entry.  The
  reference's trees come from ``jax.eval_shape`` and its rules from a
  stand-in mesh (axis names and a devices array of the right shape); the
  port's trees are built under ``FakeTensorMode`` (no memory) and its
  meshes by ``make_production_mesh`` under the fake process group, in a
  subprocess of its own (a process has one default group);
* the spec -> DTensor placements conversion, ``ann`` with no context, and
  the collectives on a one-rank mesh, as ``test_distributed.py`` holds the
  reference's.

Specs are compared exactly.
"""
import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs.base import SHAPES_BY_NAME
from repro.distributed import params as jparams
from repro.distributed import sharding as jsh
from repro.models.api import build_model as j_build
from repro.models.api import make_batch_specs
from repro_torch.distributed import ann, use_rules
from repro_torch.distributed import params as tparams
from repro_torch.distributed import sharding as tsh

SRC = str(Path(__file__).resolve().parent.parent / "src")
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
CACHE_SHAPES = ("decode_32k", "long_500k")
BATCH_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def _rules(pkg, model=16, data=16, pod=None):
    axes = {"data": data, "model": model}
    if pod:
        axes["pod"] = pod
    table = {
        "batch": tuple(a for a in ("pod", "data") if a in axes),
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "seq": None,
    }
    return pkg.ShardingRules(mesh_axes=axes, table=table)


PKGS = pytest.mark.parametrize("pkg", [jsh, tsh], ids=["reference", "port"])


def _P(pkg, *parts):
    return JP(*parts) if pkg is jsh else tsh.P(*parts)


# --------------------------------------------------------------------------- test_distributed.py's cases
@PKGS
def test_divisibility_fallback(pkg):
    r = _rules(pkg)
    assert r.spec((32, 128, 25, 64), ("batch", None, "heads", None)) == _P(pkg, "data", None, None, None)
    assert r.spec((32, 128, 64, 64), ("batch", None, "heads", None)) == _P(pkg, "data", None, "model", None)
    assert r.spec((50280, 1024), ("vocab", None)) == _P(pkg, None, None)
    assert r.spec((262144, 1024), ("vocab", None)) == _P(pkg, "model", None)


@PKGS
def test_no_duplicate_mesh_axes(pkg):
    assert _rules(pkg).spec((64, 22016), ("heads", "mlp")) == _P(pkg, "model", None)


@PKGS
def test_multi_axis_batch(pkg):
    r = _rules(pkg, pod=2)
    assert r.spec((256, 4096), ("batch", None)) == _P(pkg, ("pod", "data"), None)
    assert r.spec((2, 16), ("batch", None)) == _P(pkg, None, None)


@pytest.mark.parametrize("pkg,params", [(jsh, jparams), (tsh, tparams)], ids=["reference", "port"])
def test_zero1_pspec(pkg, params):
    r = _rules(pkg)
    assert params.zero1_pspec(_P(pkg, None, "model"), (4096, 22016), r) == _P(pkg, "data", "model")
    assert params.zero1_pspec(_P(pkg, None), (17,), r) == _P(pkg, None)


def test_spec_equality_is_entry_for_entry():
    assert tsh.P(None, "model") == (None, "model") == tuple(JP(None, "model"))
    assert tsh.P(("pod", "data"), None) != tsh.P("data", None)
    assert list(tsh.P("a", None)) == ["a", None] and len(tsh.P()) == 0


# --------------------------------------------------------------------------- full-width trees
def _cell_overrides(cfg, axes, shape_kind):
    """The dry-run's per-cell rules (``repro.launch.dryrun.make_cell_rules``)."""
    ov = {}
    tp = dict(zip(*axes)).get("model", 1)
    if shape_kind in ("decode", "prefill") and cfg.num_kv_heads and cfg.num_kv_heads % tp:
        ov["seq"] = "model"
    if cfg.name == "llama4-maverick-400b-a17b":
        ov["fsdp"] = tuple(a for a in ("pod", "data") if a in axes[0])
    return ov


def _abstract(x):
    return [list(x.shape), str(x.dtype)]


def _jax_specs(tree, rules):
    specs = jparams.tree_pspecs(tree, rules)
    return [tuple(s) for s in jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, JP))]


# the port's side, in a process with the fake process group: builds both
# production meshes and every tree, and prints the specs as JSON
_PORT_SCRIPT = r"""
import json, sys
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.distributed import params as tp
from repro_torch.distributed import sharding as ts
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import build_model

jobs = json.load(open(sys.argv[1]))
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
meshes = {"16x16": make_production_mesh(device_type="cpu"),
          "2x16x16": make_production_mesh(multi_pod=True, device_type="cpu")}
names = {k: [list(m.mesh_dim_names), list(m.shape)] for k, m in meshes.items()}
dt = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


def meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def specs(t, rules):
    return [[list(a) if isinstance(a, tuple) else a for a in s]
            for s in tree.leaves(tp.tree_pspecs(t, rules))]


out = {}
for job in jobs:
    cfg = get_config(job["arch"])
    mesh = meshes[job["mesh"]]
    rules = ts.rules_for_mesh(mesh, overrides=job["overrides"])
    model = build_model(cfg, device="cpu")
    with FakeTensorMode():
        if job["tree"] == "params":
            t = model.init(torch.Generator())
        elif job["tree"] == "cache":
            t = model.init_cache(*job["cache"])
    if job["tree"] == "batch":
        t = {k: torch.empty(s, dtype=dt[d], device="meta") for k, (s, d) in job["batch"].items()}
    t = tree.tree_map(meta, t)
    res = {"specs": specs(t, rules)}
    if job["tree"] == "params":
        z = tp.opt_state_shardings(None, t, mesh, rules)
        res["zero1"] = [[list(a) if isinstance(a, tuple) else a for a in s.spec]
                        for s in tree.leaves(z.m)]
    out[job["key"]] = res
print(json.dumps({"meshes": names, "out": out}))
"""


def _jobs():
    jobs, want = [], {}
    for mesh_name, axes in MESHES.items():
        stand = types.SimpleNamespace(axis_names=axes[0], devices=np.empty(axes[1]))
        for arch in ARCH_IDS:
            cfg = j_get_config(arch)
            model = j_build(cfg)
            for rules_kind in ("default", "cell"):
                def rules_for(kind):
                    ov = _cell_overrides(cfg, axes, kind) if rules_kind == "cell" else {}
                    return ov, jsh.rules_for_mesh(stand, overrides=ov)

                ov, rules = rules_for("train")
                key = f"{arch}/{mesh_name}/{rules_kind}/params"
                p_abs = jax.eval_shape(model.init, jax.random.key(0))
                jspecs = _jax_specs(p_abs, rules)
                z = [tuple(jparams.zero1_pspec(s, leaf.shape, rules))
                     for s, leaf in zip(jax.tree.leaves(jparams.tree_pspecs(p_abs, rules),
                                                        is_leaf=lambda s: isinstance(s, JP)),
                                        jax.tree.leaves(p_abs))]
                jobs.append(dict(key=key, arch=arch, mesh=mesh_name, overrides=ov, tree="params"))
                want[key] = {"specs": jspecs, "zero1": z}
                for shape_name in CACHE_SHAPES:
                    shape = SHAPES_BY_NAME[shape_name]
                    ov, rules = rules_for(shape.kind)
                    key = f"{arch}/{mesh_name}/{rules_kind}/cache/{shape_name}"
                    c_abs = jax.eval_shape(
                        lambda: model.init_cache(shape.global_batch, shape.seq_len))
                    jobs.append(dict(key=key, arch=arch, mesh=mesh_name, overrides=ov,
                                     tree="cache", cache=[shape.global_batch, shape.seq_len]))
                    want[key] = {"specs": _jax_specs(c_abs, rules)}
                for shape_name in BATCH_SHAPES:
                    shape = SHAPES_BY_NAME[shape_name]
                    ov, rules = rules_for(shape.kind)
                    key = f"{arch}/{mesh_name}/{rules_kind}/batch/{shape_name}"
                    b_abs = make_batch_specs(cfg, shape)
                    jobs.append(dict(key=key, arch=arch, mesh=mesh_name, overrides=ov,
                                     tree="batch",
                                     batch={k: _abstract(v) for k, v in b_abs.items()}))
                    want[key] = {"specs": _jax_specs(b_abs, rules)}
    return jobs, want


def _tup(spec):
    return tuple(tuple(a) if isinstance(a, list) else a for a in spec)


@pytest.fixture(scope="module")
def full_width(tmp_path_factory):
    jobs, want = _jobs()
    path = tmp_path_factory.mktemp("specs") / "jobs.json"
    path.write_text(json.dumps(jobs))
    res = subprocess.run([sys.executable, "-c", _PORT_SCRIPT, str(path)],
                         env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    return got, want


def test_production_meshes_under_the_fake_process_group(full_width):
    got, _ = full_width
    assert got["meshes"] == {"16x16": [["data", "model"], [16, 16]],
                             "2x16x16": [["pod", "data", "model"], [2, 16, 16]]}


KINDS = ["params", "zero1"] + [f"cache/{s}" for s in CACHE_SHAPES] + [f"batch/{s}" for s in BATCH_SHAPES]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rules_kind", ["default", "cell"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_width_specs_equal_the_reference(full_width, arch, mesh_name, rules_kind, kind):
    got, want = full_width
    field = "zero1" if kind == "zero1" else "specs"
    key = f"{arch}/{mesh_name}/{rules_kind}/{'params' if kind == 'zero1' else kind}"
    g = [_tup(s) for s in got["out"][key][field]]
    w = [_tup(s) for s in want[key][field]]
    assert len(g) == len(w) > 0
    bad = [(i, a, b) for i, (a, b) in enumerate(zip(g, w)) if a != b]
    assert not bad, bad[:5]


# --------------------------------------------------------------------------- placements, ann, collectives
def _stand_in_mesh(names, shape):
    return types.SimpleNamespace(mesh_dim_names=tuple(names), shape=tuple(shape))


def test_placements_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _stand_in_mesh(("pod", "data", "model"), (2, 16, 16))
    assert tsh.placements(mesh, tsh.P(("pod", "data"), None, "model")) == [Shard(0), Shard(0), Shard(2)]
    assert tsh.placements(mesh, tsh.P(None, None)) == [Replicate()] * 3
    with pytest.raises(ValueError, match="axis order"):
        tsh.placements(mesh, tsh.P(("data", "pod")))
    rules = tsh.rules_for_mesh(mesh)
    assert rules.mesh_axes == {"pod": 2, "data": 16, "model": 16}
    assert rules.table["batch"] == ("pod", "data")


def test_ann_without_a_context_is_the_identity():
    x = torch.randn(2, 3, 4)
    assert ann(x, "batch", None, "embed") is x
    from repro_torch.distributed.annotate import _current, logical_sharding

    assert _current() is None and logical_sharding((2, 3), ("batch", None)) is None


@pytest.fixture(scope="module")
def one_rank():
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_host_mesh

    host = make_host_mesh(device="cpu")
    return host, init_device_mesh("cpu", (1,), mesh_dim_names=("data",))


def test_host_mesh(one_rank):
    host, _ = one_rank
    assert host.mesh_dim_names == ("data", "model") and tuple(host.shape) == (1, 1)
    assert host.device_type == "cpu"
    rules = tsh.rules_for_mesh(host)
    # every spec resolves to replication at axis size 1
    assert rules.spec((8, 128, 32, 64), ("batch", None, "heads", None)) == (None,) * 4


def test_use_rules_nests_and_restores(one_rank):
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.annotate import _current

    host, _ = one_rank
    rules = tsh.rules_for_mesh(host)
    before = DTensor._op_dispatcher._allow_implicit_replication
    with use_rules(host, rules):
        with use_rules(host, rules):
            y = ann(torch.ones(2, 3), "batch", None)
        assert isinstance(y, DTensor) and _current() == (host, rules)
        assert torch.equal((y + torch.ones(2, 3)).full_tensor(), torch.full((2, 3), 2.0))
    assert _current() is None
    assert DTensor._op_dispatcher._allow_implicit_replication == before


def test_rules_are_seen_from_other_threads(one_rank):
    """Autograd runs the backward of CUDA work (and a checkpointed layer's
    replayed forward) on a thread of its own: the context is the
    process's."""
    import threading

    from repro_torch.distributed.annotate import _current

    host, _ = one_rank
    rules = tsh.rules_for_mesh(host)
    seen = []
    with use_rules(host, rules):
        t = threading.Thread(target=lambda: seen.append(_current()))
        t.start()
        t.join()
    assert seen == [(host, rules)]


def test_flash_refuses_a_dtensor(one_rank):
    from repro_torch.kernels.flash_attention import flash_attention

    host, _ = one_rank
    q = torch.zeros(1, 4, 2, 32)
    with use_rules(host, tsh.rules_for_mesh(host)):
        with pytest.raises(TypeError, match="DTensor"):
            flash_attention(ann(q, "batch", None, "heads", None), q, q)


@pytest.mark.parametrize("H,KV,tp", [(8, 2, 4), (32, 4, 16), (32, 4, 2), (12, 3, 2), (25, 5, 5),
                                     (6, 2, 3)])
def test_kv_heads_of_a_query_head_shard(H, KV, tp):
    """Each rank's KV heads: with the kernel's group size n_local / len(idx)
    every local query head reads the KV head its global head reads."""
    from repro_torch.models.layers import _kv_heads_of

    n_local = H // tp
    for r in range(tp):
        idx = _kv_heads_of(r * n_local, n_local, H, KV, "cpu").tolist()
        group = n_local // len(idx)
        assert group * len(idx) == n_local
        assert [idx[j // group] for j in range(n_local)] == [
            (r * n_local + j) // (H // KV) for j in range(n_local)]


def test_compressed_psum_single_rank(one_rank):
    """test_distributed.py's n = 1 case, and the port's error feedback and
    sums equal to the reference's."""
    from repro.distributed.collectives import compressed_psum_tree as j_cpt
    from repro_torch.distributed.collectives import compressed_psum_tree

    _, mesh = one_rank
    g = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    red, fb = compressed_psum_tree({"w": torch.from_numpy(g)}, mesh, "data")
    err = np.abs(red["w"].numpy() - g).max()
    scale = np.abs(g).max() / 127
    assert err <= scale * 1.01
    assert np.abs(fb["w"].numpy()).max() <= scale * 1.01
    jmesh = jax.make_mesh((1,), ("data",))
    jred, jfb = j_cpt({"w": jax.numpy.asarray(g)}, jmesh, "data")
    np.testing.assert_array_equal(red["w"].numpy(), np.asarray(jred["w"]))
    np.testing.assert_array_equal(fb["w"].numpy(), np.asarray(jfb["w"]))


def test_ring_all_reduce_single_rank(one_rank):
    from repro_torch.distributed.collectives import ring_all_reduce

    _, mesh = one_rank
    x = torch.arange(12.0).reshape(3, 4)
    assert torch.equal(ring_all_reduce(x, mesh, "data"), x)
