"""The port's checkpoint manager (repro_torch.checkpoint) against the JAX
package's: the counterparts of tests/test_checkpoint.py, and the on-disk
format, which must be the reference's byte for byte (manifest.json and the
.bin files; the .delta.npz archives carry a timestamp, so their arrays are
compared).  Every comparison is of bits: tolerance 0."""
import json
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro.checkpoint import CheckpointConfig as JConfig
from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint.manager import _tree_flatten_with_names as j_names
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import tree as ttree
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.checkpoint import manager as tman
from repro_torch.optim.adamw import AdamW as TAdamW


def tbits(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def bf16_bits(rng, shape) -> np.ndarray:
    return (rng.normal(size=shape).astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)


def _tree(rng, scale=1.0):
    """The reference test's tree, as torch tensors."""
    return {
        "params": {
            "w": torch.from_numpy((rng.normal(size=(64, 32)) * scale).astype(np.float32)),
            "b": torch.from_numpy((rng.normal(size=(32,)) * scale).astype(np.float32)
                                  ).to(torch.bfloat16),
        },
        "step_count": torch.tensor(3, dtype=torch.int32),
    }


def same_tree(a, b) -> bool:
    la, ta = ttree.flatten(a)
    lb, tb = ttree.flatten(b)
    return ta == tb and all(x.dtype == y.dtype and x.shape == y.shape and tbits(x) == tbits(y)
                            for x, y in zip(la, lb))


def plus_one(t):
    return ttree.tree_map(lambda x: x + 1, t)


# --------------------------------------------------------------------------- the reference's tests
def test_full_roundtrip(tmp_path, rng):
    m = CheckpointManager(CheckpointConfig(directory=str(tmp_path), async_save=False))
    t = _tree(rng)
    m.save(1, t)
    step, restored = m.restore(treedef_like=t)
    assert step == 1
    assert same_tree(restored, t)
    assert all(isinstance(x, torch.Tensor) for x in ttree.leaves(restored))


def test_delta_saves_space_and_roundtrips(tmp_path, rng):
    m = CheckpointManager(
        CheckpointConfig(directory=str(tmp_path), async_save=False, full_every=100))
    t = _tree(rng)
    m.save(1, t)  # full
    t2 = ttree.tree_map(lambda x: x.clone(), t)
    t2["params"]["w"][0, 0] += 1.0  # small change -> delta save
    m.save(2, t2)
    assert m.stats["delta_leaves"] >= 1
    assert m.stats["bytes_saved_by_delta"] > 0
    step, restored = m.restore(treedef_like=t)
    assert step == 2
    assert same_tree(restored, t2)


def test_delta_overflow_falls_back_to_full(tmp_path, rng):
    m = CheckpointManager(
        CheckpointConfig(directory=str(tmp_path), async_save=False, full_every=100,
                         delta_cap_frac=0.01))
    t = _tree(rng)
    m.save(1, t)
    t2 = plus_one(t)  # everything changes
    m.save(2, t2)
    assert m.stats["delta_overflows"] >= 1
    _, restored = m.restore(treedef_like=t)
    assert same_tree(restored, t2)


def test_crc_detects_corruption_and_falls_back(tmp_path, rng):
    m = CheckpointManager(CheckpointConfig(directory=str(tmp_path), async_save=False))
    t = _tree(rng)
    m.save(1, t)
    m.save(2, plus_one(t), force_full=True)
    target = tmp_path / "step_00000002" / "params__w.bin"  # corrupt the newest save
    raw = bytearray(target.read_bytes())
    raw[10] ^= 0xFF
    target.write_bytes(bytes(raw))
    step, restored = m.restore(treedef_like=t)
    assert step == 1  # fell back past the corrupt save
    assert same_tree(restored, t)


def test_replica_recovers_corruption(tmp_path, rng):
    m = CheckpointManager(
        CheckpointConfig(directory=str(tmp_path / "ck"), async_save=False, replicas=2))
    t = _tree(rng)
    m.save(1, t)
    target = tmp_path / "ck" / "step_00000001" / "params__w.bin"
    raw = bytearray(target.read_bytes())
    raw[0] ^= 0xFF
    target.write_bytes(bytes(raw))
    step, restored = m.restore(treedef_like=t)  # the replica saves the day
    assert step == 1
    assert same_tree(restored, t)


def test_async_save_overlaps(tmp_path, rng):
    m = CheckpointManager(CheckpointConfig(directory=str(tmp_path), async_save=True))
    t = _tree(rng)
    m.save(1, t)  # returns immediately
    m.save(2, plus_one(t))  # waits for save 1 internally
    m.wait()
    assert m.all_steps() == [1, 2]


def test_restore_with_shardings_is_not_ported(tmp_path, rng):
    """In place of the reference's elastic-resharding test (the name is kept
    from when restore onto a mesh was not ported): a save of the tree laid
    out on the one-rank host mesh writes the same files as a save of the
    plain tree, and ``restore(shardings=)`` gives each leaf back as a
    DTensor with its sharding's placements and the saved values.  Several
    ranks: test_torch_distributed.py."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import rules_for_mesh
    from repro_torch.distributed.params import tree_shardings
    from repro_torch.distributed.sharding import place
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device="cpu")
    t = _tree(rng)
    sh = tree_shardings(t, mesh, rules_for_mesh(mesh))
    plain = CheckpointManager(CheckpointConfig(directory=str(tmp_path / "a"), async_save=False))
    plain.save(1, t)
    m = CheckpointManager(CheckpointConfig(directory=str(tmp_path / "b"), async_save=False))
    m.save(1, ttree.tree_map(place, t, sh))
    for f in sorted((tmp_path / "a" / "step_00000001").iterdir()):
        assert f.read_bytes() == (tmp_path / "b" / "step_00000001" / f.name).read_bytes()
    step, got = m.restore(shardings=sh, treedef_like=t)
    assert step == 1
    for g, w, s in zip(ttree.leaves(got), ttree.leaves(t), ttree.leaves(sh)):
        assert isinstance(g, DTensor) and list(g.placements) == s.placements
        assert torch.equal(g.full_tensor(), w)


def test_kernel_crc_impl_equivalent(tmp_path, rng):
    """crc_impl='kernel' on a CPU Device (the CRC kernel's plain version)
    agrees with zlib on save, and restores through the same CRC."""
    t = {"w": torch.from_numpy(rng.normal(size=(32, 32)).astype(np.float32))}
    m = CheckpointManager(
        CheckpointConfig(directory=str(tmp_path / "a"), async_save=False, crc_impl="kernel"),
        device=T.make_device(device="cpu"))
    m.save(1, t)
    man = json.loads((tmp_path / "a" / "step_00000001" / "manifest.json").read_text())
    assert man["leaves"]["w"]["crc"] == zlib.crc32(tbits(t["w"])) & 0xFFFFFFFF
    assert same_tree(m.restore(treedef_like=t)[1], t)


def test_kernel_crc_routes_through_device(tmp_path, rng):
    """With a Device attached, kernel CRCs are engine descriptors: they agree
    with zlib AND show up in the device's submission telemetry as the fused
    copy+CRC op."""
    d = T.make_device(device="cpu")
    t = {"w": torch.from_numpy(rng.normal(size=(32, 32)).astype(np.float32))}
    m = CheckpointManager(
        CheckpointConfig(directory=str(tmp_path / "dev"), async_save=False,
                         crc_impl="kernel"),
        device=d)
    m.save(1, t)
    man = json.loads((tmp_path / "dev" / "step_00000001" / "manifest.json").read_text())
    assert man["leaves"]["w"]["crc"] == zlib.crc32(tbits(t["w"])) & 0xFFFFFFFF
    assert d.policy_stats["decisions_by_op"].get("dsa0/copy_crc", 0) >= 1


# --------------------------------------------------------------------------- kernel CRC placement
def test_kernel_crc_without_a_device_needs_cuda(tmp_path, monkeypatch):
    """No Device and no card: the kernel CRC raises (at construction, not in
    the save thread) rather than running a CRC on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        CheckpointManager(CheckpointConfig(directory=str(tmp_path), crc_impl="kernel"))
    CheckpointManager(CheckpointConfig(directory=str(tmp_path), crc_impl="zlib"))


def test_kernel_crc_words_go_to_the_devices_own_device(tmp_path, monkeypatch):
    seen = []
    real = tman._words
    monkeypatch.setattr(tman, "_words", lambda data, dev: seen.append(dev) or real(data, dev))
    m = CheckpointManager(CheckpointConfig(directory=str(tmp_path), async_save=False,
                                           crc_impl="kernel"),
                          device=T.make_device(device="cpu"))
    m.save(1, {"w": torch.arange(10, dtype=torch.int16)})  # 20 bytes: 5 words
    assert seen and all(d == torch.device("cpu") for d in seen)


def test_a_failed_async_save_raises_on_wait(tmp_path, rng, monkeypatch):
    m = CheckpointManager(CheckpointConfig(directory=str(tmp_path), async_save=True))

    def broken(*a):
        raise OSError("disk full")

    monkeypatch.setattr(m, "_write", broken)
    m.save(1, _tree(rng))
    with pytest.raises(OSError, match="disk full"):
        m.wait()
    m.wait()  # raised once


# --------------------------------------------------------------------------- the format, against the reference
def _pair_trees(rng):
    """The same tree for both packages: bf16 and fp32 leaves, a nested list
    whose dict keys are out of order, and an AdamWState."""
    w = rng.normal(size=(8, 6)).astype(np.float32)
    bits = bf16_bits(rng, (10,))
    jp = {"b": jnp.asarray(bits).view(jnp.bfloat16), "a": [jnp.asarray(w), jnp.asarray(w * 3)]}
    tp = {"b": torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16),
          "a": [torch.from_numpy(w), torch.from_numpy(w * 3)]}
    js, ts = JAdamW().init(jp), TAdamW().init(tp)
    js = js._replace(m=jax.tree.map(lambda x: x + 0.5, js.m))
    ts = ts._replace(m=ttree.tree_map(lambda x: x + 0.5, ts.m))
    return {"params": jp, "opt": js}, {"params": tp, "opt": ts}


def test_leaf_names_and_order_match_reference(rng):
    jt, tt = _pair_trees(rng)
    names = [k for k, _ in ttree.flatten_with_names(tt)]
    assert names == [k for k, _ in j_names(jt)]
    assert names[:2] == ["opt/.step", "opt/.m/a/0"] and names[-1] == "params/b"


def _drift(jt, tt):
    """Change word 0 of every fp32 leaf: a delta save on both sides."""
    def j(x):
        return x.at[(0,) * x.ndim].add(1.0) if x.dtype == jnp.float32 and x.ndim else x

    def t(x):
        if x.dtype == torch.float32 and x.dim():
            x = x.clone()
            x.view(-1)[0] += 1.0
        return x

    return jax.tree.map(j, jt), ttree.tree_map(t, tt)


def _save_both(tmp_path, jt, tt, **cfg):
    jm = JManager(JConfig(directory=str(tmp_path / "j"), async_save=False, **cfg))
    tm = CheckpointManager(CheckpointConfig(directory=str(tmp_path / "t"), async_save=False,
                                            **cfg))
    jt2, tt2 = _drift(jt, tt)
    jm.save(1, jt)
    tm.save(1, tt)
    jm.save(2, jt2)
    tm.save(2, tt2)
    return tt2


@pytest.mark.parametrize("replicas", [1, 2])
def test_files_are_byte_identical_to_the_reference(tmp_path, rng, replicas):
    jt, tt = _pair_trees(rng)
    _save_both(tmp_path, jt, tt, full_every=100, replicas=replicas)
    for step in ("step_00000001", "step_00000002"):
        jd, td = tmp_path / "j" / step, tmp_path / "t" / step
        names = sorted(p.name for p in jd.iterdir())
        assert names == sorted(p.name for p in td.iterdir())
        for name in names:
            if name.endswith(".npz"):
                a, b = np.load(jd / name), np.load(td / name)
                assert sorted(a.files) == sorted(b.files) == ["data", "offsets"]
                for k in a.files:
                    assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
            else:
                assert (jd / name).read_bytes() == (td / name).read_bytes(), name
    man = json.loads((tmp_path / "t" / "step_00000002" / "manifest.json").read_text())
    assert man["kind"] == "delta" and man["leaves"]["params/a/0"]["mode"] == "delta"
    assert man["leaves"]["params/b"]["dtype"] == "bfloat16"
    if replicas == 2:
        assert (Path(str(tmp_path / "t") + "-replica") / "step_00000002" / "manifest.json"
                ).read_bytes() == (tmp_path / "t" / "step_00000002" / "manifest.json").read_bytes()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cross_format_restore(tmp_path, rng, writer):
    """A full and a delta save written by one package restore bit for bit
    through the other."""
    jt, tt = _pair_trees(rng)
    tt2 = _save_both(tmp_path, jt, tt, full_every=100)
    src = tmp_path / ("j" if writer == "reference" else "t")
    if writer == "reference":
        m = CheckpointManager(CheckpointConfig(directory=str(src), async_save=False))
        for step, want in ((1, tt), (2, tt2)):
            s, got = m.restore(step, treedef_like=tt)
            assert s == step and same_tree(got, want)
    else:
        m = JManager(JConfig(directory=str(src), async_save=False))
        jt2, _ = _drift(jt, tt)
        for step, want in ((1, jt), (2, jt2)):
            s, got = m.restore(step, treedef_like=jt)
            assert s == step
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                assert np.asarray(a).dtype == np.asarray(b).dtype
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_dtype_names_round_trip():
    for dt, name in tman._DTYPE_NAMES.items():
        x = torch.zeros(3, dtype=dt)
        leaf = tman._host_leaf(x)
        assert leaf.dtype == name
        if name != "bfloat16":  # the one name numpy alone does not know
            assert str(np.dtype(name)) == name
        assert tman._tensor(leaf.data, leaf.dtype, leaf.shape).dtype == dt
    assert tman._tensor(b"", "float32", [0, 4]).shape == (0, 4)
