"""The port's second slice (fill, compare, delta records, DIF and the ``dto``
layer) against the JAX package's.

Every op is integer word work, so the tolerance is 0: the same inputs, made
with numpy from a seed, go through ``repro`` (its Pallas kernels in
interpret mode on the JAX CPU backend) and through ``repro_torch`` (the
plain PyTorch versions, which CPU tensors take), and the bytes must be
identical.  ``delta_apply`` is held against the reference only on records
that leave word 0 alone (the reference's oracle and fallback undo a change
there; see ``test_reference_oracle_loses_a_change_at_word_0``) and against a
serial walk of the record on all records."""
import ast
import inspect
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as J
import repro_torch.core as T
from repro.kernels import dif as jdif
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import api as tapi
from repro_torch.kernels import _build
from repro_torch.kernels import compare as tcmp
from repro_torch.kernels import delta_apply as tda
from repro_torch.kernels import delta_create as tdc
from repro_torch.kernels import dif as tdif
from repro_torch.kernels import fill as tfill
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = ["float32", "bfloat16", "uint32"]


def make(rng, shape, dtype):
    """The same values as a (jax array, torch tensor) pair."""
    if dtype == "float32":
        a = (rng.normal(size=shape) * 3).astype(np.float32)
        return jnp.asarray(a), torch.from_numpy(a.copy())
    if dtype == "bfloat16":
        f = (rng.normal(size=shape) * 3).astype(np.float32)
        bits = (f.view(np.uint32) >> 16).astype(np.uint16)
        return (jnp.asarray(bits).view(jnp.bfloat16),
                torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16))
    bits = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    return jnp.asarray(bits), torch.from_numpy(bits.view(np.int32).copy()).view(torch.uint32)


def tt(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).view(torch.uint32)
    return torch.from_numpy(a.copy())


def tbytes(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def same(t: torch.Tensor, a) -> bool:
    return (tuple(t.shape) == tuple(np.shape(a))
            and str(t.dtype).split(".")[-1] == str(np.asarray(a).dtype)
            and tbytes(t) == np.asarray(a).tobytes())


def words_np(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().reshape(-1).view(torch.int32).numpy().view(np.uint32)


def changed_at(x_np: np.ndarray, positions) -> np.ndarray:
    """``x_np`` with the words at ``positions`` of its word view flipped."""
    y = x_np.copy()
    w = y.reshape(-1).view(np.uint32)
    w[list(positions)] ^= np.uint32(0x00010001)
    return y


def serial_apply(ref_words: np.ndarray, offsets: np.ndarray, data: np.ndarray) -> np.ndarray:
    """The Pallas kernel's semantics, one entry after another."""
    out = ref_words.copy()
    for off, word in zip(offsets.tolist(), data.tolist()):
        if 0 <= off < out.size:
            out[off] = word
    return out


# --------------------------------------------------------------------------- fill
@pytest.mark.parametrize("n_words", [1, 5, 257, 1000, 4096])
@pytest.mark.parametrize("pattern", [(0xDEADBEEF,), (1, 0x80000001), (7, 8, 0xFFFFFFFF, 0)])
@pytest.mark.parametrize("n_pe", [1, 4])
def test_fill_matches_reference(n_words, pattern, n_pe):
    want = jops.fill(jnp.asarray(pattern, jnp.uint32), n_words, n_pe=n_pe)
    got = tops.fill(pattern, n_words, n_pe=n_pe, device="cpu")
    assert same(got, want)
    assert same(tref.fill_ref((n_words,), pattern), jref.fill_ref((n_words,), pattern))
    assert same(tops.fill(torch.tensor(pattern, dtype=torch.int64), n_words), want)


@pytest.mark.parametrize("dtype,shape", [("float32", (3, 130)), ("bfloat16", (1000,)),
                                         ("uint32", (64, 2))])
@pytest.mark.parametrize("pattern", [(0,), (0xABABABAB,), (1, 2, 3, 4)])
def test_fill_like_matches_reference(rng, dtype, shape, pattern):
    a, t = make(rng, shape, dtype)
    want = jops.fill_like(a, pattern)
    got = tops.fill_like(t, pattern)
    assert same(got, want) and got.device == t.device


# --------------------------------------------------------------------------- compare
@pytest.mark.parametrize("dtype,shape", [("float32", (257,)), ("bfloat16", (2000,)),
                                         ("uint32", (1000,)), ("float32", (33, 130))])
@pytest.mark.parametrize("where", [None, 0, "mid", "last"])
def test_compare_matches_reference(rng, dtype, shape, where):
    a, t = make(rng, shape, dtype)
    a_np = np.asarray(a)
    n = a_np.nbytes // 4
    pos = {None: [], 0: [0], "mid": [n // 2], "last": [n - 1]}[where]
    b_np = changed_at(a_np, pos)
    b = jnp.asarray(b_np)
    tb = tt(b_np) if dtype != "bfloat16" else torch.from_numpy(
        b_np.view(np.int16).copy()).view(torch.bfloat16)
    want_eq, want_first = jops.compare(a, b)
    got_eq, got_first = tops.compare(t, tb)
    assert same(got_eq, want_eq) and same(got_first, want_first)
    assert int(got_first) == (pos[0] if pos else -1)
    ref_eq, ref_first = tref.compare_ref(t, tb)
    assert bool(ref_eq) == bool(want_eq) and int(ref_first) == int(want_first)


def test_compare_ignores_the_reference_padding(rng):
    """257 words: the reference pads to 3 x 128 words and masks the pad; the
    port has no pad, and a difference in the last real word still counts."""
    a, t = make(rng, (257,), "uint32")
    b_np = changed_at(np.asarray(a), [256])
    assert int(jops.compare(a, jnp.asarray(b_np))[1]) == 256
    assert int(tops.compare(t, tt(b_np))[1]) == 256


# --------------------------------------------------------------------------- delta create
@pytest.mark.parametrize("dtype,shape", [("float32", (257,)), ("bfloat16", (1000, 2)),
                                         ("uint32", (4099,))])
@pytest.mark.parametrize("n_diff,cap", [(0, 64), (3, 64), (64, 64), (65, 64), (200, 16)])
def test_delta_create_matches_reference(rng, dtype, shape, n_diff, cap):
    a, t = make(rng, shape, dtype)
    a_np = np.asarray(a)
    n = a_np.nbytes // 4
    pos = [0] + sorted(rng.choice(np.arange(1, n), n_diff - 1, replace=False).tolist()) \
        if n_diff else []
    b_np = changed_at(a_np, pos)
    tb = torch.from_numpy(b_np.view(np.int16).copy()).view(torch.bfloat16) \
        if dtype == "bfloat16" else tt(b_np)
    want = jops.delta_create(jnp.asarray(b_np), a, cap=cap)
    got = tops.delta_create(tb, t, cap=cap)
    assert all(same(g, w) for g, w in zip(got, want))
    assert int(got[2]) == n_diff and bool(got[3]) == (n_diff > cap)
    oracle = jref.delta_create_ref(jnp.asarray(words_np(tb)), jnp.asarray(words_np(t)), cap)
    assert all(same(g, w) for g, w in zip(tref.delta_create_ref(tb, t, cap), oracle))


# --------------------------------------------------------------------------- delta apply
@pytest.mark.parametrize("dtype,shape", [("float32", (257,)), ("bfloat16", (1000, 2)),
                                         ("uint32", (4096,))])
@pytest.mark.parametrize("n_diff", [0, 1, 10, 100])
def test_delta_apply_matches_reference_away_from_word_0(rng, dtype, shape, n_diff):
    """Records from delta_create that do not change word 0: the port equals
    the reference's fallback and oracle, and restores the new buffer."""
    a, t = make(rng, shape, dtype)
    a_np = np.asarray(a)
    n = a_np.nbytes // 4
    pos = sorted(rng.choice(np.arange(1, n), n_diff, replace=False).tolist())
    b_np = changed_at(a_np, pos)
    off, data, _, _ = jops.delta_create(jnp.asarray(b_np), a, cap=128)
    t_off, t_data = tt(np.asarray(off)), tt(np.asarray(data))
    want = jops.delta_apply(a, off, data, use_kernel=False)
    got = tops.delta_apply(t, t_off, t_data)
    assert same(got, want) and tbytes(got) == b_np.tobytes()
    flat = jnp.asarray(words_np(t))
    assert same(tref.delta_apply_ref(t, t_off, t_data), want)
    assert np.array_equal(words_np(got), np.asarray(jref.delta_apply_ref(flat, off, data)))


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 300), st.integers(0, 64), st.data())
def test_delta_apply_equals_the_serial_walk(n, cap, data):
    """Any record: duplicates (the last wins), -1 pads anywhere, offsets past
    the end, word 0 among them."""
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31)))
    ref_words = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    offsets = rng.integers(-3, n + 3, cap).astype(np.int32)
    if cap > 1:
        offsets[cap // 2:] = np.where(rng.random(cap - cap // 2) < 0.5,
                                      offsets[: cap - cap // 2], offsets[cap // 2:])
    words = rng.integers(0, 2**32, cap, dtype=np.uint64).astype(np.uint32)
    want = serial_apply(ref_words, offsets, words)
    args = tt(ref_words), torch.from_numpy(offsets), tt(words)
    assert np.array_equal(words_np(tops.delta_apply(*args)), want)
    assert np.array_equal(words_np(tda.delta_apply_words_plain(*args)), want)
    assert np.array_equal(words_np(tref.delta_apply_ref(*args)), want)


def test_reference_oracle_loses_a_change_at_word_0(rng):
    """The reference's oracle and its ``use_kernel=False`` path clip the -1
    pads to offset 0 and write the old word 0 back after the real entries;
    the port keeps the change, as the Pallas kernel's serial walk does."""
    a, t = make(rng, (4096,), "uint32")
    b_np = changed_at(np.asarray(a), [0, 99, 2048])
    off, data, count, _ = jops.delta_create(jnp.asarray(b_np), a, cap=64)
    assert int(count) == 3
    lost_ref = np.asarray(jref.delta_apply_ref(a, off, data))
    lost_ops = np.asarray(jops.delta_apply(a, off, data, use_kernel=False))
    for lost in (lost_ref, lost_ops):
        assert lost[0] == np.asarray(a)[0] != b_np[0]  # the change at word 0 is undone
        assert np.array_equal(lost[1:], b_np[1:])
    got = tops.delta_apply(t, tt(np.asarray(off)), tt(np.asarray(data)))
    assert np.array_equal(words_np(got), b_np)


@pytest.mark.parametrize("dtype", DTYPES)
def test_delta_roundtrip_through_the_port(rng, dtype):
    a, t = make(rng, (64, 130), dtype)
    a_np = np.asarray(a)
    b_np = changed_at(a_np, [0, 1, 500, a_np.nbytes // 4 - 1])
    tb = torch.from_numpy(b_np.view(np.int16).copy()).view(torch.bfloat16) \
        if dtype == "bfloat16" else tt(b_np)
    off, data, count, overflow = tops.delta_create(tb, t, cap=8)
    assert int(count) == 4 and not bool(overflow)
    got = tops.delta_apply(t, off, data)
    assert got.dtype == t.dtype and got.shape == t.shape and tbytes(got) == b_np.tobytes()


# --------------------------------------------------------------------------- DIF
@pytest.mark.parametrize("n_blocks,block_words,ref_tag", [(1, 128, 0), (5, 128, 3),
                                                          (300, 16, 0x1234), (8, 1024, 0xFFFF)])
def test_dif_matches_reference(rng, n_blocks, block_words, ref_tag):
    words = rng.integers(0, 2**32, n_blocks * block_words, dtype=np.uint64).astype(np.uint32)
    ja, ta = jnp.asarray(words), tt(words)
    want = jdif.dif_insert(ja, block_words=block_words, ref_tag=ref_tag)
    framed = tdif.dif_insert(ta, block_words=block_words, ref_tag=ref_tag)
    assert same(framed, want)
    assert same(tref.dif_insert_ref(ta, block_words, ref_tag),
                jref.dif_insert_ref(ja, block_words, ref_tag))
    bad_np = np.asarray(want).copy()
    bad_np[n_blocks // 2, block_words // 3] ^= np.uint32(4)
    bad = tt(bad_np)
    want_ok = jdif.dif_check(jnp.asarray(bad_np), block_words=block_words)
    got_ok = tdif.dif_check(bad, block_words=block_words)
    assert same(got_ok, want_ok) and not bool(got_ok[n_blocks // 2])
    assert int(got_ok.sum()) == n_blocks - 1
    assert same(tref.dif_check_ref(bad, block_words), jref.dif_check_ref(bad_np, block_words))
    assert same(tdif.dif_strip(framed, block_words=block_words),
                jdif.dif_strip(want, block_words=block_words))
    assert same(tref.dif_strip_ref(framed, block_words), jref.dif_strip_ref(want, block_words))
    assert same(tdif.dif_update(bad, block_words=block_words, ref_tag=ref_tag + 1),
                jdif.dif_update(jnp.asarray(bad_np), block_words=block_words,
                                ref_tag=ref_tag + 1))


# --------------------------------------------------------------------------- dto
@pytest.fixture(scope="module")
def dto_devices():
    return J.make_device(), T.make_device(device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(16, 8), (64, 130)], ids=["below", "above"])
def test_dto_matches_reference(rng, dto_devices, dtype, shape):
    """memcpy/memset/memcmp under ``dto_enabled``: 512 bytes stay in plain
    code, 33 KiB go through the engine; the results agree either way,
    including the below-threshold memset that sets VALUES (quirk 2)."""
    jd, td = dto_devices
    a, t = make(rng, shape, dtype)
    b_np = changed_at(np.asarray(a), [7])
    tb = torch.from_numpy(b_np.view(np.int16).copy()).view(torch.bfloat16) \
        if dtype == "bfloat16" else tt(b_np)
    with J.dto_enabled(jd), T.dto_enabled(td):
        assert same(T.dto.memcpy(t), J.dto.memcpy(a))
        for byte in (0, 0xAB):
            assert same(T.dto.memset(t, byte), J.dto.memset(a, byte))
        assert T.dto.memcmp(t, t.clone()) == J.dto.memcmp(a, jnp.array(a)) is True
        assert T.dto.memcmp(t, tb) == J.dto.memcmp(a, jnp.asarray(b_np)) is False
    # outside the context: plain code, the same answers
    assert same(T.dto.memset(t, 0xAB), J.dto.memset(a, 0xAB))
    assert T.dto.memcmp(t, tb) is False


def test_dto_memset_is_bytewise_only_at_the_threshold(dto_devices):
    """Quirk 2, kept for parity: float32 memset(0xAB) is 0xABABABAB at or
    above ``min_bytes`` and 171.0 (bits 0x432B0000) below it."""
    _, td = dto_devices
    with T.dto_enabled(td, min_bytes=64):
        above = T.dto.memset(torch.zeros(16), 0xAB)
        below = T.dto.memset(torch.zeros(15), 0xAB)
    assert set(words_np(above).tolist()) == {0xABABABAB}
    assert set(words_np(below).tolist()) == {0x432B0000}


def test_dto_routes_through_the_engine_above_the_threshold(dto_devices):
    _, td = dto_devices
    before = sum(e.counters_snapshot()["completed"] for e in td.engines)
    with T.dto_enabled(td, min_bytes=1024) as dev:
        assert dev is td
        T.dto.memcpy(torch.zeros(256))  # 1 KiB: offloaded
        T.dto.memset(torch.zeros(256), 1)
        T.dto.memcmp(torch.zeros(256), torch.zeros(256))
        T.dto.memcpy(torch.zeros(255))  # below: plain
    td.drain()
    assert sum(e.counters_snapshot()["completed"] for e in td.engines) - before == 3


def test_dto_enabled_without_a_device_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with T.dto_enabled():
            pass
    assert T.dto is tapi.dto and T.dto_enabled is tapi.dto_enabled


@pytest.mark.parametrize("module", [T, tapi])
@pytest.mark.parametrize("name", ["Stream", "make_stream"])
def test_removed_stream_shims_say_where_to_go(module, name):
    with pytest.raises(AttributeError, match="removed.*make_device"):
        getattr(module, name)


# --------------------------------------------------------------------------- wrappers
def test_new_wrappers_check_their_operands():
    w = torch.zeros(64, dtype=torch.uint32)
    off = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="1, 2 or 4"):
        tfill.fill_words(8, (1, 2, 3), device="cpu")
    with pytest.raises(ValueError):
        tfill.fill_words(8, (1,), n_pe=0, device="cpu")
    with pytest.raises(ValueError):
        tfill.fill_words(8, (1,), device="meta")
    with pytest.raises(ValueError):
        tcmp.compare_words(w, w[:32])
    with pytest.raises(TypeError):
        tcmp.compare_words(w, w.view(torch.int32))
    with pytest.raises(ValueError):
        tdc.delta_record_words(w, w[:32], 4)
    with pytest.raises(ValueError):
        tdc.delta_record_words(w, w, -1)
    with pytest.raises(ValueError):
        tda.delta_apply_words(w, off, w[:3])
    with pytest.raises(TypeError):
        tda.delta_apply_words(w, off.to(torch.int64), w[:4])
    with pytest.raises(ValueError):
        tda.delta_apply_words(w, off.to("meta"), w[:4].to("meta"))
    with pytest.raises(TypeError):
        tops.delta_apply(w, torch.zeros(4), w[:4])


def test_cpu_tensors_take_the_plain_versions_of_the_new_kernels(monkeypatch):
    def no_library():
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_library)
    wrappers = (tfill.fill_words, tcmp.compare_words, tdc.delta_record_words,
                tda.delta_apply_words)
    counts = [f.launches for f in wrappers]
    x = torch.arange(4096, dtype=torch.float32)
    tops.fill((1, 2), 100, device="cpu")
    tops.compare(x, x)
    off, data, _, _ = tops.delta_create(x + 1, x, cap=8)
    tops.delta_apply(x, off, data)
    tdif.dif_check(tdif.dif_insert(x.view(torch.uint32)))
    assert counts == [f.launches for f in wrappers]


def _cuda_branch(fn) -> str:
    """The source of ``fn`` after its return to the plain version."""
    src = textwrap.dedent(inspect.getsource(fn))
    return textwrap.dedent(src[src.index("_plain(") :].split("\n", 1)[1])


@pytest.mark.parametrize("fn", [tcmp.compare_words, tdc.delta_record_words,
                                tda.delta_apply_words], ids=lambda f: f.__name__)
def test_cuda_paths_read_nothing_back_to_the_host(fn):
    """A PE worker must not block its stream: the CUDA branch of compare,
    delta create and delta apply calls none of nonzero, item, tolist, int,
    bool or cpu on a tensor."""
    tree = ast.parse(_cuda_branch(fn))
    calls = {getattr(n.func, "attr", getattr(n.func, "id", None))
             for n in ast.walk(tree) if isinstance(n, ast.Call)}
    assert calls.isdisjoint({"nonzero", "item", "tolist", "int", "bool", "cpu", "numpy"})
    assert "launch" in calls
