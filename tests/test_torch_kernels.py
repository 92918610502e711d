"""The port's kernel layer (repro_torch.kernels) against the JAX package's.

Every op is integer word work, so the tolerance is 0: the same inputs, made
with numpy from a seed, go through ``repro.kernels`` (its Pallas kernels in
interpret mode on the JAX CPU backend) and through ``repro_torch.kernels``
(the plain PyTorch versions, which CPU tensors take), and the bytes must be
identical."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import crc32 as jcrc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import batch_copy as tbc
from repro_torch.kernels import crc32 as tcrc
from repro_torch.kernels import fused as tfused
from repro_torch.kernels import memcpy as tmc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = ["float32", "bfloat16", "int32", "int8", "uint32"]
SHAPES = [(128,), (8, 128), (1000,), (64, 130), (3, 5, 7, 4)]
_BITS = {"float32": np.uint32, "int32": np.uint32, "uint32": np.uint32,
         "bfloat16": np.uint16, "int8": np.uint8}


def make(rng, shape, dtype):
    """The same values as a (jax array, torch tensor) pair.  Floats are
    finite; every other pattern of bits is drawn as is."""
    if dtype == "float32":
        a = (rng.normal(size=shape) * 3).astype(np.float32)
        return jnp.asarray(a), torch.from_numpy(a.copy())
    if dtype == "bfloat16":
        f = (rng.normal(size=shape) * 3).astype(np.float32)
        bits = (f.view(np.uint32) >> 16).astype(np.uint16)  # truncate to bf16
        return (jnp.asarray(bits).view(jnp.bfloat16),
                torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16))
    bits = rng.integers(0, 2 ** (8 * np.dtype(_BITS[dtype]).itemsize), size=shape,
                        dtype=np.uint64).astype(_BITS[dtype])
    j = jnp.asarray(bits).view(getattr(jnp, dtype))
    signed = bits.view({np.uint32: np.int32, np.uint8: np.int8}[_BITS[dtype]])
    t = torch.from_numpy(signed.copy())
    return j, (t.view(torch.uint32) if dtype == "uint32" else t)


def tbytes(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def jbytes(a) -> bytes:
    return np.asarray(a).tobytes()


def same(t: torch.Tensor, a) -> bool:
    return (tuple(t.shape) == tuple(a.shape)
            and str(t.dtype).split(".")[-1] == str(a.dtype)
            and tbytes(t) == jbytes(a))


# --------------------------------------------------------------------------- memcpy
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_memcpy_matches_reference(rng, shape, dtype):
    a, t = make(rng, shape, dtype)
    for n_pe in (1, 4):
        want = jops.memcpy(a, n_pe=n_pe)
        got = tops.memcpy(t, n_pe=n_pe)
        assert same(got, want) and same(tref.memcpy_ref(t), want)
        assert got.data_ptr() != t.data_ptr()


# --------------------------------------------------------------------------- crc32
# 257 and 509 are primes above 256: one chain (C = 1), as in the JAX package
@pytest.mark.parametrize("n", [1, 2, 3, 17, 64, 257, 509, 1000, 4096, 65536])
def test_crc32_matches_reference_and_zlib(rng, n):
    a, t = make(rng, (n,), "uint32")
    want = zlib.crc32(jbytes(a)) & 0xFFFFFFFF
    got = tops.crc32(t)
    assert got.dtype == torch.uint32 and got.dim() == 0
    assert int(got) == int(jops.crc32(a)) == want == tref.crc32_ref(t)


@pytest.mark.parametrize("dtype,shape", [("float32", (123, 4)), ("bfloat16", (33, 10)),
                                         ("int8", (4099, 4)), ("int32", (7, 3))])
def test_crc32_over_dtypes(rng, dtype, shape):
    a, t = make(rng, shape, dtype)
    assert int(tops.crc32(t)) == int(jops.crc32(a)) == zlib.crc32(tbytes(t)) & 0xFFFFFFFF


@pytest.mark.parametrize("C,W", [(1, 7), (4, 100), (256, 3), (8, 512)])
def test_crc_chunk_states_match_reference(rng, C, W):
    a, t = make(rng, (C, W), "uint32")
    want = jcrc.crc32_chunk_states(a, jnp.asarray(jref.make_crc_tables(4)), interpret=True)
    got = tcrc.crc32_chunk_states(t, tops._tables(t.device))
    assert same(got, want)


@pytest.mark.parametrize("C,chunk_bytes", [(2, 4), (16, 4096), (256, 40)])
def test_combine_chunk_crcs_matches_reference(rng, C, chunk_bytes):
    sa, st_ = make(rng, (C,), "uint32")
    mat = jref.crc32_shift_matrix(chunk_bytes)
    want = jcrc.combine_chunk_crcs(sa, jnp.asarray(mat))
    got = tcrc.combine_chunk_crcs(st_, tops._shift_mat(chunk_bytes, torch.device("cpu")))
    assert got.dim() == 0 and int(got) == int(want)
    vec = int(np.asarray(sa)[0])
    assert int(tcrc.gf2_apply(tcrc.u32_to_i64(torch.from_numpy(mat.view(np.int32))),
                              torch.tensor(vec))) == int(jcrc.gf2_apply(jnp.asarray(mat),
                                                                        jnp.uint32(vec)))


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 2**32 - 1), min_size=1, max_size=600))
def test_crc32_matches_zlib_property(ws):
    x = np.asarray(ws, np.uint32)
    t = torch.from_numpy(x.view(np.int32)).view(torch.uint32)
    assert int(tops.crc32(t)) == zlib.crc32(x.astype("<u4").tobytes()) & 0xFFFFFFFF


# --------------------------------------------------------------------------- copy + crc
@pytest.mark.parametrize("dtype,shape", [("float32", (64, 130)), ("bfloat16", (1000,)),
                                         ("int8", (257, 4)), ("uint32", (4096,))])
def test_copy_crc_matches_reference(rng, dtype, shape):
    a, t = make(rng, shape, dtype)
    want_copy, want_crc = jops.copy_crc(a)
    got_copy, got_crc = tops.copy_crc(t)
    assert same(got_copy, want_copy) and got_copy.data_ptr() != t.data_ptr()
    assert int(got_crc) == int(want_crc) == zlib.crc32(tbytes(t)) & 0xFFFFFFFF


def test_copy_crc_words_matches_reference(rng):
    a, t = make(rng, (16, 64), "uint32")
    tabs = jnp.asarray(jref.make_crc_tables(4))
    from repro.kernels import fused as jfused

    want_states, want_dst = jfused.copy_crc_words(a, tabs, interpret=True)
    got_states, got_dst = tfused.copy_crc_words(t, tops._tables(t.device))
    assert same(got_states, want_states) and same(got_dst, want_dst)


# --------------------------------------------------------------------------- batch copy
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "uint32"])
def test_batch_copy_matches_reference(rng, dtype):
    src_a, src_t = make(rng, (12, 8, 128), dtype)
    dst_a, dst_t = make(rng, (10, 8, 128), dtype)
    si = np.asarray([0, 3, 3, 11, 5, 7], np.int32)
    di = np.asarray([5, 2, 7, 0, 5, 2], np.int32)  # duplicates: last writer wins
    want = jops.batch_copy(src_a, jnp.array(dst_a), jnp.asarray(si), jnp.asarray(di))
    before = dst_t.clone()
    got = tops.batch_copy(src_t, dst_t, torch.from_numpy(si), torch.from_numpy(di))
    assert got is dst_t  # written in place: the counterpart of donation
    assert same(got, want)
    untouched = sorted(set(range(10)) - set(di.tolist()))
    assert tbytes(got[untouched]) == tbytes(before[untouched])


def test_batch_copy_between_views_of_one_pool(rng):
    """Pools that share storage: every read sees the pool as it was before
    the call, as the JAX package's functional copy does."""
    a, t = make(rng, (8, 4, 32), "float32")
    si = np.asarray([0, 1, 2], np.int32)
    di = np.asarray([1, 2, 3], np.int32)
    want = jops.batch_copy(a, jnp.array(a), jnp.asarray(si), jnp.asarray(di))
    got = tops.batch_copy(t, t, torch.from_numpy(si), torch.from_numpy(di))
    assert same(got, want)


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 12), st.data())
def test_batch_copy_with_duplicates_equals_sequential(n_desc, data):
    rng = np.random.default_rng(data.draw(st.integers(0, 1000)))
    P = 8
    src = rng.normal(size=(P, 8, 128)).astype(np.float32)
    dst = rng.normal(size=(P, 8, 128)).astype(np.float32)
    si = rng.integers(0, P, n_desc).astype(np.int32)
    di = rng.integers(0, P, n_desc).astype(np.int32)
    want = jref.batch_copy_ref(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(si),
                               jnp.asarray(di))
    src_t, dst_t = torch.from_numpy(src), torch.from_numpy(dst.copy())
    si_t, di_t = torch.from_numpy(si), torch.from_numpy(di)
    assert same(tref.batch_copy_ref(src_t, dst_t, si_t, di_t), want)
    assert same(tops.batch_copy(src_t, dst_t, si_t, di_t), want)


def test_batch_copy_rejects_bad_input(rng):
    _, src = make(rng, (4, 16), "float32")
    _, dst = make(rng, (4, 16), "float32")
    with pytest.raises(IndexError):
        tops.batch_copy(src, dst, torch.tensor([0]), torch.tensor([4]))
    with pytest.raises(IndexError):
        tops.batch_copy(src, dst, torch.tensor([-1]), torch.tensor([0]))
    with pytest.raises(ValueError):
        tops.batch_copy(src, dst.to(torch.int32), torch.tensor([0]), torch.tensor([0]))
    with pytest.raises(ValueError):
        tops.batch_copy(src, dst.t(), torch.tensor([0]), torch.tensor([0]))


# --------------------------------------------------------------------------- word view, choices, caches
@pytest.mark.parametrize("dtype,shape", [("float32", (3, 130)), ("bfloat16", (6,)),
                                         ("int8", (1000,)), ("uint32", (128,))])
@pytest.mark.parametrize("row_multiple", [1, 4])
def test_word_view_matches_reference(rng, dtype, shape, row_multiple):
    a, t = make(rng, shape, dtype)
    jw, jn, jshape, _ = jops.to_words(a, row_multiple=row_multiple)
    tw, tn, tshape, tdtype = tops.to_words(t, row_multiple=row_multiple)
    assert same(tw, jw) and tn == jn and tshape == tuple(jshape)
    assert tbytes(tops.from_words(tw, tn, tshape, tdtype)) == tbytes(t)


def test_ops_take_views_that_start_inside_a_word(rng):
    a, t = make(rng, (1001,), "bfloat16")
    view, want = t[1:], a[1:]  # starts 2 bytes into a word of its storage
    assert same(tops.memcpy(view), jops.memcpy(want))
    assert int(tops.crc32(view)) == int(jops.crc32(want)) == tref.crc32_ref(view)
    got_copy, got_crc = tops.copy_crc(view)
    assert same(got_copy, want) and int(got_crc) == tref.crc32_ref(view)


def test_word_view_rejects_ragged_bytes():
    with pytest.raises(ValueError):
        tops.to_words(torch.zeros(3, dtype=torch.int8))


def test_block_and_chunk_choices_match_reference():
    for rows in range(1, 300):
        for n_pe in (1, 2, 3, 4):
            assert tops._pick_block_rows(rows, n_pe) == jops._pick_block_rows(rows, n_pe)
    for n in list(range(1, 600)) + [4099, 65536, 1 << 28]:
        assert tops._pick_chunks(n) == jops._pick_chunks(n)


def test_crc_tables_and_shift_matrices_match_reference():
    np.testing.assert_array_equal(tref.make_crc_tables(4), jref.make_crc_tables(4))
    for n in (0, 1, 4, 12, 1000, 4096):
        np.testing.assert_array_equal(tref.crc32_shift_matrix(n), jref.crc32_shift_matrix(n))
    a, b = b"repro", b"torch port"
    assert tref.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) == zlib.crc32(a + b)


def test_shift_cache_is_a_bounded_lru(monkeypatch):
    monkeypatch.setattr(tops, "_SHIFT_CACHE", type(tops._SHIFT_CACHE)())
    monkeypatch.setattr(tops, "_SHIFT_CACHE_MAX", 3)
    cpu = torch.device("cpu")
    for n in (4, 8, 12):
        tops._shift_mat(n, cpu)
    tops._shift_mat(4, cpu)  # refresh: 8 is now the oldest
    tops._shift_mat(16, cpu)
    assert [k for k, _ in tops._SHIFT_CACHE] == [12, 4, 16]
    np.testing.assert_array_equal(
        tops._shift_mat(16, cpu).view(torch.int32).numpy().view(np.uint32),
        jref.crc32_shift_matrix(16))


# --------------------------------------------------------------------------- wrappers
def test_wrappers_check_their_operands():
    w = torch.zeros(64, dtype=torch.uint32)
    tabs = tops._tables(torch.device("cpu"))
    with pytest.raises(TypeError):
        tmc.memcpy_words(torch.zeros(64, dtype=torch.int32))
    with pytest.raises(ValueError):
        tmc.memcpy_words(w.view(8, 8))
    with pytest.raises(ValueError):
        tmc.memcpy_words(w.view(8, 8).t().reshape(-1)[::2])
    with pytest.raises(ValueError):
        tmc.memcpy_words(w, n_pe=0)
    with pytest.raises(ValueError):
        tcrc.crc32_chunk_states(w.view(8, 8), tabs[:2])
    with pytest.raises(ValueError):
        tcrc.combine_chunk_crcs(w[:4], w[:31])
    with pytest.raises(ValueError):
        tbc.batch_copy_pages(w.view(8, 8), w.view(4, 16), torch.zeros(1, dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        tbc.batch_copy_pages(w.view(8, 8), w.view(8, 8).clone(),
                             torch.zeros(2, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        tfused.copy_crc_words(w.view(8, 8), tabs.to("meta"))


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """A CPU tensor never reaches the CUDA library and counts no launch."""
    def no_library():
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_library)
    counts = [f.launches for f in (tmc.memcpy_words, tbc.batch_copy_pages,
                                   tcrc.crc32_chunk_states, tcrc.combine_chunk_crcs,
                                   tfused.copy_crc_words)]
    x = torch.arange(4096, dtype=torch.float32)
    tops.memcpy(x)
    tops.crc32(x)
    tops.copy_crc(x)
    tops.batch_copy(x.view(16, 256), torch.zeros(16, 256), torch.tensor([1]), torch.tensor([2]))
    assert counts == [f.launches for f in (tmc.memcpy_words, tbc.batch_copy_pages,
                                           tcrc.crc32_chunk_states, tcrc.combine_chunk_crcs,
                                           tfused.copy_crc_words)]


def test_library_is_keyed_by_source_and_flags(monkeypatch):
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert _build.library_path() == path
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path() != path


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", _build.BUILD_DIR / "no-such-nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()
