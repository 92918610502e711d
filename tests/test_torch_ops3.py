"""The port's third slice of kernels (compare-pattern, dualcast and
fill-verify) and the whole op table of its engine against the JAX package's.

Every op is integer word work, so the tolerance is 0: the same inputs, made
with numpy from a seed, go through ``repro`` (its Pallas kernels in
interpret mode on the JAX CPU backend) and through ``repro_torch`` (the
plain PyTorch versions, which CPU tensors take), and the bytes must be
identical.  The JAX package pads the word view to 128 lanes and masks the
padding; the port has no padding, so word counts that are not multiples of
128 show that only real words count on both sides."""
import functools
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as J
import repro.core.engine as jengine
import repro_torch.core as T
from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import compare as tcmp
from repro_torch.kernels import dualcast as tdual
from repro_torch.kernels import fused as tfused
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = ["float32", "bfloat16", "uint32"]
PATTERNS = [(0xDEADBEEF,), (1, 0x80000001), (7, 8, 0xFFFFFFFF, 0)]
#: word counts that are (128, 4096) and are not multiples of 128
N_WORDS = [1, 5, 127, 128, 129, 1000, 4096]


def make_words(rng, shape, dtype, pattern=None):
    """A (jax array, torch tensor) pair of ``dtype`` and ``shape`` with the
    same bits: random, or the pattern's words repeated over it."""
    itemsize = 2 if dtype == "bfloat16" else 4
    n_words = int(np.prod(shape)) * itemsize // 4
    if pattern is None:
        words = rng.integers(0, 2**32, n_words, dtype=np.uint64).astype(np.uint32)
    else:
        words = np.tile(np.asarray(pattern, np.uint32), -(-n_words // len(pattern)))[:n_words]
    return pair(words, shape, dtype)


def pair(words: np.ndarray, shape, dtype):
    if dtype == "uint32":
        return (jnp.asarray(words.reshape(shape)),
                torch.from_numpy(words.view(np.int32).reshape(shape).copy()).view(torch.uint32))
    if dtype == "float32":
        a = words.view(np.float32).reshape(shape)
        return jnp.asarray(a), torch.from_numpy(a.copy())
    bits = words.view(np.uint16).reshape(shape)
    return (jnp.asarray(bits).view(jnp.bfloat16),
            torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16))


def as_bytes(x):
    if isinstance(x, torch.Tensor):
        return (str(x.dtype).split(".")[-1], tuple(x.shape),
                x.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    a = np.asarray(x)
    return str(a.dtype), tuple(a.shape), a.tobytes()


def flat(x):
    """Every array of a (nested) result as (dtype name, shape, bytes)."""
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in flat(v)]
    return [as_bytes(x)]


def shape_of(dtype, n_words):
    return (2 * n_words,) if dtype == "bfloat16" else (n_words,)


def plant(words_t: torch.Tensor, positions) -> torch.Tensor:
    """A copy of a word view with the words at ``positions`` flipped."""
    out = words_t.clone()
    w = out.reshape(-1).view(torch.int32)
    for p in positions:
        w[p] ^= 0x00010001
    return out


# --------------------------------------------------------------------------- compare_pattern
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_words", N_WORDS)
@pytest.mark.parametrize("pattern", PATTERNS, ids=["p1", "p2", "p4"])
@pytest.mark.parametrize("where", ["none", "first", "last", "every"])
def test_compare_pattern_matches_reference(rng, dtype, n_words, pattern, where):
    shape = shape_of(dtype, n_words)
    j, t = make_words(rng, shape, dtype, pattern)
    pos = {"none": [], "first": [0], "last": [n_words - 1],
           "every": range(n_words)}[where]
    t = plant(t, pos)
    j = pair(t.reshape(-1).view(torch.int32).numpy().view(np.uint32).copy(), shape, dtype)[0]
    want = jops.compare_pattern(j, jnp.asarray(pattern, jnp.uint32), interpret=True)
    got = tops.compare_pattern(t, pattern)
    assert flat(got) == flat(want)
    assert bool(got[0]) == (where == "none")
    assert int(got[1]) == (-1 if where == "none" else min(pos))


@settings(max_examples=25, deadline=None)
@given(n_words=st.integers(1, 700), p=st.sampled_from([1, 2, 4]),
       data=st.data())
def test_compare_pattern_with_drawn_mismatches(n_words, p, data):
    """Mismatches at drawn positions (possibly none): the first one, from
    both packages."""
    pattern = data.draw(st.lists(st.integers(0, 2**32 - 1), min_size=p, max_size=p))
    pos = data.draw(st.lists(st.integers(0, n_words - 1), max_size=6, unique=True))
    words = np.tile(np.asarray(pattern, np.uint32), -(-n_words // p))[:n_words]
    words[pos] ^= np.uint32(0x80000001)
    j, t = pair(words, (n_words,), "uint32")
    want = jops.compare_pattern(j, jnp.asarray(pattern, jnp.uint32), interpret=True)
    got = tops.compare_pattern(t, pattern)
    assert flat(got) == flat(want)
    assert int(got[1]) == (min(pos) if pos else -1)


def test_compare_pattern_counts_no_padding():
    """129 words of the pattern: the reference pads to 256 and masks words
    129..255 (which differ from the pattern); the port has no such words."""
    pattern = (5, 6, 7, 8)
    words = np.tile(np.asarray(pattern, np.uint32), 33)[:129]
    j, t = pair(words, (129,), "uint32")
    padded, n, _, _ = jops.to_words(j)
    assert padded.size == 256 and n == 129 and not (np.asarray(padded).reshape(-1)[129:] == 8).all()
    assert flat(tops.compare_pattern(t, pattern)) == flat(
        jops.compare_pattern(j, jnp.asarray(pattern, jnp.uint32), interpret=True))
    assert bool(tops.compare_pattern(t, pattern)[0])


# --------------------------------------------------------------------------- dualcast
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1,), (127,), (129,), (3, 130), (8, 128)])
def test_dualcast_matches_reference(rng, dtype, shape):
    if dtype == "bfloat16":
        shape = shape[:-1] + (2 * shape[-1],)
    j, t = make_words(rng, shape, dtype)
    want = jops.dualcast(j, interpret=True)
    got = tops.dualcast(t)
    assert flat(got) == flat(want)
    a, b = got
    assert a.data_ptr() != b.data_ptr() != t.data_ptr()


# --------------------------------------------------------------------------- fill_verify
@pytest.mark.parametrize("n_words", N_WORDS)
@pytest.mark.parametrize("pattern", PATTERNS, ids=["p1", "p2", "p4"])
def test_fill_verify_matches_reference(n_words, pattern):
    want = jops.fill_verify(jnp.asarray(pattern, jnp.uint32), n_words, interpret=True)
    got = tops.fill_verify(pattern, n_words, device="cpu")
    assert flat(got) == flat(want)
    filled, (ok, first) = got
    assert bool(ok) and int(first) == -1
    # its parts: the fill and the compare of the filled buffer
    assert flat(filled) == flat(tops.fill(pattern, n_words, device="cpu"))
    assert flat((ok, first)) == flat(tops.compare_pattern(filled, pattern))


def test_fill_verify_plain_version_reports_a_bad_readback(monkeypatch):
    """The verify half really reads the buffer: a fill that lands a wrong
    word is reported at that word."""
    real = tfused.fill_words_plain

    def faulty(n_words, pattern, device="cpu"):
        out = real(n_words, pattern, device=device)
        out.view(torch.int32)[37] ^= 1
        return out

    monkeypatch.setattr(tfused, "fill_words_plain", faulty)
    _, (ok, first) = tops.fill_verify((1, 2), 100, device="cpu")
    assert not bool(ok) and int(first) == 37


# --------------------------------------------------------------------------- wrappers
def test_slice3_wrappers_check_their_operands():
    w = torch.zeros(64, dtype=torch.uint32)
    with pytest.raises(ValueError, match="1, 2 or 4"):
        tcmp.compare_pattern_words(w, (1, 2, 3))
    with pytest.raises(TypeError):
        tcmp.compare_pattern_words(w.view(torch.int32), (1,))
    with pytest.raises(TypeError):
        tdual.dualcast_words(w.view(torch.float32))
    with pytest.raises(ValueError):
        tdual.dualcast_words(w.view(8, 8))
    with pytest.raises(ValueError):
        tfused.fill_verify_words(-1, (1,), device="cpu")
    with pytest.raises(ValueError):
        tfused.fill_verify_words(8, (1,), device="meta")
    with pytest.raises(ValueError, match="1, 2 or 4"):
        tfused.fill_verify_words(8, (), device="cpu")


def test_cpu_tensors_take_the_plain_versions_of_the_slice3_kernels(monkeypatch):
    def no_library():
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_library)
    wrappers = (tcmp.compare_pattern_words, tdual.dualcast_words, tfused.fill_verify_words)
    counts = [f.launches for f in wrappers]
    x = torch.arange(1000, dtype=torch.float32)
    tops.compare_pattern(x, (1, 2))
    tops.dualcast(x)
    tops.fill_verify((3,), 1000, device="cpu")
    assert counts == [f.launches for f in wrappers]


CU = (_build.CSRC / "dsa_kernels.cu").read_text()


def test_c_entry_points_match_their_ctypes_signatures():
    """Each ``extern "C"`` entry of the CUDA source has a ctypes signature
    with as many arguments (the card is the only place a mismatch would
    show otherwise)."""
    entries = dict(re.findall(r"^int (dsa_\w+)\(([^)]*)\)", CU, flags=re.M))
    assert set(entries) == set(_build._SIGNATURES)
    for name, args in entries.items():
        assert len(args.split(",")) == len(_build._SIGNATURES[name]), name


def _kernel_body(name: str) -> str:
    start = CU.index(f"__global__ void {name}(")
    return CU[start:CU.index("\n}\n", start)]


def test_fill_verify_reads_back_through_a_volatile_load():
    """The readback may not be forwarded from the register that was stored:
    it goes through the inline-PTX ld.volatile.global helper, and the three
    first-mismatch kernels share one reduction."""
    body = _kernel_body("fill_verify_kernel")
    assert body.count("load_volatile(") == 2
    assert "ld.volatile.global.v4.u32" in CU and '"memory"' in CU
    for k in ("compare_words_kernel", "compare_pattern_kernel", "fill_verify_kernel"):
        b = _kernel_body(k)
        assert "finish_first_diff(mine, state, equal, first);" in b
        assert "__reduce_min_sync" not in b and "atomicMin" not in b


# --------------------------------------------------------------------------- the engine's op table
#: every op of the JAX engine's ``_execute_one``
ENGINE_OPS = ["memcpy", "dualcast", "fill", "compare", "compare_pattern", "crc32",
              "delta_create", "delta_apply", "dif_insert", "dif_check", "dif_strip",
              "batch_copy", "copy_crc", "fill_verify", "cache_flush"]


def test_engine_op_list_is_the_reference_table():
    src = inspect.getsource(jengine.StreamEngine._execute_one)
    ops = set(re.findall(r"d\.op == OpType\.(\w+)", src))
    assert {o.lower() for o in ops} == set(ENGINE_OPS)


def _operands(c, A, op: str) -> dict:
    rng = np.random.default_rng(7)
    x = rng.normal(size=(20, 33)).astype(np.float32)  # 660 words
    words = rng.integers(0, 2**32, 512, dtype=np.uint64).astype(np.uint32)
    changed = words.copy()
    changed[[3, 200, 511]] ^= np.uint32(0x1001)
    framed = tref.dif_insert_ref(torch.from_numpy(words.view(np.int32)).view(torch.uint32))
    framed_np = framed.view(torch.int32).numpy().view(np.uint32).copy()
    framed_np[1, 5] ^= np.uint32(1)  # one corrupted block for dif_check
    pat = np.asarray([9, 0xF0000001], np.uint32)
    pat_words = np.tile(pat, 330)
    pat_words[301] += np.uint32(1)
    offs = np.asarray([3, 200, 511, -1], np.int32)
    return {
        "memcpy": dict(src=A(x)),
        "dualcast": dict(src=A(x)),
        "fill": dict(pattern=A(pat), n_words=333),
        "compare": dict(src=A(words), src2=A(changed)),
        "compare_pattern": dict(src=A(pat_words), pattern=A(pat)),
        "crc32": dict(src=A(x)),
        "delta_create": dict(src=A(changed), src2=A(words), cap=8),
        "delta_apply": dict(src=A(words), src_idx=A(offs),
                            src2=A(np.append(changed[offs[:3]], np.uint32(0)))),
        "dif_insert": dict(src=A(words)),
        "dif_check": dict(src=A(framed_np)),
        "dif_strip": dict(src=A(framed_np)),
        "batch_copy": dict(src=A(x.reshape(4, 5, 33)), dst_pool=A(np.zeros((3, 5, 33), np.float32)),
                           src_idx=A(np.asarray([0, 3, 1], np.int32)),
                           dst_idx=A(np.asarray([2, 0, 2], np.int32))),
        "copy_crc": dict(src=A(x)),
        "fill_verify": dict(pattern=A(pat[:1]), n_words=300),
        "cache_flush": dict(src=A(words)),
    }[op]


def _tt(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).view(torch.uint32)
    return torch.from_numpy(a.copy())


def _run_op(c, A, op: str, **kw):
    device = c.make_device(n_instances=2, policy="round_robin", validate="strict", **kw)
    fut = device.submit(c.WorkDescriptor(op=c.OpType(op), **_operands(c, A, op)))
    out = fut.result()
    device.drain()
    return fut, out, device


@pytest.mark.parametrize("op", ENGINE_OPS)
def test_every_engine_op_matches_reference(op, monkeypatch):
    """Each op of the engine's table resolves SUCCESS on the port's CPU
    device with the reference's results, byte counts and modeled time.  The
    reference's delta_apply runs its use_kernel=False path (its Pallas kernel
    cannot run on the installed jax); the record leaves word 0 alone, where
    that path is exact."""
    monkeypatch.setattr(jops, "delta_apply", functools.partial(jops.delta_apply,
                                                               use_kernel=False))
    jf, jout, _ = _run_op(J, jnp.asarray, op)
    tf, tout, dev = _run_op(T, _tt, op, device="cpu")
    assert jf.status == J.Status.SUCCESS, jf.error
    assert tf.status == T.Status.SUCCESS, tf.error
    assert flat(tout) == flat(jout)
    assert tf.record.bytes_processed == jf.record.bytes_processed
    assert tf.op == jf.op == op
    assert dev.policy_stats["desclint_warnings"] == 0


@pytest.mark.parametrize("op,read_factor", [("dualcast", 1.5), ("compare_pattern", 0.5),
                                            ("fill_verify", 0.5)])
def test_slice3_ops_charge_the_reference_read_factors(op, read_factor):
    """The modeled time of each new op is the port's model at the
    reference's read factor for that op."""
    fut, _, dev = _run_op(T, _tt, op, device="cpu")
    eng = dev.engines[0]
    want = eng.model.op_time(fut.record.bytes_processed,
                             **eng._model_kw({"read_factor": read_factor}, "hbm", 0))
    assert fut.record.modeled_time_us == pytest.approx(want * 1e6, rel=1e-12)
