"""The schedules of the port's delta-apply and fill kernels, on the CPU.

``delta_apply_words_schedule_plain`` runs the delta-apply kernels' schedule
step by step: the scan (``hi``, the ascending-prefix test on each adjacent
pair, the ring route's chunk bounds), then on the ring route the copy with
each chunk's entries patched in, elsewhere the copy and the scan's stores,
and the claim rule over ``[0, hi)`` when the record is not an ascending
prefix.  It is held against a serial walk of the record (the Pallas
kernel's semantics), against ``delta_apply_words_plain``, and, on records
that leave word 0 alone, against the JAX package's ``ops.delta_apply(...,
use_kernel=False)`` (its Pallas kernel does not run on the installed jax,
and its fallback undoes a change at word 0).  ``fill_words_schedule_plain``
runs the fill kernel's one-shot grid (spans, CTAs, each thread's stores,
the ragged tail) and is held against the JAX package's Pallas
``fill_words`` in interpret mode and ``fill_ref``.  Every op is integer
word work, so the tolerance is 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fill as jfill
from repro.kernels import ops as jops
from repro_torch.kernels import delta_apply as tda
from repro_torch.kernels import delta_create as tdc
from repro_torch.kernels import fill as tfill

#: chunk of the ring route in the model: small, so that a 1000-word buffer
#: spans 63 chunks (the kernel's chunk is CHUNK_WORDS = 8192 words)
CHUNK = 16
SIZES = (1000, 4099)
#: record kinds, and the path each takes: an ascending prefix of valid
#: entries (pads after it) is the fast path, anything else the general one
FAST = ("ascending prefix and pads", "cap = valid entries", "one entry at word 0",
        "one entry at word n-1", "three entries far apart", "all pads", "cap 0",
        "past the end after the entries")
GENERAL = ("duplicates", "pads first", "pads among the entries",
           "offsets past the end among the entries", "descending")
#: the kinds whose valid entries never name word 0
AWAY_FROM_WORD_0 = ("ascending prefix and pads", "cap = valid entries", "one entry at word n-1",
                    "all pads", "cap 0", "past the end after the entries", "duplicates",
                    "pads first", "pads among the entries",
                    "offsets past the end among the entries", "descending")


def words(rng, n) -> np.ndarray:
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def tt(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).view(torch.uint32)
    return torch.from_numpy(a.copy())


def as_np(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy().view(np.uint32)


def serial_apply(ref_words: np.ndarray, offsets: np.ndarray, data: np.ndarray) -> np.ndarray:
    """The Pallas kernel's semantics, one entry after another."""
    out = ref_words.copy()
    for off, word in zip(offsets.tolist(), data.tolist()):
        if 0 <= off < out.size:
            out[off] = word
    return out


def record(rng, ref_words: np.ndarray, kind: str):
    """(offsets int32, data uint32) of ``kind`` for ``ref_words``, around the
    record ``delta_record_words`` writes for k changed words away from word 0."""
    n = ref_words.size
    k = max(n // 27, 4)
    changed = ref_words.copy()
    changed[np.sort(rng.choice(np.arange(1, n), k, replace=False))] ^= np.uint32(0x10001)
    off_t, data_t, count, overflow = tdc.delta_record_words(tt(changed), tt(ref_words), 2 * k)
    assert int(count) == k and not bool(overflow)
    off, data = off_t.numpy(), as_np(data_t)
    asc, dat = off[:k], data[:k]

    def pads(m):
        return np.full(m, -1, np.int32)

    def one(at):
        return np.array([at, -1, -1, -1], np.int32), words(rng, 4)

    if kind == "ascending prefix and pads":
        return off, data
    if kind == "cap = valid entries":
        return asc, dat
    if kind == "one entry at word 0":
        return one(0)
    if kind == "one entry at word n-1":
        return one(n - 1)
    if kind == "three entries far apart":
        return np.array([0, n // 2, n - 1, -1], np.int32), words(rng, 4)
    if kind == "all pads":
        return pads(k), words(rng, k)
    if kind == "cap 0":
        return pads(0), words(rng, 0)
    if kind == "past the end after the entries":
        return np.append(asc, np.int32(n)), np.append(dat, words(rng, 1))
    if kind == "duplicates":
        dup = asc.copy()
        dup[1::5] = asc[0::5][:dup[1::5].size]
        return dup, dat
    if kind == "pads first":
        m = k // 4 + 1
        return np.concatenate([pads(m), asc]), np.concatenate([words(rng, m), dat])
    if kind == "pads among the entries":
        mixed = asc.copy()
        mixed[1::3] = -1
        return mixed, dat
    if kind == "offsets past the end among the entries":
        past = asc.copy()
        past[2::4] = n + np.arange(past[2::4].size, dtype=np.int32)
        return past, dat
    assert kind == "descending"
    return asc[::-1].copy(), dat[::-1].copy()


# --------------------------------------------------------------------------- delta apply
@pytest.mark.parametrize("ring", [True, False], ids=["ring route", "store route"])
@pytest.mark.parametrize("kind", FAST + GENERAL)
def test_delta_schedule_equals_the_serial_walk(rng, kind, ring):
    """Both routes, both paths, on every kind of record: the model of the
    kernels' schedule equals the serial walk and the plain version, and
    takes the path the scan's test predicts."""
    for n in SIZES:
        ref_words = words(rng, n)
        off, data = record(rng, ref_words, kind)
        want = serial_apply(ref_words, off, data)
        args = tt(ref_words), torch.from_numpy(off.copy()), tt(data)
        got, path, hi = tda.delta_apply_words_schedule_plain(*args, ring=ring, chunk_words=CHUNK)
        assert np.array_equal(as_np(got), want), (kind, n)
        assert np.array_equal(as_np(tda.delta_apply_words_plain(*args)), want)
        assert np.array_equal(as_np(tda.delta_apply_words(*args)), want)
        assert path == ("fast" if kind in FAST else "general"), (kind, path)
        valid = np.nonzero((off >= 0) & (off < n))[0]
        assert hi == (int(valid[-1]) + 1 if valid.size else 0)


@pytest.mark.parametrize("kind", AWAY_FROM_WORD_0)
def test_delta_apply_matches_the_reference_away_from_word_0(rng, kind):
    """Records that leave word 0 alone: the port (its plain version and the
    model of both routes) equals the JAX package's ``ops.delta_apply`` on
    its ``use_kernel=False`` path."""
    for n in SIZES:
        ref_words = words(rng, n)
        off, data = record(rng, ref_words, kind)
        assert not np.any(off == 0)
        want = np.asarray(jops.delta_apply(jnp.asarray(ref_words), jnp.asarray(off),
                                           jnp.asarray(data), use_kernel=False))
        args = tt(ref_words), torch.from_numpy(off.copy()), tt(data)
        assert np.array_equal(as_np(tda.delta_apply_words(*args)), want), (kind, n)
        for ring in (True, False):
            got = tda.delta_apply_words_schedule_plain(*args, ring=ring, chunk_words=CHUNK)[0]
            assert np.array_equal(as_np(got), want), (kind, n, ring)


@pytest.mark.parametrize("chunk", [1, 16, 1000, tda.CHUNK_WORDS])
def test_chunk_bounds_are_the_first_entry_of_each_chunk(rng, chunk):
    """On an ascending prefix the scan's bound of chunk c, where a pair
    wrote it, is the first entry at or past the chunk's first word; every
    chunk between the first and the last entry's has one."""
    n = 4099
    ref_words = words(rng, n)
    off, _ = record(rng, ref_words, "ascending prefix and pads")
    hi, prefix, first = tda.delta_scan_plain(torch.from_numpy(off), n, chunk)
    assert prefix and hi == (off >= 0).sum()
    live = off[:hi]
    c_first, c_last = live[0] // chunk, live[-1] // chunk
    for c in range(first.numel()):
        if c_first < c <= c_last:
            assert int(first[c]) == np.searchsorted(live, c * chunk), c
        else:
            assert int(first[c]) == -1, c


def test_the_scan_tests_each_adjacent_pair():
    """One entry out of place is enough for the general path; pads and
    offsets past the end after the entries are not."""
    n = 100
    cases = {(5, 7, 9, -1, -1): True, (5, 7, 9, 100, -1): True, (5, 7, 9, -1, 11): False,
             (5, 7, 7, -1, -1): False, (5, 9, 7, -1, -1): False, (-1, 5, 7, 9, -1): False,
             (5, 100, 7, -1, -1): False, (99,): True, (-1, -1): True}
    for off, prefix in cases.items():
        hi, got, _ = tda.delta_scan_plain(torch.tensor(off, dtype=torch.int32), n, 4)
        assert got == prefix, off
        valid = [i for i, o in enumerate(off) if 0 <= o < n]
        assert hi == (valid[-1] + 1 if valid else 0), off


# --------------------------------------------------------------------------- fill
CTA = tfill.FILL_THREADS * tfill.FILL_PER_THREAD
#: word counts either side of one, two and four CTAs of uint4s (and of
#: words, for an unaligned output), and ragged ones
FILL_SIZES = (1, 3, 5, CTA - 1, CTA + 1, 4 * CTA - 1, 4 * CTA, 4 * CTA + 1, 8 * CTA + 3,
              16 * CTA + 2)


@pytest.mark.parametrize("n_pe", [1, 2, 3, 4])
@pytest.mark.parametrize("pattern", [(0xDEADBEEF,), (1, 0x80000001), (7, 8, 0xFFFFFFFF, 0)],
                         ids=["1 word", "2 words", "4 words"])
def test_fill_schedule_matches_the_reference(pattern, n_pe):
    """The model of the one-shot grid writes every word once, and the words
    are the JAX package's Pallas ``fill_words`` (interpret mode) and
    ``fill_ref``, for aligned and unaligned outputs."""
    pat = jnp.asarray(pattern, jnp.uint32)
    for n in FILL_SIZES:
        block_rows = 8
        rows = -(-n // jfill.LANES)
        rows = -(-rows // (block_rows * n_pe)) * (block_rows * n_pe)
        want = np.asarray(jfill.fill_words(rows, pat, block_rows=block_rows, n_pe=n_pe,
                                           interpret=True)).reshape(-1)[:n]
        assert np.array_equal(as_np(tfill.fill_words_plain(n, pattern)), want)
        for aligned in (True, False):
            got, writes = tfill.fill_words_schedule_plain(n, pattern, n_pe=n_pe,
                                                          aligned=aligned)
            assert np.array_equal(as_np(got), want), (n, aligned)
            assert bool((writes == 1).all()), (n, aligned)


@pytest.mark.parametrize("n_words,n_pe", [(1, 1), (4 * CTA, 1), (4 * CTA + 1, 1),
                                          (4 * CTA, 3), (10**6 + 3, 4), (7, 4)])
def test_fill_launch_covers_each_span(n_words, n_pe):
    """Spans start on multiples of 4 words and the grid's CTAs cover the
    longest span: uint4s of an aligned output, words of an unaligned one."""
    for aligned in (True, False):
        span, grid_x = tfill.fill_launch(n_words, n_pe, aligned)
        assert span % 4 == 0 and span * n_pe >= n_words > span * (n_pe - 1) - 4 * n_pe
        items = span // 4 if aligned else span
        assert (grid_x - 1) * CTA < max(items, 1) <= grid_x * CTA


@pytest.mark.parametrize("start", [0, 1, 2, 3])
def test_fill_words_into_fills_a_view_in_place(start):
    """An output 0-3 words off 16 bytes: the pattern runs from the view's
    own word 0, and nothing outside the view changes."""
    base = torch.zeros(4 * CTA + 8, dtype=torch.uint32)
    n = 4 * CTA + 1
    view = base[start:start + n]
    assert tfill.fill_words_into(view, (1, 2, 3, 4), n_pe=3) is view
    assert torch.equal(view.view(torch.int32),
                       tfill.fill_words_plain(n, (1, 2, 3, 4)).view(torch.int32))
    assert not bool(base[:start].view(torch.int32).any())
    assert not bool(base[start + n:].view(torch.int32).any())
