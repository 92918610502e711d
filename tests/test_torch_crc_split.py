"""The CRC pair's split into sub-chunks and its warp-tree fold, on the CPU.

``crc32_chunk_states_split_plain`` runs the CUDA kernels' split (a short
first sub-chunk, then whole ``SUB_WORDS`` units) and ``fold_crcs_plain``
runs ``crc_fold_kernel``'s schedule step by step (powers by squaring, 32
lane ranges, serial folds, a 5-level tree with counts).  Both are held bit
for bit against ``zlib.crc32`` of each chunk and against the JAX package's
``crc32_chunk_states`` (its Pallas kernel in interpret mode) and
``combine_chunk_crcs``.  The tolerance is 0: CRCs are integers."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import crc32 as jcrc
from repro.kernels import ref as jref
from repro_torch.kernels import crc32 as tcrc
from repro_torch.kernels import ops as tops

L = tcrc.SUB_WORDS
CPU = torch.device("cpu")
#: chunk lengths in words: either side of one unit, of 32 units (one a lane),
#: a ragged first sub-chunk, and 10243, a prime above 40 units
WIDTHS = [1, L - 1, L, L + 1, 2 * L + 1, 31 * L, 32 * L, 32 * L + 1, 33 * L + 5, 10243]
#: (C, W) cases: 1 and 3 chunks at every width, 256 where the size stays small
CASES = ([(C, W) for C in (1, 3) for W in WIDTHS]
         + [(256, W) for W in (1, L - 1, L, L + 1, 2 * L + 1, 32 * L + 1)])


def words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)


def as_torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy()).view(torch.uint32)


def as_ints(t: torch.Tensor) -> list:
    return [int(v) for v in t.reshape(-1).view(torch.int32).numpy().view(np.uint32)]


def zcrc(a: np.ndarray) -> int:
    return zlib.crc32(a.astype("<u4").tobytes()) & 0xFFFFFFFF


def mat(nbytes: int) -> torch.Tensor:
    return tops._shift_mat(nbytes, CPU)


def test_subchunk_plan_leaves_only_the_first_short():
    for W in [*range(0, 4 * L + 2), 31 * L, 32 * L, 32 * L + 1, 33 * L + 5, 10243, 1 << 20]:
        S, h = tcrc.subchunk_plan(W)
        assert S >= 1
        if W <= L:
            assert (S, h) == (1, W), W
            continue
        assert 1 <= h <= L, (W, h)
        # sub-chunk k >= 1 is words [h + (k-1) L, h + k L): each whole, and
        # together with [0, h) they cover the chunk exactly
        bounds = [(0, h)] + [(h + (k - 1) * L, h + k * L) for k in range(1, S)]
        assert all(hi - lo == L for lo, hi in bounds[1:]), W
        assert bounds[-1][1] == W, W


@pytest.mark.parametrize("S", [*range(1, 70), 4096])
def test_lane_ranges_cover_the_units_left_to_right(S):
    starts, counts = tcrc.lane_ranges(S)
    assert len(starts) == len(counts) == tcrc.FOLD_LANES
    assert counts[0] >= 1 and starts[0] == 0
    assert sum(counts) == S
    assert max(counts) - min(counts) <= 1
    assert all(starts[j + 1] == starts[j] + counts[j] for j in range(tcrc.FOLD_LANES - 1))
    # an empty range lies right of every unit
    assert all(counts[j] or all(c == 0 for c in counts[j:]) for j in range(tcrc.FOLD_LANES))


@pytest.mark.parametrize("C,W", CASES)
def test_split_chunk_states_match_zlib_and_reference(rng, C, W):
    a = words(rng, C, W)
    got = as_ints(tcrc.crc32_chunk_states_split_plain(as_torch(a), tops._tables(CPU)))
    assert got == [zcrc(a[c]) for c in range(C)]
    want = jcrc.crc32_chunk_states(jnp.asarray(a), jnp.asarray(jref.make_crc_tables(4)),
                                   words_per_step=W, interpret=True)
    assert got == [int(v) for v in np.asarray(want)]
    # and the chunk states fold into the buffer's CRC through the fold's schedule
    states = as_torch(np.asarray(got, dtype=np.uint32))
    folded = tcrc.fold_crcs_plain(states, mat(4 * W), 1, C)
    assert as_ints(folded) == [zcrc(a.reshape(-1))]


@pytest.mark.parametrize("S", [1, 2, 31, 32, 33, 4096])
@pytest.mark.parametrize("h", [1, L])
def test_fold_of_sub_chunk_crcs_matches_zlib_and_reference(rng, S, h):
    """G = 3 groups of one h-word unit and S - 1 units of SUB_WORDS words:
    the fold of their zlib CRCs is zlib's CRC of the group."""
    G = 3
    a = words(rng, G, h + (S - 1) * L)
    units = [[a[g, :h]] + [a[g, h + k * L:h + (k + 1) * L] for k in range(S - 1)]
             for g in range(G)]
    crcs = np.array([[zcrc(u) for u in row] for row in units], dtype=np.uint32)
    base = mat(4 * L)
    got = as_ints(tcrc.fold_crcs_plain(as_torch(crcs), base, G, S))
    assert got == [zcrc(a[g]) for g in range(G)]
    jmat = jnp.asarray(jref.crc32_shift_matrix(4 * L))
    assert got == [int(jcrc.combine_chunk_crcs(jnp.asarray(crcs[g]), jmat)) for g in range(G)]
    # the CPU wrapper takes the same plain version
    assert as_ints(tcrc.fold_crcs(as_torch(crcs), base)) == got


@pytest.mark.parametrize("C", [1, 2, 31, 32, 33, 256])
def test_combine_chunk_crcs_through_the_fold(rng, C):
    """combine_chunk_crcs as the fold sees it: G = 1, S = C, every unit the
    chunk's length, so the chunk's shift matrix is the base."""
    W = 7
    a = words(rng, C, W)
    states = np.array([zcrc(a[c]) for c in range(C)], dtype=np.uint32)
    want = zcrc(a.reshape(-1))
    got = as_ints(tcrc.fold_crcs_plain(as_torch(states), mat(4 * W), 1, C))
    assert got == [want]
    jwant = jcrc.combine_chunk_crcs(jnp.asarray(states), jnp.asarray(jref.crc32_shift_matrix(4 * W)))
    assert int(jwant) == want
    assert int(tcrc.combine_chunk_crcs(as_torch(states), mat(4 * W))) == want


def test_fold_of_random_crcs_matches_the_serial_fold(rng):
    """Any 32-bit values, not only CRCs of data: the tree joins them as the
    left-to-right fold does, at every S from 1 to 100."""
    base = mat(4 * L)
    for S in range(1, 101):
        crcs = as_torch(words(rng, 2, S))
        got = as_ints(tcrc.fold_crcs_plain(crcs, base, 2, S))
        assert got == [int(tcrc.combine_chunk_crcs_plain(crcs[g], base)) for g in range(2)], S


def test_fold_crcs_checks_its_operands():
    w = torch.zeros(64, dtype=torch.uint32)
    with pytest.raises(ValueError):
        tcrc.fold_crcs(w.view(2, 32), w[:31])
    with pytest.raises(ValueError):
        tcrc.fold_crcs(w[:0].view(2, 0), w[:32])
    with pytest.raises(TypeError):
        tcrc.fold_crcs(w.view(torch.int32).view(2, 32), w[:32])
    with pytest.raises(ValueError):
        tcrc.fold_crcs(w, w[:32])
