"""The traffic generator: a seed gives the same inputs every time, and
every seed the same lengths in another order."""
from itertools import islice

import numpy as np
import pytest

from bench.harness import core, traffic

SEEDS = (0, 7, 2**31 + 11, 2**40 + 3)


def _mix(name):
    return core.load_json(core.BENCH / "traffic" / f"{name}.json")


@pytest.mark.parametrize("mix", ["chat", "rag"])
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_requests(mix, seed):
    spec = _mix(mix)
    a = list(islice(traffic.ServeTraffic(spec, seed, 1000), 70))
    b = list(islice(traffic.ServeTraffic(spec, seed, 1000), 70))
    assert [(i, o) for i, _, o in a] == [(i, o) for i, _, o in b]
    assert all(np.array_equal(p, q) for (_, p, _), (_, q, _) in zip(a, b))
    assert all(p.dtype == np.int32 and 0 <= p.min() and p.max() < 1000 for _, p, _ in a)


@pytest.mark.parametrize("mix", ["chat", "rag"])
def test_every_seed_the_same_lengths_other_tokens(mix):
    """The lengths and their order are the mix's; the seed draws the
    token ids.  Each round holds the distribution's quantiles."""
    spec = _mix(mix)
    n = spec["round"]
    runs = [list(islice(traffic.ServeTraffic(spec, seed, 1000), 2 * n)) for seed in SEEDS]
    lengths = [[(len(p), o) for _, p, o in reqs] for reqs in runs]
    assert all(x == lengths[0] for x in lengths)
    assert sorted(p for p, _ in lengths[0][:n]) == traffic.quantile_lengths(
        spec["prompt_tokens"], n)
    assert [p for p, _ in lengths[0][:n]] != [p for p, _ in lengths[0][n:]]
    firsts = {runs[k][0][1].tobytes() for k in range(len(SEEDS))}
    assert len(firsts) == len(SEEDS)


def test_lengths_follow_the_mix():
    chat, rag = _mix("chat"), _mix("rag")
    p = traffic.quantile_lengths(chat["prompt_tokens"], chat["round"])
    o = traffic.quantile_lengths(chat["output_tokens"], chat["round"])
    assert min(p) >= 64 and max(p) <= 3072 and np.median(p) == pytest.approx(1020, rel=0.05)
    assert min(o) >= 16 and max(o) <= 512 and np.median(o) == pytest.approx(129, rel=0.05)
    assert max(p) + max(o) <= chat["max_cache_len"]
    p = traffic.quantile_lengths(rag["prompt_tokens"], rag["round"])
    o = traffic.quantile_lengths(rag["output_tokens"], rag["round"])
    assert 2048 <= min(p) and max(p) <= 3584 and 16 <= min(o) and max(o) <= 64
    assert max(p) + max(o) <= rag["max_cache_len"]


@pytest.mark.parametrize("seed", SEEDS)
def test_train_batches_repeat_and_every_row_differs(seed):
    spec = _mix("train")
    a = [traffic.train_batch(spec, seed, s, 32001)["tokens"] for s in range(3)]
    b = traffic.TrainBatches(spec, seed, 32001)
    assert all(np.array_equal(x, b.batch_at(s)["tokens"]) for s, x in enumerate(a))
    rows = np.concatenate(a)
    assert rows.shape == (3 * spec["batch"], spec["seq"])
    assert len({r.tobytes() for r in rows}) == len(rows)
