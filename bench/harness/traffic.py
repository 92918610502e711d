"""The general traffic generator: it reads a mix's data file
(``bench/traffic/<mix>.json``) and makes the run's inputs from the seed.

Lengths come in rounds: a round is the list of ``round`` lengths at the
distribution's quantiles (i + 0.5) / round, in an order drawn from the
mix's own ``order_seed``.  The run's seed draws the token ids (and the
weights, and the requests checked), never the lengths or their order: the
order of the lengths decides which prefills a step admits together, and
with it the time to first token, so every seed is given the same work.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Iterator, List, Tuple

import numpy as np


def rng(seed: int, *keys: int) -> np.random.Generator:
    """A generator for (seed, keys): any whole seed, negative or past 64 bits."""
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), *keys]))


def quantile_lengths(spec: dict, n: int) -> List[int]:
    """The ``n`` quantiles at (i + 0.5) / n of a length distribution:
    ``lognormal`` (median, sigma) or ``uniform`` (min..max), rounded and
    clipped to [min, max]."""
    lo, hi = int(spec["min"]), int(spec["max"])
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if spec["dist"] == "lognormal":
            v = spec["median"] * math.exp(spec["sigma"] * NormalDist().inv_cdf(u))
        elif spec["dist"] == "uniform":
            v = lo + u * (hi - lo)
        else:
            raise ValueError(f"unknown length distribution {spec['dist']!r}")
        out.append(min(hi, max(lo, int(round(v)))))
    return out


class ServeTraffic:
    """Requests of a serving mix in the order the clients send them:
    (index, prompt [S] int32, output tokens)."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        self.spec, self.seed, self.vocab = spec, seed, vocab
        self.round = int(spec["round"])
        self.prompts = quantile_lengths(spec["prompt_tokens"], self.round)
        self.outputs = quantile_lengths(spec["output_tokens"], self.round)

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray, int]]:
        i = 0
        for r in range(1 << 30):
            g = rng(self.spec["order_seed"], 1, r)
            prompts = g.permutation(self.prompts)
            outputs = g.permutation(self.outputs)
            for p, o in zip(prompts, outputs):
                toks = rng(self.seed, 2, i).integers(0, self.vocab, int(p), dtype=np.int32)
                yield i, toks, int(o)
                i += 1


def train_batch(spec: dict, seed: int, step: int, vocab: int) -> dict:
    """Step ``step``'s batch: ``batch`` rows of ``seq`` token ids, uniform
    over the vocabulary, every row its own draw."""
    toks = rng(seed, 3, step).integers(0, vocab, (spec["batch"], spec["seq"]), dtype=np.int32)
    return {"tokens": toks, "loss_mask": np.ones(toks.shape, np.float32)}


class TrainBatches:
    """The batches as a dataset for the program's ``Prefetcher``, which
    calls ``batch_at(step)``."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        self.spec, self.seed, self.vocab = spec, seed, vocab

    def batch_at(self, step: int) -> dict:
        return train_batch(self.spec, self.seed, step, self.vocab)
