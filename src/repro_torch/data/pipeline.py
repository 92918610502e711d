"""Data pipeline: deterministic synthetic LM stream + async double-buffered
prefetch.

The prefetcher is the paper's G2 discipline applied to input data: host ->
device batch movement is an asynchronous streaming copy overlapped with the
current step's compute, with a bounded in-flight depth (WQ-depth analogue,
paper Fig. 4).  On the card the copies go from pinned host memory,
``non_blocking``, on a side stream, and each batch carries an event that the
consumer's stream waits on before it uses the batch.  Determinism:
batch(step) is a pure function of (seed, step), drawn with numpy exactly as
the JAX package draws it, which is what makes checkpoint/restart exactly
resumable.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.distributed.sharding import place
from repro_torch.obs.spans import stage


class SyntheticLMDataset:
    """Zipf-ish token stream with structure (so loss can actually fall):
    tok[t+1] depends on tok[t] through a fixed random bigram table."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        v = min(cfg.vocab_size, 4096)
        rng = np.random.default_rng(seed)
        self._vocab_used = v
        self._bigram = rng.integers(0, v, size=(v, 4)).astype(np.int32)

    def batch_at(self, step: int) -> Dict[str, Any]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        v = self._vocab_used
        toks = np.zeros((self.batch, self.seq_len), np.int32)
        toks[:, 0] = rng.integers(0, v, self.batch)
        choice = rng.integers(0, 4, size=(self.batch, self.seq_len))
        noise = rng.random((self.batch, self.seq_len)) < 0.1
        rand_tok = rng.integers(0, v, size=(self.batch, self.seq_len))
        for t in range(1, self.seq_len):
            nxt = self._bigram[toks[:, t - 1], choice[:, t]]
            toks[:, t] = np.where(noise[:, t], rand_tok[:, t], nxt)
        batch = {"tokens": toks, "loss_mask": np.ones_like(toks, np.float32)}
        if self.cfg.vlm is not None:
            npch = min(self.cfg.vlm.num_patches, max(self.seq_len - 2, 1))
            batch["patch_embeds"] = rng.normal(size=(self.batch, npch, self.cfg.d_model)).astype(
                np.float32
            ) * 0.02
            pos = np.broadcast_to(np.arange(self.seq_len)[None], (self.batch, self.seq_len))
            batch["positions_thw"] = np.stack([pos, pos, pos]).astype(np.int32)
            batch["loss_mask"][:, 1 : 1 + npch] = 0.0
        if self.cfg.encoder is not None:
            batch["frame_embeds"] = rng.normal(
                size=(self.batch, self.cfg.encoder.source_len, self.cfg.d_model)
            ).astype(np.float32) * 0.02
        return batch


class Prefetcher:
    """Depth-bounded async host->device prefetch (double buffering).

    ``device`` is where batches go: None means CUDA (raising where no card
    is present), ``"cpu"`` the CPU, where a batch is the dataset's arrays as
    tensors.  ``shardings`` ({batch key: ``distributed.sharding.
    NamedSharding``}, e.g. ``tree_shardings(batch, mesh, rules)``) lays each
    leaf it names out on its mesh as a DTensor, as the consumer takes the
    batch."""

    def __init__(self, dataset: SyntheticLMDataset, start_step: int = 0, depth: int = 2,
                 shardings: Optional[Any] = None, dtype=torch.bfloat16, device=None):
        self.dataset = dataset
        self.shardings = shardings
        self.depth = depth
        self.dtype = dtype
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                        else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _put_device(self, batch) -> Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if v.dtype == np.float32 and k != "loss_mask":
                t = t.to(self.dtype)
            if self._stream is not None:
                with torch.cuda.stream(self._stream):
                    t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        if self._stream is None:
            return out, None
        ready = torch.cuda.Event()
        ready.record(self._stream)
        return out, ready

    def _producer(self):
        while not self._stop.is_set():
            batch = self.dataset.batch_at(self._step)
            try:
                self._q.put((self._step, self._put_device(batch)), timeout=0.5)
                self._step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        with stage("data.next"):
            step, (batch, ready) = self._q.get()
            if ready is not None:
                # the consumer's stream waits for the copies; the tensors were
                # made on the side stream, so the allocator must not reuse
                # them until the consumer's work on them is done
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(ready)
                for t in batch.values():
                    t.record_stream(consumer)
            if self.shardings is not None:
                batch = {k: place(v, self.shardings[k]) if k in self.shardings else v
                         for k, v in batch.items()}
            return step, batch

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)
