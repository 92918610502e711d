#!/usr/bin/env python3
"""Drive the repro_torch port on one NVIDIA GPU and hold each of its CUDA
kernels against its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught and skipped):

  1. build the kernels from src/repro_torch/kernels/csrc/ and print the card;
     the bf16 flash kernel's SASS must hold HGMMA (tensor-core) instructions
     at every head dim;
  2. each slice-1 kernel against its plain version on the card, bit-exact, at
     ragged word counts (a CRC with one chain among them; copies from starts
     of 0-3 words and one word either side of the bulk-copy ring's edges,
     over 1, 3 and 4 PE spans), over float32,
     bfloat16, int8 and uint32, batches with duplicate destinations and
     untouched pages; CRC and copy+CRC also against zlib (sizes <= 1 MiB);
     the CRC pair at the edges of its sub-chunk split (W of 1 .. a prime
     above 40 sub-chunks, C = 1, 3, 256, views from words 0-3 so both load
     paths run, and 1 GiB) against its plain version or zlib per chunk, and
     the fold against both plain versions (C = 1 .. 256, S = 1, 33, 4096);
  2b. each slice-2 kernel the same way: fills with 1-, 2- and 4-word
     patterns over 1-4 PE spans, into outputs 0-3 words off 16 bytes, at
     counts either side of one and two CTAs of the fill's grid; compares
     with the difference at word 0, in the middle, at the last word and
     nowhere; delta records with 0, a few, exactly cap and cap + 1
     differences (word 0 among them) and an overflow; applies of every
     record kind (``delta_kinds``: the ascending prefix delta_record_words
     writes, and duplicates, pads first or among the entries, offsets past
     the end, descending, all pads, cap 0, ...) at 1000 and 4099 words and
     at 1 GiB (the ring route) and one word less (the store route), both
     the fast and the general path of each; DIF with a corrupted block;
  3. the slice-1 main path: ``make_device(n_instances=2,
     policy="least_loaded")`` runs memcpy, crc32 with ``.then``, a promise
     fence, an 8-descriptor fused batch, copy_crc, batch_copy into a
     destination pool, a 32-descriptor ``submit_many`` burst, and a drain;
  4. the same path at the sizes its users submit (copies and CRCs of
     4 KiB .. 1 GiB, a 256 MiB checkpoint leaf, DPDK's 32 x 2 KiB burst,
     1024 pages of 16 KiB within a 4096-page pool);
  3b. the slice-2 main path: the whole quickstart (delta section included),
     fill, compare, DIF and cache-flush descriptors, and ``dto`` under
     ``dto_enabled``;
  4b. the same at real sizes: fill and compare of 4 KiB .. 1 GiB, a delta
     record of a 256 MiB bf16 checkpoint leaf with 0.5 % of its words
     changed and a cap of 25 % of its words, restored bit for bit, ``dto``
     of 64 MiB, DIF over 1 MiB of 512-byte blocks;
  2c. each slice-3 kernel the same way: dualcast, compare-pattern and
     fill-verify of 1, 127, 129 and 1024 words, 1 MiB and 64 MiB with 1-,
     2- and 4-word patterns; compare-pattern with mismatches at word 0, at
     the last word, at a random word and in every word; fill-verify's
     buffer against fill_words and its pair against compare_pattern_words;
  3c. the slice-3 main path: dualcast, compare-pattern and fill-verify
     descriptors (desclint strict), a MomentOffloader round trip, and a
     CheckpointManager (crc_impl="kernel" on the device, replicas=2): a
     full save, two delta saves at 0.5 % drift, an overflowing save, the
     newest primary corrupted and restored from the replica; every restore
     bit-exact and every manifest CRC equal to zlib's;
  4c. the same at real width: the parameters of tinyllama-1.1b (bf16) with
     fp32 AdamW moments and an int32 step, cut to 2 of its 22 decoder
     layers (219 M parameters, 2.19 GB a save), and dualcast,
     compare-pattern and fill-verify of 4 KiB .. 1 GiB through the device;
  2d. the flash-attention kernels against their plain version: head dims
     32, 64, 128 and 256 (each in bf16 with GQA groups of 1, 4 and 8),
     causal and not, a window with and without a meta prefix, Sq = Skv of
     1, 63, 64, 65, 77, 100, 129, 1000 and 2048 (the bf16 kernel's tile
     edges), B = 2 with ragged lengths, B = 8 at tinyllama's 2048 tokens
     (phase 4e(i)'s training shape), windowed Sq > Skv cases with rows
     that see no key or only the meta keys, gemma3-1b's local layers (hd
     256, window 1024), qwen2-vl-2b's (hd 128) and deepseek-moe-16b's (MHA,
     16 heads of 128) at 2048 tokens, hymba-1.5b's (25 heads over 5 KV
     heads, 128 meta tokens, window 1024 and 0) at 2048 + 128 and 333 +
     128 positions, bf16 and f32;
  3d. the slice-4 main path at a small size: tinyllama-1.1b.reduced() in f32
     served (6 requests of 16-77 tokens, 4 new tokens each) by the
     ``VhostStyleServer`` with ``attn_impl="flash"`` on the card, and with the
     same weights on the CPU: the same tokens, prefill logits within 1e-4;
     a ``PagedKVPool`` on the card reserves the prompts' pages and swaps a
     sequence out and back (bit for bit, no synchronous fallback);
  4d. the same at full width and depth: tinyllama-1.1b (22 layers, bf16,
     2.2 GB of weights), 4 slots, 8 requests of 2048 .. 77 tokens, 16 new
     tokens each: every request completes, 22 x 8 flash launches, the prompt
     copies through memcpy_words and batch_copy_pages; the 2048-token
     prefill's logits under "flash" against "chunked" (plain PyTorch): with
     the weights in f32 within 1e-4, in bf16 within twice the bf16 rounding
     noise measured in the run (chunked bf16 against chunked f32); time to
     first token per prompt, decode tokens/s, seconds;
  2e. flash attention's backward (the kernel forward, the chunked
     recompute backward) against the chunked path's gradients on the card,
     under ``torch.func.grad`` and ``.backward()``: f32 at [1, 128, 4, 32] /
     [1, 128, 2, 32] within 2e-4, bf16 at tinyllama's [B, 2048, 32, 64] /
     [B, 2048, 4, 64] with B = 1 and phase 4e(i)'s B = 8, within 4 bf16
     ulps of each gradient's largest entry;
  3e. the traced main path: under each wait policy a
     ``make_device(trace=1.0)`` with a Sampler attached (``observe``) runs
     copies (one behind an ``after=`` fence), CRCs with a ``.then`` chain,
     fills and fused batches at 4 KiB, 1 MiB and 64 MiB: every phase on
     every traced submit, the edges, the tracer's host-free fraction equal
     to WaitStats', a valid Perfetto export, the Sampler's totals equal to
     the telemetry snapshot's; a forced QueueFull closes its trace; the 4
     KiB round trip traced and untraced, 1000 trips a policy: spin's
     host-free share 0 and its median untraced trip below umwait's; phase
     3d's reduced model served on a traced device, every descriptor under
     its request's ``req<id>``;
  4e. training: (i) tinyllama-1.1b at full width and depth (bf16, flash,
     per-layer remat), 6 ``make_train_step`` steps of 8 x 2048 tokens from
     ``SyntheticLMDataset`` through the ``Prefetcher``: finite, falling
     loss, 2 x 22 x 6 flash launches, peak memory, seconds a step (eager,
     no compile step) and one step under ``torch.profiler``; (ii)
     ``launch/train.py``'s ``train()`` at full width, depth cut to 2 of 22
     layers, saves every 2 steps with kernel CRCs on 2 engines, run whole
     (no restart) and with a crash injected after step 4's save (exactly
     that one restart), on the host mesh with ZeRO-1 specs: the resumed
     run's step-6 checkpoint equals the whole run's bit for bit, its
     manifest CRCs are zlib's;
  3f. gemma3-1b.reduced() at 8 layers (one period of 5 local layers with a
     16-token ring and a global one, then 2 local layers) in f32, served
     (6 requests of 16-77 tokens, 8 new tokens each, 3 slots; the ring wraps
     in prefill and in decode) on the card and on the CPU with the same
     weights: the same tokens, prefill logits within 1e-4; every splice of
     a batch-1 prefill into the batch cache checked leaf by leaf;
  4f. gemma3-1b at full width and depth (26 layers, d_model 1152, 4 heads
     and 1 KV head of 256, a 1024-token window on 5 of 6 layers, qk-norm,
     tied embeddings; bf16, ~1.0 G parameters) served as in 4d: every
     request completes, 26 x 8 flash launches, each admission's spliced
     slot bit-equal to its batch-1 prefill cache on every leaf (the other
     slots unchanged), flash against chunked prefill logits as in 4d, TTFT,
     decode tokens/s, peak memory;
  4g. qwen2-vl-2b at full width and depth (28 layers, d_model 1536, 12 heads
     and 2 KV heads of 128, M-RoPE sections (16, 24, 24); bf16, ~1.8 G
     parameters) through the model API: 2 x 2048 tokens with 256 patch
     embeddings at positions 1-256 on a 16 x 16 (t, h, w) grid, prefill and
     16 greedy decode steps, 28 flash launches in the prefill, flash against
     chunked prefill logits as in 4d; the same batch at reduced() size in
     f32 on the card and on the CPU within 1e-4;
  3h. deepseek-moe-16b, llama4-maverick and mamba2-370m at reduced() size in
     f32, each served on the card and on the CPU as in 3f, admission pinned
     (each prompt copy waited for at its submit, so both servers admit at
     the same steps: an MoE's tokens depend on their decode neighbours):
     the same tokens, every splice checked, the router's indices and keep
     masks equal at every MoE layer of the first prefill, the smallest
     top-k margin;
  4h. deepseek-moe-16b at full width and depth (28 layers: a dense layer
     with d_ff 10944, then 27 MoE layers of 64 experts top-6 and 2 shared
     experts; MHA, 16 heads of 128; bf16, 16.37 G parameters, 32.7 GB)
     served as in 4d: 28 x 8 flash launches, the drops by MoE layer in the
     2048-token prefill, flash against chunked prefill logits as in 4d with
     the weights made f32 in place (65.5 GB);
  4i. mamba2-370m at full width and depth (48 layers, d_model 1024, 32 SSD
     heads of 64, d_state 128; bf16) served as in 4d (no attention: no flash
     launch); a prefill of 2047 tokens and one decode step against a
     prefill of 2048: f32 within 1e-3, bf16 within twice the measured
     noise;
  3i. hymba-1.5b at reduced() size (4 one-layer segments) and at 8 layers
     (a scanned run of 3 local layers), f32, served on the card and on the
     CPU as in 3h with a ``PagedKVPool`` as in 3d (the same tokens, every
     splice checked, one flash launch a layer a prefill), then a 12-token
     prompt decoded 12 steps past the window of 16 on both (logits and
     every cache leaf within 1e-4, each ring holding the 4 meta positions
     and the last 16); seamless-m4t-medium
     at reduced() size: prefill and 12 decode steps on both, no flash
     launch (its attention is the chunked path, as the reference's);
  4j. hymba-1.5b at full width and depth (32 layers, d_model 1600, 25 / 5
     heads of 64 beside 50 SSD heads, 128 meta tokens, window 1024 on 29
     layers; bf16, 1.64 G parameters) served as in 4d: 32 x 8 flash
     launches, every splice bit-exact on every leaf (rings and SSM states
     included); a 1000-token prompt decoded 200 steps past the 1024-slot
     ring, its logits at three lengths past the wrap against a fresh
     prefill: with the weights in f32 within 1e-3, in bf16 within twice the
     bf16 noise measured in the run; flash against chunked prefill logits
     as in 4d;
  4k. seamless-m4t-medium at full width and depth (12 + 12 layers, d_model
     1024, vocab 256206; bf16, 0.98 G parameters) through the model API: 4
     x 64 tokens over 160 frame embeddings, 16 greedy steps, the last
     step's logits against a teacher-forced prefill within 0.08; prefill
     and decode-step seconds;
  3j. the host mesh (``make_host_mesh``: one rank, ("data", "model") of
     (1, 1); NCCL on the card, gloo on the CPU, in one process group):
     tinyllama-1.1b and deepseek-moe-16b (a2a dispatch) at reduced() size
     in f32, built on the mesh with flash and tp_comm="manual_bf16", their
     parameters laid out by the rules as DTensors, served under the rules
     as in 3h: the same tokens on the card's mesh and the CPU's, every
     splice checked, one flash launch a layer a prefill, the a2a's
     all-reduces counted; tinyllama's tokens also those of the same
     weights with no mesh;
  4l. both at full width and depth on the card's host mesh, served as in
     4d: tinyllama-1.1b must serve 4d's tokens; deepseek-moe-16b with the
     a2a dispatch, every splice bit-exact, its TTFT and decode steps
     printed beside 4h's, and its 2048-token prefill under the a2a and the
     dense dispatch with the capacity factor raised to ceil(E / k) (no
     drops in either): within twice the bf16 noise measured in the run
     (the dense dispatch with the weights made f32 in place);
  7a. (run last, with 7b-7d) the card's attained peaks: a bf16 matmul of
     8192 cubed and a 1 GiB ``Tensor.copy_``, medians of 10 under CUDA
     events, against ``roofline.H100``'s data-sheet peaks;
  7b. tinyllama-1.1b's train step at full width and depth, 4e(i)'s 8 x
     2048 tokens, chunked attention, on the host mesh: counted by
     ``launch/dryrun.py`` with fake tensors and again for real on the card
     under the same op counter (FLOPs and bytes equal to 1e-6, collective
     bytes 0); a warm-up and the median of 3 timed steps; its roofline
     terms, bottleneck, roofline share and MFU (against the data sheet's
     peak and 7a's), the dry run's memory estimate against
     ``max_memory_allocated``, and the MFU of 4e(i)'s flash step;
  7c. 4d's decode step (4 slots, a 2048-token cache) counted for real and
     timed: its roofline terms against the measured step;
  7d. ``python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape
     train_4k --mesh both`` in a process of its own on the host's cores,
     after 7c, so that its host work shares no cores with a timed step:
     both records must be ok;
  5. each kernel's time at the phase 4 / 4b / 4c / 4d shapes beside its
     bound, its plain version's time and, where one PyTorch call computes
     the same function, that call's time (for flash attention
     ``scaled_dot_product_attention``, also at hd 128 and 256, and at the
     gemma3-1b, qwen2-vl-2b, deepseek-moe-16b and hymba-1.5b (a local and a
     global layer) prefill shapes with their bounds over the visible (q, k)
     pairs and SDPA (with an explicit boolean mask for the window and the
     meta keys); fill against
     ``Tensor.fill_`` interleaved call by call); the device work of one
     delta apply on the leaf (``torch.profiler``); the save and restore
     seconds of phase 4c; ``ops.crc32`` end to end at 4 KiB .. 1 GiB;
  6. the launch counts of each slice's main path, set to 0 just before it
     and read just after: every kernel of the path must have launched
     (flash_attention and memcpy_words in 3f and 4f, flash_attention in
     4g; memcpy_words, and flash_attention except for mamba2, in 3h, 4h and
     4i; flash_attention once a layer a prefill in 3i and 4j, never for
     seamless in 3i and 4k); and
     of one ``ops.crc32`` at 4 KiB .. 1 GiB: one CRC launch, plus the
     sub-chunk fold only where a chunk is longer than one sub-chunk.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Exits with 2, printing
no result, where ``torch.cuda.is_available()`` is false.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
import weakref
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

KiB, MiB, GiB = 1 << 10, 1 << 20, 1 << 30
#: device-memory rate from NVIDIA's data sheets (bytes / s), by a word of
#: the card's name; an H100 SXM (the default) has 3.35 TB/s
MEM_BPS = (("H200", 4.8e12), ("NVL", 3.9e12), ("PCIe", 2.0e12))
H100_SXM_MEM_BPS = 3.35e12
#: 32-bit operations outside the tensor cores (the data sheet's float32
#: rate of an H100 SXM); the CRC's table lookups and xors are counted here
H100_SXM_OPS = 67e12
#: dense bf16 tensor-core rate of an H100 SXM (the data sheet): the bound of
#: attention's matmuls
H100_SXM_BF16_OPS = 989e12
#: integer operations of one slice-by-4 CRC step: xor, 3 shifts, 4 masks,
#: 4 table reads, 3 xors of the lookups
CRC_OPS_PER_WORD = 15
#: memcpy_words' bulk ring (csrc/dsa_kernels.cu kCopyChunk, kCopyStages):
#: spans of at least one full ring per SM go through it; phase 2 copies
#: lengths one word either side of its edges
COPY_CHUNK_WORDS = 32 * KiB // 4
COPY_STAGES = 4
SOURCE = "src/repro_torch/kernels/csrc/dsa_kernels.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
#: bytes read between two timed calls, to push the last call's data out of
#: the 50 MB L2 (read, not written, so no dirty lines are left to evict)
FLUSH_BYTES = 256 * MiB
#: where phases 3c and 4c write their checkpoints (inside the checkout, under
#: build/, which git ignores); removed when the script ends
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
#: tinyllama-1.1b (src/repro/configs/tinyllama_1_1b.py: arXiv:2401.02385),
#: written out here; phase 4c cuts its 22 decoder layers to 2
TINYLLAMA = dict(d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64, d_ff=5632,
                 vocab=32000, n_layers=22)
TINYLLAMA_LAYERS_KEPT = 2
#: phase 4d's prompts: tinyllama's whole 2048-token context, then shorter
#: ones; 1000, 333 and 77 leave the kernel's last 64-row tile partial and do
#: not split into equal prompt chunks
FULL_PROMPTS = (2048, 1536, 1024, 1000, 512, 512, 333, 77)
FULL_SLOTS, FULL_CACHE, FULL_NEW = 4, 2064, 16
#: flash attention against its plain version: f32 is the same f32 sums in
#: another order; bf16 outputs within 2 bf16 ulps (2^-7 relative, plus p
#: rounded to bf16 relative to another running max)
FLASH_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
             torch.bfloat16: dict(atol=1.6e-2, rtol=1.6e-2)}
#: phase 3d, the f32 model on the card against the CPU, and phase 4d's f32
#: prefill under "flash" against "chunked": the same f32 arithmetic with sums
#: in other orders (cuBLAS and the CPU; the kernel's 32-key tiles and the
#: plain version's 512-key blocks) through 4 or 22 layers
SERVE_F32_TOL = dict(atol=1e-4, rtol=1e-4)
#: phase 4d in bf16: every matmul, norm and add of 22 layers rounds to bf16
#: (2^-8), which alone moves the logits of this random model by about 0.06
#: from the f32 model's (the noise, measured in the run as chunked bf16
#: against chunked f32).  Flash against chunked in bf16 must stay within
#: twice that noise, and flash's distance from the f32 model within 1.5
#: times chunked's.
BF16_NOISE_FACTOR = 2.0
BF16_FROM_F32_FACTOR = 1.5


class SmokeError(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype
            and torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                            b.contiguous().reshape(-1).view(torch.uint8)))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest difference between two word buffers, each word read as an
    unsigned 32-bit integer (0 when they are bit-identical)."""
    if a.numel() == 0:
        return 0
    x = a.contiguous().reshape(-1).view(torch.int32).long() & 0xFFFFFFFF
    y = b.contiguous().reshape(-1).view(torch.int32).long() & 0xFFFFFFFF
    return int((x - y).abs().max())


def host(t: torch.Tensor) -> torch.Tensor:
    """A copy of the word tensor ``t`` on the host (moved as int32: the same
    bits)."""
    return t.view(torch.int32).cpu().view(t.dtype)


def rand_words(gen: torch.Generator, n_words: int, device) -> torch.Tensor:
    """``n_words`` random uint32 words made from ``gen`` on ``device``."""
    t = torch.randint(-2**31, 2**31, (n_words,), generator=gen, dtype=torch.int64,
                      device=gen.device)
    return t.to(torch.int32).view(torch.uint32).to(device)


def rand_tensor(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """Random bits of ``dtype`` in ``shape`` (NaN patterns included: every
    comparison here is bitwise)."""
    n = int(np.prod(shape)) * torch.empty(0, dtype=dtype).element_size()
    return rand_words(gen, n // 4, device).view(dtype).reshape(shape)


def phase(name: str):
    def deco(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            print(f"== phase {name}", flush=True)
            out = fn(*a, **kw)
            print(f"== phase {name}: ok in {time.perf_counter() - t0:.2f} s", flush=True)
            return out
        return run
    return deco


# --------------------------------------------------------------------------- kernels
#: the kernels of each slice's main path: slice 1 (memcpy, batch copy, CRC,
#: copy+CRC) is driven by phases 3 and 4, slice 2 (fill, compare, delta
#: records, DIF through the CRC kernel) by phases 3b and 4b
SLICE1 = ("memcpy_words", "batch_copy_pages", "crc32_chunk_states", "gf2_fold",
          "copy_crc_words")
SLICE2 = ("fill_words", "compare_words", "delta_record_words", "delta_apply_words",
          "crc32_chunk_states")
#: slice 3 (phases 3c and 4c): the three new kernels, plus the moment
#: offload's copies and the checkpoint's kernel CRC (copy+CRC and its fold)
SLICE3 = ("dualcast_words", "compare_pattern_words", "fill_verify_words", "memcpy_words",
          "copy_crc_words", "gf2_fold")
#: slice 4 (phases 3d and 4d): serving: flash attention in every prefill, the
#: prompt copies (memcpy, and batch copy where the chunks are equal and fuse)
SLICE4 = ("flash_attention", "memcpy_words", "batch_copy_pages")


def kernel_table():
    """name -> (wrapper with its ``launches`` count, file:line replaced)."""
    from repro_torch.kernels import (batch_copy, compare, crc32, delta_apply, delta_create,
                                     dualcast, fill, flash_attention, fused, memcpy)

    return {
        "memcpy_words": (memcpy.memcpy_words, "src/repro/kernels/memcpy.py:20"),
        "batch_copy_pages": (batch_copy.batch_copy_pages,
                             "src/repro/kernels/batch_copy.py:30"),
        "crc32_chunk_states": (crc32.crc32_chunk_states,
                               "src/repro/kernels/crc32.py:58"),
        "gf2_fold": (crc32.fold_crcs, "src/repro/kernels/crc32.py:97"),
        "copy_crc_words": (fused.copy_crc_words, "src/repro/kernels/fused.py:56"),
        "fill_words": (fill.fill_words, "src/repro/kernels/fill.py:28"),
        "compare_words": (compare.compare_words, "src/repro/kernels/compare.py:25"),
        "delta_record_words": (delta_create.delta_record_words,
                               "src/repro/kernels/delta_create.py:25"),
        "delta_apply_words": (delta_apply.delta_apply_words,
                              "src/repro/kernels/delta_apply.py:41"),
        "compare_pattern_words": (compare.compare_pattern_words,
                                  "src/repro/kernels/compare.py:61"),
        "dualcast_words": (dualcast.dualcast_words, "src/repro/kernels/dualcast.py:22"),
        "fill_verify_words": (fused.fill_verify_words, "src/repro/kernels/fused.py:106"),
        "flash_attention": (flash_attention.flash_attention,
                            "src/repro/kernels/flash_attention.py:72"),
    }


def reset_counts() -> None:
    for wrapper, _ in kernel_table().values():
        wrapper.launches = 0


def read_counts(names) -> dict:
    table = kernel_table()
    return {name: table[name][0].launches for name in names}


# --------------------------------------------------------------------------- phase 1
@phase("1 build")
def build() -> dict:
    from repro_torch.kernels import _build, flash_attention

    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    print(f"built {_build.library_path().name} in {secs:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    hgmma = tensor_core_instructions()
    print(f"  HGMMA instructions in the SASS of the bf16 flash kernel, by head dim: {hgmma}")
    check(sorted(hgmma) == list(flash_attention.HEAD_DIMS) and all(hgmma.values()),
          f"the bf16 flash kernel does not run on the tensor cores: {hgmma}")
    return {"build_s": secs}


def tensor_core_instructions() -> dict:
    """head dim -> HGMMA instructions in the SASS of the bf16 flash kernel of
    the built library (cuobjdump, beside nvcc)."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0]
        found = re.search(r"flash_attention_wgmma_kernelILi(\d+)E", name)
        if found:
            counts[int(found.group(1))] = len(re.findall(r"\bHGMMA\.", block))
    return counts


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- phase 2
@phase("2 kernels against their plain versions")
def kernels_vs_plain(dev, gen, errs: dict, big_words: int = MiB // 4,
                     crc_big: int = GiB) -> None:
    from repro_torch.kernels import batch_copy, crc32, fused, memcpy, ops, ref

    def note(name, err):
        errs[name] = max(errs.get(name, 0), err)
        check(err == 0, f"{name}: kernel disagrees with its plain version (max err {err})")

    # memcpy: ragged counts, unaligned starts (the scalar path), PE spans; and
    # on the bulk ring, spans one word either side of its threshold (a full
    # ring per SM) and of a chunk boundary past it, a ragged last span
    T, chunk = ring_bytes(dev) // 4, COPY_CHUNK_WORDS
    ring_sizes = (T - 1, T + 1, T + chunk - 1, T + chunk + 1, 4 * T - 1, 4 * T + chunk + 3)
    copy_base = rand_words(gen, 4 * T + chunk + 8, dev)
    for n in sorted({1, 5, 4099, min(65539, big_words), big_words, *ring_sizes}):
        for start in (0, 1, 2, 3):
            src = copy_base[start:start + n]
            for n_pe in (1, 3, 4):
                got = memcpy.memcpy_words(src, n_pe=n_pe)
                note("memcpy_words", max_abs_err(got, memcpy.memcpy_words_plain(src, n_pe=n_pe)))
    del copy_base, got
    base = rand_words(gen, big_words + 8, dev)
    # CRC chunk states, the fold and copy+CRC: 4099 words is prime (C = 1)
    tabs = ops._tables(base.device)
    for n in sorted({1, 3, 1000, 4099, min(65536, big_words), big_words}):
        C = ops._pick_chunks(n)
        data = base[:n].view(C, n // C)
        st = crc32.crc32_chunk_states(data, tabs)
        st_plain = crc32.crc32_chunk_states_plain(data, tabs)
        note("crc32_chunk_states", max_abs_err(st, st_plain))
        st2, cp = fused.copy_crc_words(data, tabs)
        st2_plain, cp_plain = fused.copy_crc_words_plain(data, tabs)
        note("copy_crc_words", max(max_abs_err(st2, st2_plain), max_abs_err(cp, cp_plain)))
        if C > 1:
            mat = ops._shift_mat((n // C) * 4, base.device)
            folded = crc32.combine_chunk_crcs(st, mat)
            note("gf2_fold", max_abs_err(folded.reshape(1),
                                         crc32.combine_chunk_crcs_plain(st, mat).reshape(1)))
        want = ref.crc32_ref(base[:n])
        check(int(ops.crc32(base[:n])) == want, f"crc32 of {n} words != zlib")
        cpy, crc = ops.copy_crc(base[:n])
        check(int(crc) == want and same_bits(cpy, base[:n]), f"copy_crc of {n} words")
    crc_pair_edges(dev, gen, note, tabs, crc_big)
    # four dtypes through the ops layer, ragged shapes
    for dtype, shape in ((torch.float32, (513, 130)), (torch.bfloat16, (1000, 6)),
                         (torch.int8, (4099, 4)), (torch.uint32, (big_words,))):
        x = rand_tensor(gen, shape, dtype, dev)
        check(same_bits(ops.memcpy(x), x), f"memcpy {dtype}")
        check(int(ops.crc32(x)) == ref.crc32_ref(x), f"crc32 {dtype} != zlib")
        cpy, crc = ops.copy_crc(x)
        check(same_bits(cpy, x) and int(crc) == ref.crc32_ref(x), f"copy_crc {dtype}")
    # batch copy: duplicate destinations, untouched pages, both copy paths
    for page_words in (100, 4096):
        src_pool = rand_words(gen, 16 * page_words, dev).view(16, page_words)
        dst_pool = rand_words(gen, 12 * page_words, dev).view(12, page_words)
        si = torch.randint(0, 16, (40,), generator=gen, dtype=torch.int32,
                           device=gen.device).to(dev)
        di = torch.randint(0, 10, (40,), generator=gen, dtype=torch.int32,
                           device=gen.device).to(dev)  # pages 10, 11 untouched
        got = batch_copy.batch_copy_pages(src_pool, dst_pool.clone(), si, di)
        plain = batch_copy.batch_copy_pages_plain(src_pool, dst_pool.clone(), si, di)
        note("batch_copy_pages", max_abs_err(got, plain))
        seq = ref.batch_copy_ref(src_pool, dst_pool, si, di)
        check(same_bits(got, seq), "batch copy != sequential reference")
        check(same_bits(got[10:], dst_pool[10:]), "batch copy touched untouched pages")
    for dtype in (torch.float32, torch.bfloat16, torch.int8, torch.uint32):
        src_pool = rand_tensor(gen, (8, 16, 64), dtype, dev)
        dst_pool = rand_tensor(gen, (8, 16, 64), dtype, dev)
        si = torch.tensor([1, 2, 3, 4, 5], dtype=torch.int32)
        di = torch.tensor([0, 6, 0, 2, 6], dtype=torch.int32)
        want = ref.batch_copy_ref(src_pool, dst_pool, si, di)
        got = ops.batch_copy(src_pool, dst_pool.clone(), si, di)
        check(same_bits(got, want), f"ops.batch_copy {dtype}")
    if dev.type == "cuda":
        torch.cuda.synchronize()


def zlib_states(data: torch.Tensor) -> torch.Tensor:
    """zlib's CRC of each row of the word tensor ``data`` [C, W], computed
    on the host, as uint32 [C] on ``data``'s device."""
    rows = host(data.contiguous()).view(torch.int32).numpy()
    crcs = np.array([zlib.crc32(memoryview(np.ascontiguousarray(r))) for r in rows],
                    dtype=np.uint32)
    return torch.from_numpy(crcs.view(np.int32)).to(data.device).view(torch.uint32)


def crc_pair_edges(dev, gen, note, tabs, big: int = GiB) -> None:
    """The CRC pair and the fold at the edges of the sub-chunk split: every
    width below at C = 1, 3 and 256, each view starting at words 0-3 (whole
    sub-chunks 16-byte aligned or not: both load paths), against the plain
    version where W <= L + 1 (L = SUB_WORDS), else against zlib of each
    chunk; the pair at ``big`` bytes (C = 256) against zlib of each chunk;
    the fold against combine_chunk_crcs_plain at C = 1, 2, 31, 32, 33, 256
    and against fold_crcs_plain at S = 1, 33, 4096 (G = 256)."""
    from repro_torch.kernels import crc32, fused, ops

    L = crc32.SUB_WORDS
    # either side of one sub-chunk and of 32 (one a lane of the fold), a
    # ragged first sub-chunk, and a prime above 40 sub-chunks
    widths = (1, L - 1, L, L + 1, 2 * L + 1, 31 * L, 32 * L, 32 * L + 1, 33 * L + 5, 10243)
    base = rand_words(gen, 256 * max(widths) + 8, dev)
    for C in (1, 3, 256):
        for W in widths:
            for start in range(4):
                data = base[start:start + C * W].view(C, W)
                want = (crc32.crc32_chunk_states_plain(data, tabs) if W <= L + 1
                        else zlib_states(data))
                note("crc32_chunk_states", max_abs_err(crc32.crc32_chunk_states(data, tabs), want))
                st, cp = fused.copy_crc_words(data, tabs)
                note("copy_crc_words", max_abs_err(st, want))
                check(same_bits(cp, data), f"copy_crc_words copy at C={C} W={W} start={start}")
    del base
    if big:
        src = rand_words(gen, big // 4, dev)
        data = src.view(ops._pick_chunks(src.numel()), -1)
        want = zlib_states(data)
        note("crc32_chunk_states", max_abs_err(crc32.crc32_chunk_states(data, tabs), want))
        st, cp = fused.copy_crc_words(data, tabs)
        note("copy_crc_words", max_abs_err(st, want))
        check(same_bits(cp, data), f"copy_crc_words copy of {big} B")
        del src, data, cp
    for C in (1, 2, 31, 32, 33, 256):
        states = rand_words(gen, C, dev)
        mat = ops._shift_mat(4 * 7, dev)
        note("gf2_fold", max_abs_err(crc32.combine_chunk_crcs(states, mat).reshape(1),
                                     crc32.combine_chunk_crcs_plain(states, mat).reshape(1)))
    base_mat = ops._shift_mat(4 * L, dev)
    for S in (1, 33, 4096):
        crcs = rand_words(gen, 256 * S, dev).view(256, S)
        note("gf2_fold", max_abs_err(crc32.fold_crcs(crcs, base_mat),
                                     crc32.fold_crcs_plain(crcs, base_mat, 256, S)))
    print(f"CRC pair at C = 1, 3, 256 and W = {widths} from word offsets 0-3, and at "
          f"{big} B; the fold at C = 1 .. 256 and S = 1, 33, 4096: bit-exact")


def record_err(got, want) -> int:
    """Largest word difference over the four parts of a delta record."""
    return max(max_abs_err(g.reshape(-1).view(torch.int32), w.reshape(-1).view(torch.int32))
               if g.dtype != torch.bool else int(bool(g) != bool(w))
               for g, w in zip(got, want))


def ring_bytes(dev) -> int:
    """Bytes from which a 16-byte aligned copy takes the TMA ring of
    memcpy_words and delta_apply_words (one ring per SM)."""
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 132)
    return sms * COPY_STAGES * COPY_CHUNK_WORDS * 4


def delta_kinds(gen, src: torch.Tensor, k: int) -> dict:
    """name -> (offsets, data): the kinds of record ``delta_apply_words``
    must take, around the record ``delta_record_words`` writes for ``k``
    changed words of ``src`` (an ascending prefix and its -1 pads: the
    kernel's fast path); duplicates, pads before or among the entries,
    offsets past the end and a descending record take its general path."""
    from repro_torch.kernels import delta_create

    n, dev = src.numel(), src.device
    pos = torch.randperm(n, generator=gen, device=gen.device)[:k].to(dev)
    changed = src.clone()
    changed.view(torch.int32)[pos] ^= 0x10001
    off, data, _, _ = delta_create.delta_record_words(changed, src, 2 * k)
    asc, dat = off[:k], data[:k]

    def pads(m):
        return torch.full((m,), -1, dtype=torch.int32, device=dev)

    def words(m):
        return rand_words(gen, m, dev)

    dup = asc.clone()
    dup[1::5] = asc[0::5][:dup[1::5].numel()]
    mixed = asc.clone()
    mixed[1::3] = -1
    past = asc.clone()
    past[2::4] = n + torch.arange(past[2::4].numel(), dtype=torch.int32, device=dev)
    far = torch.tensor([0, n // 2, n - 1, -1], dtype=torch.int32, device=dev)
    one = torch.zeros(4, dtype=torch.int32, device=dev)
    one[1:] = -1
    last = one.clone()
    last[0] = n - 1
    return {
        "ascending prefix and pads (delta_record_words)": (off, data),
        "cap = valid entries": (asc, dat),
        "one entry at word 0": (one, words(4)),
        "one entry at word n-1": (last, words(4)),
        "three entries far apart": (far, words(4)),
        "all pads": (pads(k), words(k)),
        "cap 0": (pads(0), words(0)),
        "past the end after the entries": (torch.cat([asc, pads(1) + 1 + n]),
                                           torch.cat([dat, words(1)])),
        "duplicates": (dup, dat),
        "pads first": (torch.cat([pads(k // 4 + 1), asc]), torch.cat([words(k // 4 + 1), dat])),
        "pads among the entries": (mixed, dat),
        "offsets past the end among the entries": (past, dat),
        "descending": (asc.flip(0), dat.view(torch.int32).flip(0).view(torch.uint32)),
    }


@phase("2b slice-2 kernels against their plain versions")
def kernels_vs_plain_2(dev, gen, errs: dict, big_words: int = MiB // 4,
                       delta_big: int = GiB) -> None:
    from repro_torch.kernels import compare, delta_apply, delta_create, dif, fill, ops, ref

    def note(name, err):
        errs[name] = max(errs.get(name, 0), err)
        check(err == 0, f"{name}: kernel disagrees with its plain version (max err {err})")

    counts = sorted({1, 3, 5, 257, 1000, 4099, min(65539, big_words), big_words})
    # fill: ragged counts, the three pattern widths, PE spans 1-4, outputs
    # 1-3 words off 16 bytes (the word-wise route), and counts either side
    # of one and two CTAs of the one-shot grid (FILL_THREADS x
    # FILL_PER_THREAD uint4s, as many words when unaligned)
    cta = fill.FILL_THREADS * fill.FILL_PER_THREAD
    fill_counts = sorted({*counts, cta - 1, cta + 1, 4 * cta - 1, 4 * cta, 4 * cta + 1,
                          8 * cta + 3})
    fill_base = torch.empty(max(fill_counts) + 4, dtype=torch.uint32, device=dev)
    for n in fill_counts:
        for pat in ((0xDEADBEEF,), (1, 0x80000001), (7, 8, 0xFFFFFFFF, 0)):
            want = fill.fill_words_plain(n, pat, device=dev)
            for n_pe in (1, 2, 3, 4):
                note("fill_words", max_abs_err(fill.fill_words(n, pat, n_pe=n_pe, device=dev),
                                               want))
                for start in (1, 2, 3):
                    got = fill.fill_words_into(fill_base[start:start + n], pat, n_pe=n_pe)
                    note("fill_words", max_abs_err(got, want))
    # compare: no difference, at word 0, in the middle, at the last word;
    # an unaligned view (scalar path)
    base = rand_words(gen, big_words + 8, dev)
    for n in counts:
        for start in (0, 1):
            a = base[start:start + n]
            for where in (None, 0, n // 2, n - 1):
                b = a.clone()
                if where is not None:
                    b.view(torch.int32)[where] ^= 1 << (where % 31)
                eq, first = compare.compare_words(a, b)
                peq, pfirst = compare.compare_words_plain(a, b)
                note("compare_words", max_abs_err(first.reshape(1), pfirst.reshape(1))
                     + int(bool(eq) != bool(peq)))
                want = (-1 if where is None else where)
                check(bool(eq) == (where is None) and int(first) == want,
                      f"compare of {n} words with a difference at {where}")
    # delta records: 0, a few (word 0 among them), exactly cap and cap + 1
    # differences, and an overflow far past cap
    for n in (257, 1000, 4099, big_words):
        src = base[:n]
        for n_diff, cap in ((0, 64), (3, 64), (64, 64), (65, 64), (min(n, 5000), 100),
                            (n // 3, n // 2)):
            # word 0 always changes, then n_diff - 1 others
            pos = torch.cat([torch.zeros(min(n_diff, 1), dtype=torch.int64, device=dev),
                             torch.randperm(n - 1, generator=gen, device=gen.device)
                             [:max(n_diff - 1, 0)].to(dev) + 1])
            changed = src.clone()
            changed.view(torch.int32)[pos] ^= 0x10001
            rec = delta_create.delta_record_words(changed, src, cap)
            plain = delta_create.delta_record_words_plain(changed, src, cap)
            note("delta_record_words", record_err(rec, plain))
            check(int(rec[2]) == n_diff and bool(rec[3]) == (n_diff > cap),
                  f"delta count {int(rec[2])} overflow {bool(rec[3])} for {n_diff} > {cap}")
            # apply the record: a round trip when it did not overflow
            out = delta_apply.delta_apply_words(src, rec[0], rec[1])
            note("delta_apply_words", max_abs_err(
                out, delta_apply.delta_apply_words_plain(src, rec[0], rec[1])))
            if n_diff <= cap:
                check(same_bits(out, changed), f"delta round trip, {n_diff} of {n} words")
    # apply: hand-made records with duplicates, -1 pads and offsets past the end
    for n, cap in ((1000, 16), (4099, 4096), (big_words, 65536)):
        ref_words = base[:n]
        off = torch.randint(-n // 8, n + n // 8, (cap,), generator=gen, dtype=torch.int64,
                            device=gen.device).to(torch.int32).to(dev)
        off[: cap // 4] = off[cap // 4: cap // 2]  # duplicates, later ones win
        data = rand_words(gen, cap, dev)
        out = delta_apply.delta_apply_words(ref_words, off, data)
        note("delta_apply_words", max_abs_err(
            out, delta_apply.delta_apply_words_plain(ref_words, off, data)))
        check(same_bits(out, ref.delta_apply_ref(ref_words, off, data)),
              f"delta apply of a hand-made record, cap {cap}")
    # apply: every record kind on both paths of the kernels, at two small
    # sizes (the store route) and at 1 GiB (the ring route; one word less
    # takes the store route)
    paths = set()
    for n, k in ((1000, 37), (4099, 300), (delta_big // 4, delta_big // 1024),
                 (delta_big // 4 - 1, delta_big // 1024)):
        src = base[:n] if n <= base.numel() else rand_words(gen, n, dev)
        route = "ring" if n % 4 == 0 and 4 * n >= ring_bytes(dev) else "store"
        for kind, (off, data) in delta_kinds(gen, src, k).items():
            out = delta_apply.delta_apply_words(src, off, data)
            note("delta_apply_words", max_abs_err(
                out, delta_apply.delta_apply_words_plain(src, off, data)))
            hi, prefix, _ = delta_apply.delta_scan_plain(off.cpu(), n)
            paths.add((route, "fast" if prefix else "general"))
            print(f"  delta_apply_words, {n} words, {kind}: cap {off.numel()}, hi {hi}, "
                  f"{route} route, {'fast' if prefix else 'general'} path, bit-exact")
        del src
    check(len(paths) == 4, f"the record kinds took only {sorted(paths)}")
    # compare, delta create and delta apply (on both of its routes) read
    # nothing back to the host: PyTorch raises on any synchronizing call in
    # this mode
    if dev.type == "cuda":
        ring_src = rand_words(gen, ring_bytes(dev) // 4, dev)
        for src in (base[:big_words], ring_src):
            changed = src.clone()
            changed.view(torch.int32)[::997] += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                ops.compare(src, changed)
                o, d, _, _ = ops.delta_create(changed, src, cap=src.numel() // 500)
                ops.delta_apply(src, o, d)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        del ring_src
    # the ops layer over dtypes: fill_like, compare, delta round trip
    for dtype, shape in ((torch.float32, (513, 130)), (torch.bfloat16, (1000, 6)),
                         (torch.uint32, (big_words,))):
        x = rand_tensor(gen, shape, dtype, dev)
        y = x.clone()
        y.view(-1).view(torch.uint8)[5] ^= 0xFF
        check(bool(ops.compare(x, x)[0]) and int(ops.compare(x, y)[1]) == 1,
              f"ops.compare {dtype}")
        o, d, c, ov = ops.delta_create(y, x, cap=8)
        check(int(c) == 1 and not bool(ov) and same_bits(ops.delta_apply(x, o, d), y),
              f"ops delta round trip {dtype}")
        f = ops.fill_like(x, (0xABABABAB,))
        check(same_bits(f.view(-1).view(torch.uint8),
                        torch.full((x.numel() * x.element_size(),), 0xAB, dtype=torch.uint8,
                                   device=dev)), f"fill_like {dtype}")
    # DIF over 1 MiB of 512-byte blocks, one block corrupted
    words = base[:big_words]
    framed = dif.dif_insert(words, ref_tag=5)
    check(same_bits(host(framed), ref.dif_insert_ref(host(words), ref_tag=5)), "dif_insert")
    check(bool(dif.dif_check(framed).all()), "dif_check of intact blocks")
    bad = framed.clone()
    bad.view(torch.int32)[17, 3] ^= 1
    ok = dif.dif_check(bad)
    check(torch.equal(ok.cpu(), ref.dif_check_ref(host(bad))) and not bool(ok[17])
          and int(ok.sum()) == ok.numel() - 1, "dif_check of a corrupted block")
    check(same_bits(dif.dif_strip(framed), words), "dif_strip")
    check(same_bits(host(dif.dif_update(bad, ref_tag=5))[:, 128:],
                    ref.dif_insert_ref(host(dif.dif_strip(bad)), ref_tag=5)[:, 128:]),
          "dif_update")
    if dev.type == "cuda":
        torch.cuda.synchronize()


# --------------------------------------------------------------------------- phase 3
def _ok(fut, what: str):
    from repro_torch.core import Status

    out = fut.result()
    check(fut.status == Status.SUCCESS, f"{what}: status {fut.status.name} ({fut.error})")
    return out


@phase("3 main path")
def main_path(dev, gen) -> None:
    from repro_torch.core import OpType, WorkDescriptor, make_device
    from repro_torch.kernels import batch_copy, ref

    device = make_device(n_instances=2, policy="least_loaded", device=dev)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(1024, 128)),
                        dtype=torch.float32).to(dev)
    # async memcpy
    fut = device.memcpy_async(x)
    check(same_bits(_ok(fut, "memcpy"), x), "memcpy result")
    print(f"memcpy: {fut.record.bytes_processed} bytes, modeled "
          f"{fut.record.modeled_time_us:.1f} us, status {fut.status.name}")
    # crc32 with a host continuation
    crc_fut = device.crc32_async(x)
    crc_hex = crc_fut.then(lambda c: f"0x{int(c):08x}")
    check(_ok(crc_hex, "crc32.then") == f"0x{ref.crc32_ref(x):08x}", "crc32 .then != zlib")
    _ok(crc_fut, "crc32")
    print(f"crc32: {crc_hex.result()} (matches zlib, via .then)")
    # a promise fence holds the copy back until the host event
    gate = device.promise()
    fenced = device.memcpy_async(x, after=[gate])
    device.kick()
    check(not fenced.done(), "fenced copy ran before its promise")
    gate.set_result(None)
    check(same_bits(_ok(fenced, "fenced memcpy"), x), "fenced memcpy result")
    # F2: 8 same-shape copies fused into one batch_copy launch
    srcs = [torch.full((8, 128), float(i), device=dev) for i in range(8)]
    before = batch_copy.batch_copy_pages.launches
    bfut = device.batch_async([WorkDescriptor(op=OpType.MEMCPY, src=s) for s in srcs])
    outs = _ok(bfut, "batch")
    check(len(outs) == 8 and all(same_bits(o, s) for o, s in zip(outs, srcs)), "batch results")
    fused = batch_copy.batch_copy_pages.launches - before
    check(dev.type != "cuda" or fused == 1, f"batch took {fused} batch_copy launches, not 1")
    print(f"batch: {len(outs)} copies in one submission, {fused} batch_copy_pages launch")
    # fused copy + CRC
    cpy, crc = _ok(device.copy_crc_async(x), "copy_crc")
    check(same_bits(cpy, x) and int(crc) == ref.crc32_ref(x), "copy_crc result")
    # batch copy into a destination pool, duplicates and untouched pages
    src_pool = rand_tensor(gen, (16, 32, 128), torch.bfloat16, dev)
    dst_pool = rand_tensor(gen, (12, 32, 128), torch.bfloat16, dev)
    si = torch.tensor([0, 3, 3, 11, 15, 7], dtype=torch.int32, device=dev)
    di = torch.tensor([5, 2, 7, 0, 5, 9], dtype=torch.int32, device=dev)
    want = ref.batch_copy_ref(src_pool, dst_pool, si, di)
    got = _ok(device.batch_copy_async(src_pool, dst_pool, si, di), "batch_copy")
    check(same_bits(got, want), "batch_copy result")
    # one fused-doorbell burst of 32
    burst = [rand_tensor(gen, (64, 64), torch.float32, dev) for _ in range(32)]
    futs = device.submit_many([WorkDescriptor(op=OpType.MEMCPY, src=b) for b in burst])
    check(len(futs) == 32, "submit_many futures")
    for f, b in zip(futs, burst):
        check(same_bits(_ok(f, "submit_many"), b), "submit_many result")
    device.drain()
    print(f"policy={device.policy_stats['policy']} "
          f"placements={dict(device.policy_stats['decisions'])}")


# --------------------------------------------------------------------------- phase 4
@phase("4 main path at real sizes")
def real_sizes(dev, gen, sizes=(4 * KiB, MiB, 64 * MiB, GiB), leaf_bytes=256 * MiB,
               pool_pages=4096, n_pages=1024, page_bytes=16 * KiB) -> dict:
    from repro_torch.core import OpType, WorkDescriptor, make_device
    from repro_torch.kernels import ref

    device = make_device(n_instances=2, policy="least_loaded", device=dev)
    shapes = {}
    for nbytes in sizes:
        x = rand_words(gen, nbytes // 4, dev)
        y = _ok(device.memcpy_async(x), f"memcpy {nbytes} B")
        check(same_bits(y, x), f"memcpy {nbytes} B result")
        del y
        crc = _ok(device.crc32_async(x), f"crc32 {nbytes} B")
        check(int(crc) == ref.crc32_ref(x), f"crc32 {nbytes} B != zlib")
        print(f"memcpy + crc32 of {nbytes} B: ok")
        del x
    # a checkpoint leaf: one bf16 weight matrix of 256 MiB
    cols = 8192
    leaf = rand_tensor(gen, (leaf_bytes // 2 // cols, cols), torch.bfloat16, dev)
    cpy, crc = _ok(device.copy_crc_async(leaf), "copy_crc leaf")
    check(same_bits(cpy, leaf) and int(crc) == ref.crc32_ref(leaf), "copy_crc leaf result")
    print(f"copy_crc of a {tuple(leaf.shape)} bf16 leaf: ok")
    del cpy, leaf
    # DPDK's default burst: 32 mbufs with 2 KiB data rooms (paper: Vhost)
    mbufs = [rand_words(gen, 2 * KiB // 4, dev).view(torch.uint8) for _ in range(32)]
    outs = _ok(device.batch_async([WorkDescriptor(op=OpType.MEMCPY, src=m) for m in mbufs]),
               "vhost burst")
    check(all(same_bits(o, m) for o, m in zip(outs, mbufs)), "vhost burst results")
    print("batch of 32 x 2 KiB: ok")
    # paged KV-style swap: 1024 pages of 16 KiB within a 4096-page pool
    pw = page_bytes // 4
    src_pool = rand_words(gen, pool_pages * pw, dev).view(pool_pages, pw)
    dst_pool = rand_words(gen, pool_pages * pw, dev).view(pool_pages, pw)
    si = torch.randint(0, pool_pages, (n_pages,), generator=gen, dtype=torch.int32,
                       device=gen.device).to(dev)
    di = torch.randperm(pool_pages, generator=gen, device=gen.device)[:n_pages] \
        .to(torch.int32).to(dev)
    want = dst_pool.clone()
    want.view(torch.int32).index_copy_(0, di.long(), src_pool.view(torch.int32)[si.long()])
    got = _ok(device.batch_copy_async(src_pool, dst_pool, si, di), "page swap")
    check(same_bits(got, want), "page swap result")
    print(f"batch_copy of {n_pages} x {page_bytes} B pages in a {pool_pages}-page pool: ok")
    device.drain()
    shapes.update(pool=(src_pool, dst_pool, si, di))
    return shapes


# --------------------------------------------------------------------------- phases 3b and 4b
@phase("3b slice-2 main path")
def main_path_2(dev, gen) -> None:
    """The whole quickstart (delta section included), fill, compare, DIF and
    cache-flush descriptors, and the ``dto`` layer under ``dto_enabled``."""
    from repro_torch.core import OpType, WorkDescriptor, dto, dto_enabled, make_device
    from repro_torch.kernels import ref
    from repro_torch.kernels.ref import int32_bits

    device = make_device(n_instances=2, policy="least_loaded", device=dev)
    rng = np.random.default_rng(0)
    # --- async memcpy
    x = torch.as_tensor(rng.normal(size=(1024, 128)), dtype=torch.float32).to(dev)
    fut = device.memcpy_async(x)
    check(same_bits(_ok(fut, "memcpy"), x), "memcpy result")
    # --- chaining: a host continuation when the CRC retires
    crc_hex = device.crc32_async(x).then(lambda c: f"0x{int(c):08x}")
    check(_ok(crc_hex, "crc32.then") == f"0x{ref.crc32_ref(x):08x}", "crc32 .then != zlib")
    # --- dependency fences
    gate = device.promise()
    fenced = device.memcpy_async(x, after=[gate])
    device.kick()
    check(not fenced.done(), "fenced copy ran before its promise")
    gate.set_result(None)
    check(same_bits(_ok(fenced, "fenced memcpy"), x), "fenced memcpy result")
    # --- delta records (incremental state)
    base_np = np.random.default_rng(1).integers(0, 2**31, 4096).astype(np.int32)
    base = torch.from_numpy(base_np).view(torch.uint32).to(dev)
    changed = base.clone()
    changed.view(torch.int32)[torch.tensor([7, 99, 2048], device=dev)] += 1
    offsets, data, count, overflow = _ok(device.delta_create_async(changed, base, cap=64),
                                         "delta_create")
    restored = device.delta_apply(base, offsets, data)
    check(same_bits(restored, changed), "delta round trip")
    check(int(count) == 3 and not bool(overflow), "delta count")
    print(f"delta: {int(count)} changed words, overflow={bool(overflow)}; roundtrip exact")
    # --- batch descriptor
    descs = [WorkDescriptor(op=OpType.MEMCPY, src=torch.full((8, 128), float(i), device=dev))
             for i in range(8)]
    outs = _ok(device.batch_async(descs), "batch")
    check(all(same_bits(o, d.src) for o, d in zip(outs, descs)), "batch results")
    # --- fill, compare, DIF and cache flush descriptors
    filled = _ok(device.fill_async([1, 2, 3, 4], 1000), "fill")
    check(same_bits(filled, ref.fill_ref((1000,), (1, 2, 3, 4), device=dev)), "fill result")
    y = x.clone()
    y.view(-1)[77] += 1
    eq, first = _ok(device.compare_async(x, y), "compare")
    check(not bool(eq) and int(first) == 77, "compare result")
    check(bool(device.compare(x, x.clone())[0]), "compare of equal buffers")
    words = base  # 4096 words: 32 blocks of 512 bytes
    framed = _ok(device.dif_insert_async(words), "dif_insert")
    check(same_bits(host(framed), ref.dif_insert_ref(host(words))), "dif_insert result")
    bad = framed.clone()
    bad.view(torch.int32)[3, 0] ^= 1
    ok = _ok(device.dif_check_async(bad), "dif_check")
    check(torch.equal(ok.cpu(), ref.dif_check_ref(host(bad))), "dif_check result")
    check(same_bits(_ok(device.dif_strip_async(framed), "dif_strip"), words), "dif_strip")
    flush = device.submit(WorkDescriptor(op=OpType.CACHE_FLUSH, src=words))
    check(_ok(flush, "cache_flush") == (), "cache_flush result")
    # --- dto: the drop-in memcpy/memset/memcmp layer
    with dto_enabled(device, min_bytes=8192):
        big = rand_tensor(gen, (64, 128), torch.float32, dev)  # 32 KiB: offloaded
        small = big[:4]  # 2 KiB: plain PyTorch
        check(same_bits(dto.memcpy(big), big) and same_bits(dto.memcpy(small), small),
              "dto.memcpy")
        set_big = dto.memset(big, 0xAB)
        check(bool((set_big.view(torch.int32) == int32_bits(0xABABABAB)).all()), "dto.memset bytes")
        check(bool((dto.memset(small, 0xAB) == 171.0).all()), "dto.memset below threshold")
        check(dto.memcmp(big, big.clone()) and not dto.memcmp(big, set_big), "dto.memcmp")
    device.drain()
    check(device.policy_stats["desclint_warnings"] == 0, "desclint warned on the flow")
    print(f"policy={device.policy_stats['policy']} "
          f"placements={dict(device.policy_stats['decisions'])}")


def drifted(gen, leaf_words: torch.Tensor, frac: float):
    """A copy of ``leaf_words`` with ``frac`` of its words changed (distinct
    positions), and how many."""
    n = leaf_words.numel()
    k = int(n * frac)
    pos = torch.randperm(n, generator=gen, device=gen.device)[:k].to(leaf_words.device)
    out = leaf_words.clone()
    out.view(torch.int32)[pos] ^= 0x00010001
    return out, k


@phase("4b slice-2 main path at real sizes")
def real_sizes_2(dev, gen, errs: dict, sizes=(4 * KiB, MiB, 64 * MiB, GiB),
                 leaf_bytes=256 * MiB, drift=0.005, cap_frac=0.25, dto_bytes=64 * MiB,
                 dif_bytes=MiB) -> dict:
    from repro_torch.core import dto, dto_enabled, make_device
    from repro_torch.kernels import delta_create, fill, ref

    device = make_device(n_instances=2, policy="least_loaded", device=dev)
    shapes = {}
    # fill and compare at the paper's sizes; compare hits its worst case
    # (equal buffers, every word read) and then a difference at the last word
    for nbytes in sizes:
        n = nbytes // 4
        f = _ok(device.fill_async([0x5A5A5A5A, 7], n), f"fill {nbytes} B")
        check(same_bits(f, fill.fill_words_plain(n, (0x5A5A5A5A, 7), device=dev)),
              f"fill {nbytes} B result")
        g = f.clone()
        eq, first = _ok(device.compare_async(f, g), f"compare {nbytes} B")
        check(bool(eq) and int(first) == -1, f"compare {nbytes} B of equal buffers")
        g.view(torch.int32)[-1] ^= 1
        eq, first = _ok(device.compare_async(f, g), f"compare {nbytes} B")
        check(not bool(eq) and int(first) == n - 1, f"compare {nbytes} B, last word")
        print(f"fill + compare of {nbytes} B: ok")
        del f, g
    # a checkpoint leaf (bf16 [16384, 8192], 256 MiB): 0.5 % of its words
    # drift between two checkpoints, the record holds 25 % of its words
    cols = 8192
    leaf = rand_tensor(gen, (leaf_bytes // 2 // cols, cols), torch.bfloat16, dev)
    lw = leaf.view(-1).view(torch.uint32)
    new_w, k = drifted(gen, lw, drift)
    new = new_w.view(torch.bfloat16).view(leaf.shape)
    cap = int(lw.numel() * cap_frac)
    offsets, data, count, overflow = _ok(device.delta_create_async(new, leaf, cap=cap),
                                         "delta_create leaf")
    check(int(count) == k and not bool(overflow), f"leaf delta count {int(count)} != {k}")
    # the record itself, entry for entry, against the plain version
    err = record_err((offsets, data, count, overflow),
                     delta_create.delta_record_words_plain(new_w, lw, cap))
    errs["delta_record_words"] = max(errs.get("delta_record_words", 0), err)
    check(err == 0, f"leaf delta record disagrees with the plain version (max err {err})")
    restored = _ok(device.delta_apply_async(leaf, offsets, data), "delta_apply leaf")
    check(same_bits(restored, new), "leaf not restored bit for bit")
    print(f"delta of a {tuple(leaf.shape)} bf16 leaf: {k} words changed, cap {cap}; "
          f"restored bit for bit")
    shapes["delta"] = (lw, new_w, cap, offsets, data)
    del restored
    # dto of 64 MiB
    with dto_enabled(device):
        buf = rand_tensor(gen, (dto_bytes // 4,), torch.float32, dev)
        check(same_bits(dto.memcpy(buf), buf), "dto.memcpy 64 MiB")
        z = dto.memset(buf, 0)
        check(not bool(z.view(torch.int32).any()), "dto.memset 64 MiB")
        check(dto.memcmp(buf, buf.clone()) and not dto.memcmp(buf, z), "dto.memcmp 64 MiB")
        print(f"dto memcpy/memset/memcmp of {dto_bytes} B: ok")
        del buf, z
    # DIF over 1 MiB of 512-byte blocks
    words = rand_words(gen, dif_bytes // 4, dev)
    framed = _ok(device.dif_insert_async(words), "dif_insert 1 MiB")
    check(same_bits(host(framed), ref.dif_insert_ref(host(words))), "dif_insert 1 MiB")
    check(bool(_ok(device.dif_check_async(framed), "dif_check 1 MiB").all()), "dif_check 1 MiB")
    check(same_bits(_ok(device.dif_strip_async(framed), "dif_strip 1 MiB"), words),
          "dif_strip 1 MiB")
    print(f"DIF insert/check/strip of {dif_bytes} B in {framed.shape[0]} blocks: ok")
    shapes["dif"] = words.view(-1, 128)
    device.drain()
    return shapes


# --------------------------------------------------------------------------- phase 2c
def _pair_err(got, want) -> int:
    """Difference of two (equal?, first | -1) pairs: 0 when they agree."""
    return abs(int(got[1]) - int(want[1])) + int(bool(got[0]) != bool(want[0]))


@phase("2c slice-3 kernels against their plain versions")
def kernels_vs_plain_3(dev, gen, errs: dict,
                       counts=(1, 127, 129, 4 * KiB // 4, MiB // 4, 64 * MiB // 4)) -> None:
    from repro_torch.kernels import compare, dualcast, fill, fused

    def note(name, err):
        errs[name] = max(errs.get(name, 0), err)
        check(err == 0, f"{name}: kernel disagrees with its plain version (max err {err})")

    wrappers = (dualcast.dualcast_words, compare.compare_pattern_words, fused.fill_verify_words)
    before = [w.launches for w in wrappers]
    base = rand_words(gen, max(counts) + 1, dev)
    for n in counts:
        # dualcast: aligned, and an unaligned view (the scalar path)
        for src in (base[:n], base[1:n + 1]):
            a, b = dualcast.dualcast_words(src)
            pa, pb = dualcast.dualcast_words_plain(src)
            note("dualcast_words", max(max_abs_err(a, pa), max_abs_err(b, pb)))
            check(same_bits(a, src) and same_bits(b, src), f"dualcast of {n} words")
        for pat in ((0xDEADBEEF,), (1, 0x80000001), (7, 8, 0xFFFFFFFF, 0)):
            # compare-pattern: no mismatch, at word 0, at the last word, at a
            # random word, in every word; an unaligned view of the same words
            filled = fill.fill_words(n, pat, device=dev)
            rnd = int(torch.randint(0, n, (1,), generator=gen, device=gen.device))
            for where in (None, 0, n - 1, rnd, "every"):
                x = filled.clone()
                if where == "every":
                    x.view(torch.int32).bitwise_xor_(0x00010001)
                elif where is not None:
                    x.view(torch.int32)[where] ^= 1 << (where % 31)
                want = -1 if where is None else 0 if where == "every" else where
                got = compare.compare_pattern_words(x, pat)
                note("compare_pattern_words",
                     _pair_err(got, compare.compare_pattern_words_plain(x, pat)))
                check(bool(got[0]) == (where is None) and int(got[1]) == want,
                      f"compare_pattern of {n} words, mismatch at {where}: {int(got[1])}")
            # an unaligned view of the same words (the scalar path), its
            # last word changed
            y = torch.empty(n + 1, dtype=torch.uint32, device=dev)
            y[1:] = filled
            y.view(torch.int32)[n] ^= 1
            got = compare.compare_pattern_words(y[1:], pat)
            note("compare_pattern_words",
                 _pair_err(got, compare.compare_pattern_words_plain(y[1:], pat)))
            check(not bool(got[0]) and int(got[1]) == n - 1,
                  f"compare_pattern of an unaligned view of {n} words")
            # fill-verify: its buffer is fill_words's, its pair the kernel
            # compare_pattern_words's on that buffer
            f, ok, first = fused.fill_verify_words(n, pat, device=dev)
            pf, pok, pfirst = fused.fill_verify_words_plain(n, pat, device=dev)
            note("fill_verify_words", max(max_abs_err(f, pf), _pair_err((ok, first), (pok, pfirst))))
            check(same_bits(f, filled), f"fill_verify buffer of {n} words != fill_words")
            check(_pair_err((ok, first), compare.compare_pattern_words(f, pat)) == 0
                  and bool(ok) and int(first) == -1, f"fill_verify pair of {n} words")
    after = [w.launches for w in wrappers]
    check(dev.type != "cuda" or all(a > b for a, b in zip(after, before)),
          f"slice-3 launch counts {before} -> {after}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        loads = readback_loads()
        check(len(loads) >= 2, f"fill_verify_kernel has {len(loads)} global loads, not the "
                               f"vector and scalar readbacks")
        print(f"fill_verify_kernel reads back with {len(loads)} global loads: "
              + "; ".join(loads))


def readback_loads() -> list:
    """The global loads (SASS ``LDG``) in the built ``fill_verify_kernel``,
    read with the toolkit's cuobjdump.  The kernel reads nothing from global
    memory but the words it has just stored (its scratch goes through
    atomics), so each load is a readback the compiler kept."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_build.library_path())], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    body = next(c for c in sass.split("Function : ")[1:]
                if "fill_verify_kernel" in c.split("\n", 1)[0])
    # a SASS line: /*0150*/  LDG.E.128.STRONG.SYS R4, desc[UR6][R2.64] ;  /* 0x.. */
    return [line.split("*/", 1)[1].split(";")[0].strip()
            for line in body.splitlines() if re.search(r"\bLDG\b", line)]


# --------------------------------------------------------------------------- phases 3c and 4c
def model_tree(gen, dev, *, d_model, n_heads, n_kv_heads, head_dim, d_ff, vocab, n_layers):
    """A decoder's parameters (bf16, in the JAX package's names: embed,
    final_norm, unembed, and per layer ln1, ln2, attn/wq wk wv wo, mlp/w1 w3
    w2) with fp32 AdamW moments and an int32 step, as launch/train.py saves
    them: {"params": ..., "opt": AdamWState}.  Values from ``gen``."""
    from repro_torch.optim.adamw import AdamWState

    D, H, KV, hd, F, V = d_model, n_heads, n_kv_heads, head_dim, d_ff, vocab

    def normal(*shape, scale=0.02, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def layer():
        return {"ln1": normal(D), "ln2": normal(D),
                "attn": {"wq": normal(D, H * hd), "wk": normal(D, KV * hd),
                         "wv": normal(D, KV * hd), "wo": normal(H * hd, D)},
                "mlp": {"w1": normal(D, F), "w3": normal(D, F), "w2": normal(F, D)}}

    params = {"embed": normal(V, D), "final_norm": normal(D),
              "layers": [layer() for _ in range(n_layers)], "unembed": normal(D, V)}
    from repro_torch import tree as ttree

    m = ttree.tree_map(lambda p: normal(*p.shape, scale=1e-3, dtype=torch.float32), params)
    v = ttree.tree_map(lambda p: normal(*p.shape, scale=1e-6, dtype=torch.float32).abs(), params)
    step = torch.tensor(100, dtype=torch.int32, device=dev)
    return {"params": params, "opt": AdamWState(step=step, m=m, v=v)}


def drift_tree(gen, tree, frac: float):
    """``tree`` with ``frac`` of each leaf's words changed (distinct
    positions) and the step advanced: the drift between two checkpoints."""
    from repro_torch import tree as ttree

    def drift(x):
        if x.dim() == 0:
            return x + 1
        w, _ = drifted(gen, x.reshape(-1).view(torch.uint32), frac)
        return w.view(x.dtype).view(x.shape)

    return ttree.tree_map(drift, tree)


def flip_tree(tree):
    """Every word of every leaf changed: a save whose records all overflow."""
    from repro_torch import tree as ttree

    def flip(x):
        if x.dim() == 0:
            return x + 1
        w = x.reshape(-1).view(torch.int32) ^ 0x00010001
        return w.view(x.dtype).view(x.shape)

    return ttree.tree_map(flip, tree)


def tree_crcs(tree) -> dict:
    """zlib CRC of each leaf's bytes, by the checkpoint's leaf name."""
    from repro_torch import tree as ttree

    return {k: zlib.crc32(memoryview(x.contiguous().reshape(-1).view(torch.uint8).cpu().numpy()))
            & 0xFFFFFFFF for k, x in ttree.flatten_with_names(tree)}


def check_manifest(directory: Path, step: int, crcs: dict) -> dict:
    """The manifest of ``step``: every leaf's CRC is zlib's of its final
    contents, a full leaf's file has that CRC, and a delta record's payload
    CRC is zlib's of its offsets and words."""
    d = directory / f"step_{step:08d}"
    man = json.loads((d / "manifest.json").read_text())
    check(set(man["leaves"]) == set(crcs), f"step {step}: leaf names")
    for key, e in man["leaves"].items():
        fn = key.replace("/", "__")
        check(e["crc"] == crcs[key], f"step {step} {key}: manifest CRC != zlib")
        if e["mode"] == "full":
            check(zlib.crc32((d / f"{fn}.bin").read_bytes()) & 0xFFFFFFFF == e["crc"],
                  f"step {step} {key}: file CRC")
        elif e["mode"] == "delta":
            z = np.load(d / f"{fn}.delta.npz")
            payload = z["offsets"].tobytes() + z["data"].tobytes()
            check(zlib.crc32(payload) & 0xFFFFFFFF == e["payload_crc"],
                  f"step {step} {key}: payload CRC")
    return man


def check_restored(got, want, dev, what: str) -> None:
    from repro_torch import tree as ttree

    lg, tg = ttree.flatten(got)
    lw, tw = ttree.flatten(want)
    check(tg == tw, f"{what}: tree structure")
    for g, w in zip(lg, lw):
        check(g.device.type == "cpu" and same_bits(g.to(dev), w), f"{what}: a leaf differs")


def checkpoint_cycle(device, gen, dev, tree, directory: Path, *, drift=0.005) -> dict:
    """launch/train.py's save path with crc_impl="kernel" on ``device`` and a
    replica: full save, two delta saves at ``drift``, an overflowing save,
    the newest primary corrupted, then restored from the replica.  Returns
    the seconds of each step."""
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager

    shutil.rmtree(directory, ignore_errors=True)
    shutil.rmtree(str(directory) + "-replica", ignore_errors=True)
    mgr = CheckpointManager(CheckpointConfig(directory=str(directory), full_every=100,
                                             replicas=2, async_save=True, crc_impl="kernel"),
                            device=device)
    trees = {1: tree}
    trees[2] = drift_tree(gen, trees[1], drift)
    trees[3] = drift_tree(gen, trees[2], drift)
    trees[4] = flip_tree(trees[3])
    secs = {}
    modes = {}
    for step in (1, 2, 3, 4):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        mgr.save(step, trees[step])
        mgr.wait()
        secs[f"save_{step}_s"] = time.perf_counter() - t0
        man = check_manifest(directory, step, tree_crcs(trees[step]))
        modes[step] = sorted({e["mode"] for e in man["leaves"].values()})
    check(modes[1] == ["full"] and "delta" in modes[2] and "delta" in modes[3]
          and "full" in modes[4] and mgr.stats["delta_overflows"] > 0,
          f"save modes {modes}, stats {mgr.stats}")
    # a delta step restores bit for bit
    t0 = time.perf_counter()
    s, got = mgr.restore(3, treedef_like=tree)
    secs["restore_delta_s"] = time.perf_counter() - t0
    check(s == 3, f"restore(3) gave step {s}")
    check_restored(got, trees[3], dev, "delta restore")
    del got
    # corrupt the newest primary: the replica's copy of step 4 restores
    target = sorted((directory / "step_00000004").glob("*.bin"))[0]
    raw = bytearray(target.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    target.write_bytes(bytes(raw))
    t0 = time.perf_counter()
    s, got = mgr.restore(treedef_like=tree)
    secs["restore_replica_s"] = time.perf_counter() - t0
    check(s == 4, f"restore after corrupting the primary fell back to step {s}, not the replica")
    check_restored(got, trees[4], dev, "replica restore")
    print(f"checkpoint: modes {modes}, stats {mgr.stats}, "
          + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    shutil.rmtree(directory, ignore_errors=True)
    shutil.rmtree(str(directory) + "-replica", ignore_errors=True)
    return secs


def offload_round_trip(device, tree) -> None:
    from repro_torch import tree as ttree
    from repro_torch.optim.offload import MomentOffloader, plan

    opt = tree["opt"]
    off = MomentOffloader(device)
    back = off.fetch(off.offload(opt))
    for a, b in zip(ttree.leaves((opt.m, opt.v)), ttree.leaves((back.m, back.v))):
        check(same_bits(a, b), "moment offload round trip")
    nbytes = sum(x.numel() * x.element_size() for x in ttree.leaves((opt.m, opt.v)))
    check(off.stats["bytes_moved"] == 2 * nbytes, f"offload bytes_moved {off.stats}")
    p = plan(opt)
    print(f"moment offload: {nbytes} B of moments, there and back; plan: "
          f"{p.transfer_s_per_step * 1e3:.3f} ms a step (perfmodel, not measured)")


def slice3_ops(device, gen, dev, sizes) -> None:
    """Dualcast, compare-pattern and fill-verify descriptors at ``sizes``
    bytes, each against its expected result."""
    from repro_torch.kernels import fill

    for nbytes in sizes:
        n = nbytes // 4
        x = rand_words(gen, n, dev)
        a, b = _ok(device.dualcast_async(x), f"dualcast {nbytes} B")
        check(same_bits(a, x) and same_bits(b, x) and a.data_ptr() != b.data_ptr(),
              f"dualcast {nbytes} B result")
        del a, b, x
        pat = (0x5A5A5A5A, 7, 0xFFFFFFFF, 0)
        filled, (ok, first) = _ok(device.fill_verify_async(pat, n), f"fill_verify {nbytes} B")
        check(bool(ok) and int(first) == -1, f"fill_verify {nbytes} B pair")
        check(same_bits(filled, fill.fill_words_plain(n, pat, device=dev)),
              f"fill_verify {nbytes} B buffer")
        eq, first = _ok(device.compare_pattern_async(filled, pat), f"compare_pattern {nbytes} B")
        check(bool(eq) and int(first) == -1, f"compare_pattern {nbytes} B of the pattern")
        filled.view(torch.int32)[n - 1] ^= 1
        eq, first = _ok(device.compare_pattern_async(filled, pat), f"compare_pattern {nbytes} B")
        check(not bool(eq) and int(first) == n - 1, f"compare_pattern {nbytes} B, last word")
        print(f"dualcast + fill_verify + compare_pattern of {nbytes} B: ok")
        del filled


@phase("3c slice-3 main path")
def main_path_3(dev, gen) -> None:
    from repro_torch.core import make_device

    device = make_device(n_instances=2, policy="least_loaded", device=dev, validate="strict")
    tree = model_tree(gen, dev, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=160,
                      vocab=512, n_layers=2)
    slice3_path(device, gen, dev, tree, (4 * KiB, 4 * KiB + 4 * 129), CKPT_DIR / "small")
    print(f"policy={device.policy_stats['policy']} "
          f"placements={dict(device.policy_stats['decisions'])}")


def slice3_path(device, gen, dev, tree, sizes, directory: Path) -> dict:
    """The new ops at ``sizes``, the moment offload of ``tree``'s AdamW
    state and the checkpoint cycle of ``tree``; desclint (strict) finds
    nothing but DESC105 on the offload's batches."""
    lint = lambda: device.policy_stats["desclint_warnings"]  # noqa: E731
    slice3_ops(device, gen, dev, sizes)
    check(lint() == 0, f"desclint warned {lint()} times on the slice-3 ops")
    offload_round_trip(device, tree)
    n_offload = lint()
    # DESC105 (a warning): each tree's leaves differ in shape, so its MEMCPY
    # batch runs per descriptor instead of fusing, as in the JAX package
    check(n_offload <= 4, f"desclint warned {n_offload} times on 2 offload round trips")
    secs = checkpoint_cycle(device, gen, dev, tree, directory)
    device.drain()
    check(lint() == n_offload, "desclint warned on the checkpoint's descriptors")
    print(f"desclint (strict): {n_offload} DESC105 warnings on the offload's batches, "
          f"none elsewhere")
    return secs


@phase("4c slice-3 main path at real width")
def real_sizes_3(dev, gen, sizes=(4 * KiB, MiB, 64 * MiB, GiB)) -> dict:
    from repro_torch import tree as ttree
    from repro_torch.core import make_device

    device = make_device(n_instances=2, policy="least_loaded", device=dev, validate="strict")
    cfg = dict(TINYLLAMA, n_layers=TINYLLAMA_LAYERS_KEPT)
    tree = model_tree(gen, dev, **cfg)
    n_params = sum(x.numel() for x in ttree.leaves(tree["params"]))
    n_bytes = sum(x.numel() * x.element_size() for x in ttree.leaves(tree))
    print(f"tinyllama-1.1b, {TINYLLAMA_LAYERS_KEPT} of {TINYLLAMA['n_layers']} layers: "
          f"{n_params} params, {n_bytes} B a save")
    secs = slice3_path(device, gen, dev, tree, sizes, CKPT_DIR / "tinyllama")
    return dict(secs, params=n_params, tree_bytes=n_bytes)


# --------------------------------------------------------------------------- phase 2d
#: B, Sq, Skv, H, KV, hd, causal, window, n_meta, dtype
FLASH_CASES = (
    (1, 1, 1, 8, 4, 32, True, 0, 0, torch.float32),
    (2, 77, 77, 8, 8, 64, True, 0, 0, torch.bfloat16),
    (1, 77, 77, 8, 1, 128, False, 0, 0, torch.float32),
    (1, 77, 77, 4, 2, 32, True, 16, 4, torch.bfloat16),
    (1, 1000, 1000, 16, 2, 64, True, 0, 0, torch.bfloat16),
    (1, 1000, 1000, 4, 2, 256, True, 128, 0, torch.float32),
    (1, 2048, 2048, 32, 4, 64, True, 0, 0, torch.bfloat16),
    # phase 4e(i)'s training shape: batch 8 of full 64-row tiles
    (8, 2048, 2048, 32, 4, 64, True, 0, 0, torch.bfloat16),
    (1, 2048, 2048, 8, 4, 128, True, 512, 16, torch.bfloat16),
    (1, 2048, 2048, 4, 4, 256, False, 0, 0, torch.bfloat16),
    (1, 2048, 2048, 4, 1, 32, True, 0, 0, torch.float32),
    (1, 300, 100, 4, 2, 64, True, 32, 0, torch.float32),
    (1, 300, 100, 4, 2, 64, False, 32, 0, torch.bfloat16),
    # Sq > Skv with a window and a meta prefix: late rows see only the meta keys
    (1, 300, 100, 4, 2, 64, True, 32, 4, torch.bfloat16),
    (1, 300, 100, 4, 2, 64, True, 32, 4, torch.float32),
    # the bf16 kernel's tile edges (64 rows, 64 keys; 32 keys at hd 256) and
    # B = 2 with a ragged Skv (a box past the tail must not read the next
    # batch's rows); every head dim in bf16 with G = 1, 4 and 8
    (1, 63, 63, 4, 4, 32, True, 0, 0, torch.bfloat16),
    (1, 64, 64, 8, 2, 32, False, 0, 0, torch.bfloat16),
    (2, 65, 65, 8, 1, 32, True, 0, 0, torch.bfloat16),
    (1, 129, 129, 2, 2, 64, True, 0, 0, torch.bfloat16),
    (1, 63, 63, 8, 2, 64, False, 0, 0, torch.bfloat16),
    (2, 100, 100, 8, 1, 64, True, 0, 0, torch.bfloat16),
    (1, 64, 64, 4, 4, 128, True, 0, 0, torch.bfloat16),
    (2, 129, 129, 8, 2, 128, True, 40, 3, torch.bfloat16),
    (1, 65, 65, 8, 1, 128, False, 0, 0, torch.bfloat16),
    (2, 77, 77, 2, 2, 256, True, 0, 0, torch.bfloat16),
    (1, 129, 129, 8, 2, 256, True, 0, 0, torch.bfloat16),
    (2, 100, 100, 8, 1, 256, False, 0, 0, torch.bfloat16),
    # the slice-9 prefill shapes: gemma3-1b's local layers (hd 256, a
    # 1024-key window cutting the 32-key tiles) and qwen2-vl-2b's (hd 128)
    (1, 2048, 2048, 4, 1, 256, True, 1024, 0, torch.bfloat16),
    (2, 2048, 2048, 12, 2, 128, True, 0, 0, torch.bfloat16),
    # gemma3-1b's global layers (causal, no window, 64 key tiles at hd 256)
    # and its local layers at the 1536-token prompt (the window cuts
    # another tile)
    (1, 2048, 2048, 4, 1, 256, True, 0, 0, torch.bfloat16),
    (1, 1536, 1536, 4, 1, 256, True, 1024, 0, torch.bfloat16),
    # slice 10: deepseek-moe-16b's prefill (MHA, 16 heads of 128) at 2048
    # tokens and at the 333-token prompt (a partial last tile)
    (1, 2048, 2048, 16, 16, 128, True, 0, 0, torch.bfloat16),
    (1, 333, 333, 16, 16, 128, True, 0, 0, torch.bfloat16),
    # slice 11: hymba-1.5b's prefill, 25 query heads over 5 KV heads (a group
    # of 5) behind 128 meta tokens (two whole 64-key tiles): a local layer
    # (window 1024) and a global one (window 0, n_meta passed as the model
    # does) at 2048 + 128 positions, the 333-token prompt's local layer
    # (the window longer than the sequence), and f32 at a group of 5 with a
    # ragged tail
    (1, 2176, 2176, 25, 5, 64, True, 1024, 128, torch.bfloat16),
    (1, 2176, 2176, 25, 5, 64, True, 0, 128, torch.bfloat16),
    (1, 461, 461, 25, 5, 64, True, 1024, 128, torch.bfloat16),
    (2, 200, 200, 25, 5, 64, True, 64, 128, torch.float32),
)


def flash_inputs(gen, dev, B, Sq, Skv, H, KV, hd, dtype):
    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    return normal(B, Sq, H, hd), normal(B, Skv, KV, hd), normal(B, Skv, KV, hd)


@phase("2d flash attention against its plain version")
def kernels_vs_plain_4(dev, gen, errs: dict) -> None:
    from repro_torch.kernels import flash_attention as fa

    worst = 0.0
    for B, Sq, Skv, H, KV, hd, causal, window, n_meta, dtype in FLASH_CASES:
        q, k, v = flash_inputs(gen, dev, B, Sq, Skv, H, KV, hd, dtype)
        kw = dict(causal=causal, window=window, n_meta=n_meta)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        sync(dev)
        what = (f"flash_attention B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} hd={hd} "
                f"causal={causal} window={window} n_meta={n_meta} {dtype}")
        check(got.dtype == dtype and got.shape == q.shape, f"{what}: {got.dtype} {got.shape}")
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        worst = max(worst, err)
        ok = torch.allclose(got.float(), want.float(), **FLASH_TOL[dtype])
        print(f"  {what}: max |err| {err:.3e}")
        check(ok, f"{what}: kernel disagrees with its plain version (max err {err})")
    errs["flash_attention"] = worst


# --------------------------------------------------------------------------- phases 3d and 4d
def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def release(dev) -> None:
    """Return what earlier phases freed to the card before a full-size
    phase measures or allocates, and hold that no reference cycle kept any
    of it: the collector must free nothing on the card, or a phase's
    tensors would outlive it until the collector happened to run."""
    sync(dev)
    held = torch.cuda.memory_allocated(dev)
    gc.collect()
    sync(dev)
    freed = held - torch.cuda.memory_allocated(dev)
    check(freed == 0, f"the collector freed {freed} B on the card: a reference cycle held "
          f"tensors of an earlier phase")
    torch.cuda.empty_cache()


def pin_admission(device):
    """Wait for each prompt copy burst as it is submitted, so the server
    admits each request in the step after its copies went out, on the card
    as on the CPU.  An MoE's capacity at decode makes a request's tokens
    depend on which requests share its decode steps (ROADMAP.md, held for
    parity), so two servers serve the same tokens only if they admit at the
    same steps.  The wrapper holds the device weakly, so it makes no
    reference cycle."""
    submit = weakref.WeakMethod(device.batch_async)

    def batch_async(*a, **kw):
        fut = submit()(*a, **kw)
        fut.wait()
        return fut

    device.batch_async = batch_async
    return device


def serve(model, params, device, prompts, *, slots, max_cache, max_new, max_steps=2000,
          wrap_decode=None, kv_pool=None, pin=False):
    """Serve ``prompts`` through a VhostStyleServer; every request must
    complete with ``max_new`` tokens.  ``wrap_decode`` wraps the server's
    decode step; ``pin`` pins admission (``pin_admission``).  Returns
    (requests, server, seconds)."""
    from repro_torch.serving.pipeline import Request, VhostStyleServer

    server = VhostStyleServer(model, params, slots=slots, max_cache_len=max_cache,
                              device=pin_admission(device) if pin else device,
                              kv_pool=kv_pool)
    if wrap_decode is not None:
        server._decode = wrap_decode(server._decode)
    t0 = time.perf_counter()
    reqs = [Request(req_id=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        server.enqueue(r)
    steps = server.run_until_drained(max_steps=max_steps)
    sync(model.device)
    secs = time.perf_counter() - t0
    m = server.metrics
    check(m["completed"] == len(reqs) and all(len(r.output) == max_new for r in reqs),
          f"served {m['completed']} of {len(reqs)} requests in {steps} steps")
    check(all(0 <= t < model.cfg.vocab_size for r in reqs for t in r.output),
          "a served token is outside the vocabulary")
    return reqs, server, secs


def serve_card_and_cpu(dev, cfg, prompt_lens, *, max_new: int, prompt_seed: int,
                       device, kv_pool=None, splices=None, pin=False, routing=None) -> dict:
    """Serve prompts of ``prompt_lens`` tokens (3 slots, a cache of 96)
    with ``cfg``'s model (flash) on the card through ``device`` and, with
    the same weights, on the CPU: the same tokens, and the 77-token
    prefill's logits within SERVE_F32_TOL.  The launch counts are set to 0
    just before the card serves and read just after; with ``splices`` (a
    list) every splice is checked (``checked_splices``); ``pin`` pins both
    servers' admission (``pin_admission``); with ``routing`` (a dict) every
    router call of the card's and the CPU's serving is recorded in its
    "card" and "cpu" lists (``recorded_routing``)."""
    from repro_torch import tree as ttree
    from repro_torch.core import make_device
    from repro_torch.models.api import build_model

    card = build_model(cfg, remat=False, attn_impl="flash", device=dev)
    params = card.init(torch.Generator(device=dev).manual_seed(1))
    host_model = build_model(cfg, remat=False, attn_impl="flash", device="cpu")
    host_params = ttree.tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(prompt_seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in prompt_lens]
    kw = dict(slots=3, max_cache=96, max_new=max_new, max_steps=500)
    @contextlib.contextmanager
    def checking(where):
        with contextlib.ExitStack() as stack:
            if splices is not None:
                stack.enter_context(checked_splices(splices))
            if routing is not None:
                stack.enter_context(recorded_routing(routing.setdefault(where, [])))
            yield

    reset_counts()
    with checking("card"):
        on_card, server, secs = serve(card, params, device, prompts, kv_pool=kv_pool, pin=pin,
                                      **kw)
    sync(dev)
    counts = read_counts(SLICE4)
    with checking("cpu"):
        on_cpu, _, cpu_secs = serve(
            host_model, host_params,
            make_device(n_instances=2, policy="least_loaded", device="cpu"), prompts, pin=pin,
            **kw)
    check([r.output for r in on_card] == [r.output for r in on_cpu],
          f"the card served other tokens than the CPU: {[r.output for r in on_card]} vs "
          f"{[r.output for r in on_cpu]}")
    toks = torch.from_numpy(prompts[prompt_lens.index(77)])[None]
    _, lc, _ = card.prefill(params, {"tokens": toks.to(dev)}, 96)
    _, lh, _ = host_model.prefill(host_params, {"tokens": toks}, 96)
    err = float((lc.cpu() - lh).abs().max())
    check(bool(torch.isfinite(lc).all()) and lc.shape == (1, cfg.vocab_size), "prefill logits")
    check(torch.allclose(lc.cpu(), lh, **SERVE_F32_TOL),
          f"prefill logits of the card and the CPU differ by {err}")
    print(f"{len(prompts)} requests served on the card in {secs:.3f} s and on the CPU in "
          f"{cpu_secs:.3f} s: the same {sum(len(r.output) for r in on_card)} tokens; 77-token "
          f"prefill logits max |card - CPU| {err:.3e}; placements "
          f"{dict(server.device.policy_stats['decisions'])}; launches on the card {counts}")
    return {"card_s": secs, "cpu_s": cpu_secs, "logits_err": err, "launches": counts}


@phase("3d serving on the card and on the CPU (tinyllama-1.1b.reduced(), f32)")
def serving_small(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import make_device
    from repro_torch.serving.kv_pool import PagedKVPool

    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(), dtype="float32")
    device = make_device(n_instances=2, policy="least_loaded", device=dev)
    # admission reserves each prompt's KV pages in a pool on the card
    pool = PagedKVPool(n_device_pages=32, n_host_pages=16, page_tokens=16,
                       kv_dim=2 * cfg.num_kv_heads * cfg.head_dim, dtype=torch.float32,
                       device=device)
    out = serve_card_and_cpu(dev, cfg, (16, 77, 33, 50, 64, 21), max_new=4, prompt_seed=3,
                             device=device, kv_pool=pool)
    check(pool.stats.device_pages_used == 0 and not pool.page_table,
          f"KV pages leaked: {pool.stats}")
    kv_pool_round_trip(pool, gen=torch.Generator(device=dev).manual_seed(5))
    del out["launches"]
    return out


def kv_pool_round_trip(pool, gen) -> None:
    """A sequence's KV pages out to the host tier and back, as batch copies
    through the engines: the pages come back bit for bit, and no copy fell
    back to the synchronous path."""
    n = 5
    check(pool.alloc(7, n), "no KV pages for the round trip")
    pages = torch.randn((n, pool.page_tokens, pool.kv_dim), generator=gen, device=gen.device)
    for i in range(n):
        pool.write_page(7, i, pages[i])
    check(pool.swap_out(7) and pool.swap_in(7), "the KV swap was refused")
    check(same_bits(pool.read_pages(7), pages.to(pool.host_pool.dtype).reshape(-1, pool.kv_dim)),
          "KV pages changed on their way to the host tier and back")
    pool.free(7)
    st = pool.stats
    check(st.copy_fallbacks == 0 and st.swaps_out == st.swaps_in == 1 and st.pages_moved == 2 * n,
          f"KV pool: {st}")
    print(f"KV pool on the card: {n} pages out and back through batch copies, "
          f"copy_fallbacks {st.copy_fallbacks}")


@phase("4d serving tinyllama-1.1b at full width and depth (bf16, flash)")
def serving_full(dev) -> dict:
    from repro_torch.configs import get_config

    return serve_full(dev, get_config("tinyllama-1.1b"))


@phase("4f serving gemma3-1b at full width and depth (bf16, flash)")
def serving_gemma(dev) -> dict:
    """gemma3-1b (26 layers: 4 periods of 5 local layers with a 1024-token
    ring and a global one, then 2 local layers; qk-norm, tied embeddings)
    served as phase 4d serves tinyllama."""
    from repro_torch.configs import get_config

    return serve_full(dev, get_config("gemma3-1b"))


@contextlib.contextmanager
def checked_splices(out: list):
    """Within the block, each ``_splice_cache`` of the server is checked:
    afterwards the spliced slot of every cache leaf is bit-equal to the
    batch-1 prefill's, and every other slot is what it was.  A leaf's batch
    axis is found from the shapes (the one axis where the batch cache and
    the batch-1 cache differ), independently of the splice's own rule.
    Appends (leaves checked, seconds of the splice and its check) per
    splice to ``out``."""
    from repro_torch import tree as ttree
    from repro_torch.serving import pipeline

    base = pipeline._splice_cache

    def splice(batch_cache, one_cache, slot):
        t0 = time.perf_counter()
        before = [local(t).clone() for t in ttree.leaves(batch_cache["segments"])]
        got = base(batch_cache, one_cache, slot)
        dst = [local(t) for t in ttree.leaves(got["segments"])]
        src = [local(t) for t in ttree.leaves(one_cache["segments"])]
        check(len(dst) == len(src) == len(before), "the spliced cache's leaves")
        for d, s, b in zip(dst, src, before):
            axes = [i for i, (m, n) in enumerate(zip(d.shape, s.shape)) if m != n]
            check(d.dim() == s.dim() and len(axes) == 1 and s.shape[axes[0]] == 1,
                  f"a cache leaf {tuple(d.shape)} against the batch-1 {tuple(s.shape)}")
            ax = axes[0]
            check(same_bits(d.select(ax, slot), s.select(ax, 0)),
                  f"slot {slot} of a cache leaf {tuple(d.shape)} (batch axis {ax}) is not "
                  f"the batch-1 prefill's")
            others = [i for i in range(d.shape[ax]) if i != slot]
            idx = torch.tensor(others, device=d.device)
            check(same_bits(d.index_select(ax, idx), b.index_select(ax, idx)),
                  f"the splice into slot {slot} changed another slot of a leaf "
                  f"{tuple(d.shape)}")
        check(int(local(got["lengths"])[slot]) == int(local(one_cache["lengths"])[0]),
              "spliced length")
        out.append((len(dst), time.perf_counter() - t0))
        return got

    pipeline._splice_cache = splice
    try:
        yield
    finally:
        pipeline._splice_cache = base


def serve_full(dev, cfg, *, mesh=None, moe_dispatch="dense", compare="default") -> dict:
    """Serve FULL_PROMPTS through 4 slots at ``cfg``'s width and depth
    (bf16, flash): every request completes, every admission's splice is
    checked (``checked_splices``), flash launches once an attention layer
    a prefill (never for an SSM) and the prompt copies go through
    memcpy_words and batch_copy_pages; time to first token, decode
    tokens/s, peak memory, the served tokens; then a hybrid's
    ``ring_check`` and, on the 2048-token prompt, ``compare``: by default
    an SSM's ``ssm_decode_chain`` or any other model's ``flash_vs_chunked``
    (its prefill's logits under "flash" against "chunked"), which may
    change the parameters: nothing reads them after it.  With ``mesh`` the
    model is built on it with ``moe_dispatch``, its parameters laid out by
    ``tree_shardings`` (DTensors over the same storage), and it serves
    under the mesh's rules; ``compare`` is then the caller's (None:
    nothing)."""
    from repro_torch import tree as ttree
    from repro_torch.core import make_device
    from repro_torch.models.api import build_model

    sync(dev)
    base = torch.cuda.memory_allocated(dev)
    model = build_model(cfg, mesh=mesh, moe_dispatch=moe_dispatch, remat=False,
                        attn_impl="flash", device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(2))
    if mesh is not None:
        params = placed(params, mesh)
    sync(dev)
    n_params = sum(t.numel() for t in ttree.leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in ttree.leaves(params))
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {n_params} params, "
          f"{n_bytes} B ({cfg.dtype}) made on the card in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in FULL_PROMPTS]
    device = make_device(n_instances=2, policy="least_loaded", device=dev)
    decode_s = [0.0, 0]

    def timed(decode):
        # host clock around each decode step, synchronised: the decode share
        def run(*a):
            t = time.perf_counter()
            out = decode(*a)
            sync(dev)
            decode_s[0] += time.perf_counter() - t
            decode_s[1] += 1
            return out
        return run

    # the server's batch-1 prefills, synchronised on both sides: the
    # prefill's share of each time to first token
    prefill_s: list = []
    plain_prefill = model.prefill

    def timed_prefill(params, batch, *a, **kw):
        sync(dev)
        t = time.perf_counter()
        out = plain_prefill(params, batch, *a, **kw)
        sync(dev)
        prefill_s.append((batch["tokens"].shape[1], time.perf_counter() - t))
        return out

    torch.cuda.reset_peak_memory_stats(dev)
    splices: list = []
    reset_counts()
    model.prefill = timed_prefill
    try:
        with checked_splices(splices), on_mesh(mesh):
            reqs, server, secs = serve(model, params, device, prompts, slots=FULL_SLOTS,
                                       max_cache=FULL_CACHE, max_new=FULL_NEW,
                                       wrap_decode=timed)
    finally:
        del model.prefill
    counts = read_counts(SLICE4)
    # what the serving itself held at its peak: what earlier phases left
    # allocated is not counted
    peak = torch.cuda.max_memory_allocated(dev) - base
    print(f"launches while serving: {counts}; {len(splices)} splices checked, "
          f"{splices[0][0]} cache leaves each; peak memory {peak} B")
    check(len(splices) == len(prompts), f"{len(splices)} splices for {len(prompts)} requests")
    attn_layers = 0 if cfg.family == "ssm" else cfg.num_layers
    check(counts["flash_attention"] == attn_layers * len(prompts),
          f"flash_attention launched {counts['flash_attention']} times, not "
          f"{attn_layers} attention layers x {len(prompts)} prefills")
    check(counts["memcpy_words"] > 0 and counts["batch_copy_pages"] > 0,
          f"the prompt copies did not go through memcpy_words and batch_copy_pages: {counts}")
    m = server.metrics
    ttft = [(len(r.prompt), r.first_token_at - r.arrived_at) for r in reqs]
    # the time to first token split by request (a request's prefill, splice
    # and first token come in admission order): the batch-1 prefill, the
    # splice with its check, and the rest (waiting for a slot, the prompt
    # copy through the engine, admission)
    admitted = sorted(reqs, key=lambda r: r.first_token_at)
    check([n for n, _ in prefill_s] == [len(r.prompt) for r in admitted],
          f"prefills timed: {[n for n, _ in prefill_s]}")
    split = [{"prompt": len(r.prompt), "ttft_s": r.first_token_at - r.arrived_at,
              "prefill_s": p[1], "splice_check_s": sp[1]}
             for r, p, sp in zip(admitted, prefill_s, splices)]
    decoded = m["decoded_tokens"]
    out = {"model": cfg.name, "seconds": secs, "ttft_s": ttft, "ttft_split": split,
           "decode_s": decode_s[0],
           "decode_steps": decode_s[1], "decoded_tokens": decoded,
           "decode_tok_s": decoded / decode_s[0],
           "steps": m["steps"], "copy_bursts": m["copy_bursts"], "launches": counts,
           "splices_checked": len(splices), "peak_bytes": peak,
           "params": n_params, "param_bytes": n_bytes,
           "tokens": [r.output for r in reqs]}
    print(f"served 8 requests in {secs:.3f} s ({m['steps']} steps, {m['copy_bursts']} copy "
          f"bursts); {decoded} decoded tokens in {decode_s[1]} decode steps, "
          f"{decode_s[0]:.3f} s ({decoded / decode_s[0]:.1f} tokens/s); time to first token "
          f"by prompt length: " + ", ".join(f"{n}: {t:.3f} s" for n, t in ttft))
    print("time to first token, split: " + "; ".join(
        f"{d['prompt']}: {d['ttft_s']:.4f} s = prefill {d['prefill_s']:.4f} + splice and its "
        f"check {d['splice_check_s']:.4f} + the rest "
        f"{d['ttft_s'] - d['prefill_s'] - d['splice_check_s']:.4f}" for d in split))
    del server
    if cfg.family == "hybrid":
        out.update(ring_check(model, params, dev))
    if compare == "default":
        compare = ssm_decode_chain if cfg.family == "ssm" else flash_vs_chunked
    if compare is not None:
        out.update(compare(model, params, {"tokens": torch.from_numpy(prompts[0])[None]}, dev))
    return out


def flash_vs_chunked(model, params, batch, dev) -> dict:
    """One batch's prefill logits under "flash" and "chunked" (plain
    PyTorch), with the model's bf16 weights and with the same weights in
    f32.  ``batch`` holds [B, S] tokens (and a VLM's fields).  The bf16
    runs go first; ``params`` is then turned into f32 in place
    (``f32_in_place``; nothing reads it after), so no second copy of the
    model is held (deepseek-moe-16b is 32.8 GB in bf16, 65.5 GB in f32).
    For an MoE model each run's router calls are recorded
    (``recorded_routing``), and the f32 check holds flash against a
    chunked run that takes the flash run's expert choices
    (``replayed_routing``): a choice whose top-k margin is below the two
    attention paths' f32 difference flips otherwise, and with it which
    assignments a full expert drops, which moves the logits of the last
    tokens (the last in the dispatch order) by far more than the attention
    paths differ.  The difference with each run's own choices, the flips
    by layer and the bf16 flash run's drops by layer are reported beside
    it."""
    from repro_torch.models.api import build_model

    cfg32 = dataclasses.replace(model.cfg, dtype="float32")
    batch = {k: v.to(dev) for k, v in batch.items()}
    bsz, prompt_len = batch["tokens"].shape
    routing = {} if model.cfg.moe is not None else None
    logits = {}
    for kind in ("bf16", "f32"):
        cfg, p = (model.cfg, params) if kind == "bf16" else (cfg32, f32_in_place(params))
        for impl in ("flash", "chunked"):
            m = build_model(cfg, remat=False, attn_impl=impl, device=dev)
            calls = routing.setdefault((kind, impl), []) if routing is not None else None
            with recorded_routing(calls) if calls is not None else contextlib.nullcontext():
                _, logits[kind, impl], _ = m.prefill(p, batch, prompt_len)
        if kind == "f32" and routing is not None:
            m = build_model(cfg, remat=False, attn_impl="chunked", device=dev)
            with replayed_routing(routing["f32", "flash"]):
                _, logits["f32", "chunked, flash's routing"], _ = m.prefill(p, batch, prompt_len)
        del p
    for key, lg in logits.items():
        check(bool(torch.isfinite(lg).all()) and lg.shape == (bsz, model.cfg.vocab_size),
              f"{key} prefill logits: not finite, or shape {tuple(lg.shape)}")

    def gap(a, b):
        return float((logits[a] - logits[b]).abs().max())

    f32_ref = ("f32", "chunked") if routing is None else ("f32", "chunked, flash's routing")
    out = {"f32_flash_vs_chunked": gap(("f32", "flash"), f32_ref),
           "bf16_flash_vs_chunked": gap(("bf16", "flash"), ("bf16", "chunked")),
           "bf16_noise": gap(("bf16", "chunked"), ("f32", "chunked")),
           "bf16_flash_vs_f32": gap(("bf16", "flash"), ("f32", "chunked")),
           "logits_absmax": float(logits["f32", "chunked"].abs().max()),
           "same_argmax": len({tuple(lg.argmax(-1).tolist()) for lg in logits.values()}) == 1}
    if routing is not None:
        out.update(moe_routing(model.cfg, routing))
        out["f32_flash_vs_chunked_own_routing"] = gap(("f32", "flash"), ("f32", "chunked"))
        print(f"f32, each run's own routing: flash vs chunked "
              f"{out['f32_flash_vs_chunked_own_routing']:.3e}")
    print(f"{bsz} x {prompt_len}-token prefill logits (|logits| up to "
          f"{out['logits_absmax']:.3f}): "
          f"f32 flash vs chunked {out['f32_flash_vs_chunked']:.3e}; bf16 flash vs chunked "
          f"{out['bf16_flash_vs_chunked']:.3e}, bf16 noise (chunked bf16 vs f32) "
          f"{out['bf16_noise']:.3e}, flash bf16 vs f32 {out['bf16_flash_vs_f32']:.3e}; "
          f"one argmax: {out['same_argmax']}")
    check(torch.allclose(logits["f32", "flash"], logits[f32_ref], **SERVE_F32_TOL),
          f"f32 prefill logits: flash and chunked differ by {out['f32_flash_vs_chunked']}")
    check(out["bf16_flash_vs_chunked"] <= BF16_NOISE_FACTOR * out["bf16_noise"],
          f"bf16 prefill logits: flash and chunked differ by {out['bf16_flash_vs_chunked']}, "
          f"more than {BF16_NOISE_FACTOR} x the bf16 noise {out['bf16_noise']}")
    check(out["bf16_flash_vs_f32"] <= BF16_FROM_F32_FACTOR * out["bf16_noise"],
          f"bf16 flash is {out['bf16_flash_vs_f32']} from the f32 model, more than "
          f"{BF16_FROM_F32_FACTOR} x chunked's {out['bf16_noise']}")
    return out


def moe_routing(cfg, routing: dict) -> dict:
    """What ``flash_vs_chunked``'s recorded router calls show: the bf16
    flash prefill's dropped assignments by MoE layer, the smallest top-k
    margin of all runs, and, by layer, the tokens whose choices differ
    between the f32 flash and chunked runs and the assignments kept in one
    and dropped in the other."""
    n_moe = len(cfg.moe_layer_indices())
    check(all(len(v) == n_moe for v in routing.values()),
          f"router calls a prefill: {[len(v) for v in routing.values()]}, not {n_moe}")
    served = routing["bf16", "flash"]
    f32 = list(zip(routing["f32", "flash"], routing["f32", "chunked"]))
    out = {"prefill_drops_by_layer": [int((~c["keep"]).sum()) for c in served],
           "assignments_a_layer": served[0]["keep"].numel(),
           "min_topk_margin": min(c["margin"] for v in routing.values() for c in v),
           "f32_router_flips_by_layer": [int((a["idx"] != b["idx"]).any(-1).sum())
                                         for a, b in f32],
           "f32_keep_changes_by_layer": [int((a["keep"] != b["keep"]).sum()) for a, b in f32]}
    print(f"prefill: dropped assignments by MoE layer (of {out['assignments_a_layer']} each) "
          f"{out['prefill_drops_by_layer']}; smallest top-{cfg.moe.top_k} margin "
          f"{out['min_topk_margin']:.3e}; f32 flash vs chunked, tokens whose expert choice "
          f"differs by layer {out['f32_router_flips_by_layer']}, assignments kept in one run "
          f"and dropped in the other {out['f32_keep_changes_by_layer']}")
    return out


def f32_in_place(tree):
    """Every leaf of the tree of dicts and lists ``tree`` replaced by its
    f32 copy, the largest first, each old leaf freed before the next copy
    is made; a leaf whose f32 copy does not fit beside it on the card goes
    through the host.  A DTensor leaf (of the one-rank host mesh) becomes
    its local tensor first.  Returns ``tree``."""
    # an explicit stack, not a recursive closure: a nested function that
    # calls itself is a reference cycle, which would hold ``slots`` (and
    # through it every leaf's parent) until the collector runs
    slots, stack = [], [tree]
    while stack:
        node = stack.pop()
        for k, v in (node.items() if isinstance(node, dict) else enumerate(node)):
            if isinstance(v, (dict, list)):
                stack.append(v)
            else:
                slots.append((node, k))
                node[k] = local(v)  # a DTensor of the host mesh: its storage
    for node, k in sorted(slots, key=lambda s: -s[0][s[1]].numel()):
        t, dev = node[k], node[k].device
        if t.is_cuda and t.dtype != torch.float32:
            torch.cuda.empty_cache()
            if torch.cuda.mem_get_info(dev)[0] < 4 * t.numel() + GiB:
                # no room for both copies on the card: through the host
                print(f"a {tuple(t.shape)} leaf made f32 through the host")
                host = t.cpu()
                node[k] = t = None
                torch.cuda.empty_cache()
                node[k] = host.float().to(dev)
                continue
        node[k] = t.float()
    torch.cuda.empty_cache()
    return tree


@contextlib.contextmanager
def recorded_routing(calls: list):
    """Within the block, each call of the MoE router appends to ``calls``
    (on the host): the expert indices [T, k], the keep mask [T * k] of the
    capacity dispatch, and the smallest gap between a token's k-th and
    (k+1)-th router probability (the margin a rounding would have to cross
    to change the choice)."""
    from repro_torch.models import moe

    base = moe.router_topk

    def router_topk(x, w_router, cfg):
        weights, idx, aux = base(x, w_router, cfg)
        probs = torch.softmax(x.float() @ w_router.float(), dim=-1)
        top = probs.sort(dim=-1, descending=True).values
        k = cfg.top_k
        margin = (float((top[:, k - 1] - top[:, k]).min()) if k < probs.shape[-1]
                  else math.inf)
        keep = moe.dispatch_plan(idx, cfg, x.shape[0])[2]
        calls.append({"idx": idx.cpu(), "keep": keep.cpu(), "margin": margin})
        return weights, idx, aux

    moe.router_topk = router_topk
    try:
        yield
    finally:
        moe.router_topk = base


@contextlib.contextmanager
def replayed_routing(calls: list):
    """Within the block, the i-th call of the MoE router chooses the
    experts ``calls[i]["idx"]`` (recorded by ``recorded_routing``), weighted
    by its own probabilities of them as the router weighs its choices."""
    from repro_torch.models import moe

    base = moe.router_topk
    replay = iter(calls)

    def router_topk(x, w_router, cfg):
        _, _, aux = base(x, w_router, cfg)
        idx = next(replay)["idx"].to(x.device)
        weights = torch.softmax(x.float() @ w_router.float(), dim=-1).gather(1, idx)
        if cfg.top_k > 1:
            weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
        return weights, idx, aux

    moe.router_topk = router_topk
    try:
        yield
    finally:
        moe.router_topk = base


# --------------------------------------------------------------------------- phases 3f and 4g
#: phase 3f's prompts: each longer than the reduced window of 16 or reaching
#: past it while decoding, so the ring wraps in prefill and in decode
GEMMA_SMALL_PROMPTS = (16, 77, 33, 50, 64, 21)
GEMMA_SMALL_LAYERS, GEMMA_SMALL_NEW = 8, 8


@phase("3f serving gemma3 on the card and on the CPU (gemma3-1b.reduced(), 8 layers, f32)")
def serving_gemma_small(dev) -> dict:
    """gemma3-1b.reduced() at 8 layers (one period of 5 local layers with a
    16-token ring and a global one, then 2 local layers) in f32, served as
    phase 3d serves tinyllama, with every splice checked.  Returns the
    launches of the card's serving."""
    from repro_torch.configs import get_config
    from repro_torch.core import make_device

    cfg = dataclasses.replace(get_config("gemma3-1b").reduced(),
                              num_layers=GEMMA_SMALL_LAYERS, dtype="float32")
    W = cfg.window_size
    check(max(GEMMA_SMALL_PROMPTS) > W and min(GEMMA_SMALL_PROMPTS) + GEMMA_SMALL_NEW - 1 > W,
          "phase 3f's ring must wrap in prefill and in decode")
    splices: list = []
    out = serve_card_and_cpu(dev, cfg, GEMMA_SMALL_PROMPTS, max_new=GEMMA_SMALL_NEW,
                             prompt_seed=6, splices=splices,
                             device=make_device(n_instances=2, policy="least_loaded",
                                                device=dev))
    check(len(splices) == 2 * len(GEMMA_SMALL_PROMPTS), f"{len(splices)} splices checked")
    print(f"{len(splices)} splices checked, {splices[0][0]} cache leaves each")
    return out


#: phase 4g: qwen2-vl-2b, a batch of 2 x 2048 tokens whose positions 1-256
#: are a 16 x 16 grid of patch embeddings, then 16 greedy decode steps
VLM_BATCH, VLM_SEQ, VLM_GRID, VLM_NEW = 2, 2048, 16, 16


def vlm_batch(cfg, seed: int) -> dict:
    """CPU tensors: VLM_BATCH x VLM_SEQ tokens, VLM_GRID x VLM_GRID patch
    embeddings (0.02 x a normal draw) at positions 1 .. VLM_GRID^2 with
    patch (r, c) at (t, h, w) = (1, 1 + r, 1 + c), the text after them at
    t = h = w = 1 + VLM_GRID + j, position 0 at (0, 0, 0)."""
    rng = np.random.default_rng(seed)
    bsz, seq, grid = VLM_BATCH, VLM_SEQ, VLM_GRID
    n_patch = grid * grid
    thw = np.zeros((3, seq), np.int32)
    r, c = np.divmod(np.arange(n_patch), grid)
    thw[0, 1:1 + n_patch] = 1
    thw[1, 1:1 + n_patch] = 1 + r
    thw[2, 1:1 + n_patch] = 1 + c
    thw[:, 1 + n_patch:] = 1 + grid + np.arange(seq - 1 - n_patch)
    return {
        "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (bsz, seq)).astype(np.int32)),
        "patch_embeds": torch.from_numpy(
            (rng.normal(size=(bsz, n_patch, cfg.d_model)) * 0.02).astype(np.float32)),
        "positions_thw": torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(thw[:, None], (3, bsz, seq)))),
    }


def rollout(model, params, batch, n_new: int, dev, tokens=None):
    """Prefill ``batch`` on ``dev`` and decode ``n_new`` - 1 steps, feeding
    ``tokens`` [n_new, B] (greedy when None).  Returns (the logits of each
    step, the tokens fed, prefill seconds, decode seconds, the cache)."""
    batch = {k: v.to(dev) for k, v in batch.items()}
    t0 = time.perf_counter()
    cache, logits, _ = model.prefill(params, batch, batch["tokens"].shape[1] + n_new)
    sync(dev)
    prefill_s = time.perf_counter() - t0
    outs, fed = [logits], []
    t0 = time.perf_counter()
    for i in range(n_new - 1):
        tok = (logits.argmax(-1) if tokens is None else tokens[i].to(dev)).to(torch.int32)
        fed.append(tok.cpu())
        logits, cache = model.decode_step(params, cache, tok[:, None])
        outs.append(logits)
    sync(dev)
    check(int(cache["lengths"][0])
          == getattr(model, "n_meta", 0) + batch["tokens"].shape[1] + n_new - 1, "decode lengths")
    return outs, fed, prefill_s, time.perf_counter() - t0, cache


def same_cache(got, want, what: str) -> float:
    """Every leaf of two caches of one model on the card and the CPU: the
    same names, shapes and types, lengths and ring positions equal, the
    rest within SERVE_F32_TOL.  Returns the largest difference."""
    from repro_torch import tree as ttree

    g, w = ttree.flatten_with_names(got), ttree.flatten_with_names(want)
    check([n for n, _ in g] == [n for n, _ in w], f"{what}: the caches' leaves differ")
    worst = 0.0
    for (name, a), (_, b) in zip(g, w):
        a = a.cpu()
        check(a.shape == b.shape and a.dtype == b.dtype, f"{what}: leaf {name}")
        if name == "lengths" or name.endswith("/pos"):
            check(torch.equal(a, b), f"{what}: leaf {name} differs")
            continue
        worst = max(worst, float((a.float() - b.float()).abs().max()))
        check(torch.allclose(a, b, **SERVE_F32_TOL), f"{what}: leaf {name} differs by "
              f"{float((a.float() - b.float()).abs().max())}")
    return worst


def card_and_cpu_rollout(dev, cfg, batch, n_new: int, seed: int) -> dict:
    """``cfg``'s model (flash asked for) with the same weights on the card
    and the CPU: ``batch`` prefilled and decoded ``n_new`` - 1 steps, the
    card greedy and the CPU fed the card's tokens; every step's logits and
    every leaf of the final caches within SERVE_F32_TOL.  The counts are
    set to 0 before the card's rollout and read after it.  Returns the
    largest differences, the launches and the card's cache."""
    from repro_torch import tree as ttree
    from repro_torch.models.api import build_model

    card = build_model(cfg, remat=False, attn_impl="flash", device=dev)
    params = card.init(torch.Generator(device=dev).manual_seed(seed))
    host_model = build_model(cfg, remat=False, attn_impl="flash", device="cpu")
    reset_counts()
    on_card, fed, _, _, card_cache = rollout(card, params, batch, n_new, dev)
    sync(dev)
    counts = read_counts(SLICE4)
    on_cpu, _, _, _, cpu_cache = rollout(host_model, ttree.tree_map(lambda t: t.cpu(), params),
                                         batch, n_new, torch.device("cpu"), tokens=fed)
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(on_card, on_cpu))
    check(all(bool(torch.isfinite(a).all()) for a in on_card), f"{cfg.name}: non-finite logits")
    check(all(torch.allclose(a.cpu(), b, **SERVE_F32_TOL) for a, b in zip(on_card, on_cpu)),
          f"{cfg.name} in f32: card and CPU logits differ by {err}")
    cache_err = same_cache(card_cache, cpu_cache, f"{cfg.name} card vs CPU cache")
    return {"logits_err": err, "cache_err": cache_err, "launches": counts, "cache": card_cache}


@phase("4g qwen2-vl-2b at full width and depth through the model API (bf16, flash)")
def vlm_full(dev) -> dict:
    """qwen2-vl-2b (28 layers, M-RoPE sections (16, 24, 24)) through
    ``prefill`` and ``decode_step``: ``vlm_batch``'s 2 x 2048 tokens with
    16 x 16 patch embeddings, 16 greedy steps; flash launches once a layer
    in the prefill; the prefill's logits under "flash" against "chunked";
    then the same batch at ``reduced()`` size in f32 on the card and on the
    CPU (``card_and_cpu_rollout``)."""
    from repro_torch import tree as ttree
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model

    cfg = get_config("qwen2-vl-2b")
    sync(dev)
    base = torch.cuda.memory_allocated(dev)
    model = build_model(cfg, remat=False, attn_impl="flash", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(3))
    n_params = sum(t.numel() for t in ttree.leaves(params))
    batch = vlm_batch(cfg, 7)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    logits, toks, prefill_s, decode_s, _ = rollout(model, params, batch, VLM_NEW, dev)
    counts = read_counts(("flash_attention",))
    peak = torch.cuda.max_memory_allocated(dev) - base
    check(all(bool(torch.isfinite(lg).all()) and lg.shape == (VLM_BATCH, cfg.vocab_size)
              for lg in logits), "qwen2-vl logits: not finite, or of another shape")
    check(counts["flash_attention"] == cfg.num_layers,
          f"flash_attention launched {counts['flash_attention']} times in one prefill, not "
          f"{cfg.num_layers}")
    out = {"params": n_params, "prefill_s": prefill_s, "decode_s": decode_s,
           "decode_tok_s": VLM_BATCH * (VLM_NEW - 1) / decode_s, "peak_bytes": peak,
           "launches": counts}
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {n_params} params; "
          f"prefill of {VLM_BATCH} x {VLM_SEQ} tokens ({VLM_GRID ** 2} patches) {prefill_s:.3f} s, "
          f"{VLM_NEW - 1} decode steps {decode_s:.3f} s; launches {counts}; peak memory {peak} B")
    out.update(flash_vs_chunked(model, params, batch, dev))
    del model, params, logits
    # the same batch at reduced() size in f32, on the card and on the CPU
    small = dataclasses.replace(cfg.reduced(), dtype="float32")
    res = card_and_cpu_rollout(dev, small, vlm_batch(small, 7), VLM_NEW, seed=4)
    err = res["logits_err"]
    print(f"reduced qwen2-vl (f32), the same batch: prefill and {VLM_NEW - 1} decode steps' "
          f"logits max |card - CPU| {err:.3e}, cache leaves {res['cache_err']:.3e}")
    out["reduced_card_vs_cpu"] = err
    return out


# --------------------------------------------------------------------------- phases 3j and 4l
#: slice 12: the host mesh (``launch.mesh.make_host_mesh``: one rank,
#: ("data", "model") of (1, 1)), where every spec resolves to replication;
#: what runs there is the mesh path: DTensors laid out by the rules, the
#: flash kernel through its shard_map, the a2a dispatch with its all-reduce
#: over "model" (NCCL on the card, gloo on the CPU)
TINYLLAMA_ID = "tinyllama-1.1b"
MESH_SMALL_PROMPTS = (16, 77, 33, 50, 64, 21)
MESH_SMALL_NEW = 6


def local(t):
    """A DTensor's shard on this rank (on the one-rank host mesh, its whole
    value, the same storage); anything else as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


@contextlib.contextmanager
def on_mesh(mesh):
    """Within the block, ``mesh``'s default rules are active (None: no
    mesh, nothing changes)."""
    if mesh is None:
        yield
        return
    from repro_torch.distributed import rules_for_mesh, use_rules

    with use_rules(mesh, rules_for_mesh(mesh)):
        yield


def placed(params, mesh):
    """``params`` laid out on ``mesh`` by ``tree_shardings`` (DTensors)."""
    from repro_torch import tree as ttree
    from repro_torch.distributed import rules_for_mesh
    from repro_torch.distributed.params import tree_shardings
    from repro_torch.distributed.sharding import place

    return ttree.tree_map(place, params, tree_shardings(params, mesh, rules_for_mesh(mesh)))


def collectives() -> int:
    """All-reduces the mesh path has launched so far (``all_reduce_sum``)."""
    from repro_torch.distributed.annotate import all_reduce_sum

    return all_reduce_sum.launches


def shown(res: dict) -> dict:
    """A phase's result without its launch counts and served tokens."""
    return {k: v for k, v in res.items() if k not in ("launches", "tokens")}


@phase("3j serving on the host mesh, on the card (NCCL) and the CPU (gloo) (reduced(), f32)")
def serving_mesh_small(dev, mesh, host_mesh) -> dict:
    """tinyllama-1.1b and deepseek-moe-16b at reduced() size in f32, built
    on the card's host mesh (deepseek with the a2a dispatch; both with
    flash and tp_comm="manual_bf16", which is the plain path at one rank),
    their parameters laid out by the rules, served under the rules with
    every splice checked and admission pinned (as 3h), and with the same
    weights on the CPU's host mesh: the same tokens.  tinyllama's tokens
    also equal those of the same weights served with no mesh.  The launch
    counts and the all-reduces are set to 0 just before the card serves
    and read just after."""
    from torch.distributed.tensor import DTensor

    from repro_torch import tree as ttree
    from repro_torch.configs import get_config
    from repro_torch.core import make_device
    from repro_torch.models.api import build_model

    out = {}
    for arch, dispatch in ((TINYLLAMA_ID, "dense"), (DEEPSEEK_MOE, "a2a")):
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        kw = dict(remat=False, attn_impl="flash", tp_comm="manual_bf16", moe_dispatch=dispatch)
        card = build_model(cfg, mesh=mesh, device=dev, **kw)
        params = card.init(torch.Generator(device=dev).manual_seed(1))
        host_model = build_model(cfg, mesh=host_mesh, device="cpu", **kw)
        host_params = ttree.tree_map(lambda t: t.cpu(), params)
        rng = np.random.default_rng(12)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in MESH_SMALL_PROMPTS]
        serve_kw = dict(slots=3, max_cache=96, max_new=MESH_SMALL_NEW, max_steps=500, pin=True)
        splices: list = []
        reset_counts()
        before = collectives()
        with on_mesh(mesh), checked_splices(splices):
            on_card, server, secs = serve(
                card, placed(params, mesh),
                make_device(n_instances=2, policy="least_loaded", device=dev), prompts,
                **serve_kw)
        sync(dev)
        launches, nccl = read_counts(SLICE4), collectives() - before
        check(all(isinstance(t, DTensor) for t in ttree.leaves(server.cache["segments"])),
              f"{arch}: the served cache is not laid out on the mesh")
        del server
        with on_mesh(host_mesh):
            on_cpu, _, cpu_secs = serve(
                host_model, placed(host_params, host_mesh),
                make_device(n_instances=2, policy="least_loaded", device="cpu"), prompts,
                **serve_kw)
        tokens = [r.output for r in on_card]
        check(tokens == [r.output for r in on_cpu],
              f"{arch}: the card's mesh served other tokens than the CPU's: {tokens} vs "
              f"{[r.output for r in on_cpu]}")
        check(len(splices) == len(prompts), f"{arch}: {len(splices)} splices checked")
        check(dev.type != "cuda" or launches["flash_attention"] == cfg.num_layers * len(prompts),
              f"{arch}: flash_attention launched {launches['flash_attention']} times, not "
              f"{cfg.num_layers} layers x {len(prompts)} prefills")
        res = {"card_s": secs, "cpu_s": cpu_secs, "launches": launches, "all_reduces": nccl,
               "splices_checked": len(splices)}
        if dispatch == "a2a":
            check(nccl > 0, f"{arch}: the a2a dispatch launched no all-reduce on the card")
        if arch == TINYLLAMA_ID:
            plain, _, _ = serve(build_model(cfg, device=dev, **kw), params,
                                make_device(n_instances=2, policy="least_loaded", device=dev),
                                prompts, **serve_kw)
            check(tokens == [r.output for r in plain],
                  f"{arch}: the mesh served other tokens than the card with no mesh")
            res["same_tokens_as_no_mesh"] = True
        print(f"{arch} reduced on the host mesh: {len(prompts)} requests in {secs:.3f} s on the "
              f"card and {cpu_secs:.3f} s on the CPU, the same {sum(map(len, tokens))} tokens; "
              f"launches on the card {launches}, all-reduces {nccl}")
        out[arch] = res
    return out


def a2a_vs_dense(mesh):
    """``serve_full``'s comparison for the MoE model on the host mesh: the
    2048-token prefill's logits under the a2a dispatch and the dense one
    with the capacity factor raised to ceil(E / k), so neither drops an
    assignment (each has its own capacity rule, and which assignments
    drop would differ), in bf16; then the dense dispatch with the weights
    made f32 in place (``f32_in_place``): the a2a must stay within
    BF16_NOISE_FACTOR x that bf16 noise of the dense."""
    def compare(model, params, batch, dev) -> dict:
        from repro_torch.models.api import build_model

        moe = model.cfg.moe
        cfg = dataclasses.replace(model.cfg, moe=dataclasses.replace(
            moe, capacity_factor=float(math.ceil(moe.num_experts / moe.top_k))))
        batch = {k: v.to(dev) for k, v in batch.items()}
        S = batch["tokens"].shape[1]
        logits = {}
        with on_mesh(mesh):
            for dispatch in ("a2a", "dense"):
                m = build_model(cfg, mesh=mesh, moe_dispatch=dispatch, remat=False,
                                attn_impl="flash", device=dev)
                _, logits[dispatch], _ = m.prefill(params, batch, S)
            # the same storage as plain tensors, turned f32 in place
            p32 = f32_in_place(params)
            m = build_model(dataclasses.replace(cfg, dtype="float32"), mesh=mesh,
                            remat=False, attn_impl="flash", device=dev)
            _, logits["dense f32"], _ = m.prefill(p32, batch, S)
        for key, lg in logits.items():
            check(bool(torch.isfinite(lg).all()) and lg.shape == (1, cfg.vocab_size),
                  f"{key} prefill logits: not finite, or shape {tuple(lg.shape)}")
        gap = float((logits["a2a"] - logits["dense"]).abs().max())
        noise = float((logits["dense"] - logits["dense f32"]).abs().max())
        print(f"{S}-token prefill logits, capacity factor {cfg.moe.capacity_factor} (no drops): "
              f"a2a vs dense {gap:.3e}; bf16 noise (dense bf16 vs f32) {noise:.3e}")
        check(gap <= BF16_NOISE_FACTOR * noise,
              f"a2a and dense prefill logits differ by {gap}, more than {BF16_NOISE_FACTOR} x "
              f"the bf16 noise {noise}")
        return {"nodrop_capacity_factor": cfg.moe.capacity_factor, "a2a_vs_dense": gap,
                "bf16_noise": noise}

    return compare


@phase("4l serving tinyllama-1.1b and deepseek-moe-16b at full width and depth on the host "
       "mesh (bf16, flash)")
def serving_mesh_full(dev, mesh, tiny_4d: dict) -> dict:
    """Both models served as 4d serves tinyllama, built on the card's host
    mesh and serving under its rules: tinyllama must serve 4d's tokens
    (every spec is replicated at one rank), deepseek-moe-16b serves with
    the a2a dispatch (``a2a_vs_dense`` after).  Each counts its launches
    and all-reduces from 0."""
    from repro_torch.configs import get_config

    out = {}
    for arch, dispatch, compare in ((TINYLLAMA_ID, "dense", None),
                                    (DEEPSEEK_MOE, "a2a", a2a_vs_dense(mesh))):
        release(dev)
        before = collectives()
        res = serve_full(dev, get_config(arch), mesh=mesh, moe_dispatch=dispatch,
                         compare=compare)
        res["all_reduces"] = collectives() - before
        print(f"{arch} on the host mesh: launches {res['launches']}, all-reduces "
              f"{res['all_reduces']}")
        out[arch] = res
    check(out[TINYLLAMA_ID]["tokens"] == tiny_4d["tokens"],
          "tinyllama-1.1b on the host mesh served other tokens than phase 4d")
    check(out[DEEPSEEK_MOE]["all_reduces"] > 0, "deepseek's a2a launched no all-reduce")
    return out


# --------------------------------------------------------------------------- phases 3h, 4h and 4i
#: slice 10: the MoE family (deepseek-moe-16b: a leading dense layer, then
#: MoE layers of 64 experts top-6 with 2 shared experts; llama4-maverick:
#: dense / MoE periods, 128 experts top-1) and the Mamba-2 SSM family
DEEPSEEK_MOE, LLAMA4, MAMBA2 = "deepseek-moe-16b", "llama4-maverick-400b-a17b", "mamba2-370m"
#: phase 3h's prompts (the 77-token one's prefill logits are compared)
SLICE10_SMALL_PROMPTS = (16, 77, 33, 50, 64, 21)
SLICE10_SMALL_NEW = 6
#: phase 4i: the last logits of a prefill of SSM_CHAIN_S + 1 tokens against
#: a prefill of SSM_CHAIN_S tokens and one decode step (2047 is odd, so its
#: prefill runs the SSD with chunks of one token; 2048 with chunks of 256)
SSM_CHAIN_S = 2047
SSM_CHAIN_F32_TOL = dict(atol=1e-3, rtol=1e-3)


@phase("3h serving the MoE and SSM families on the card and on the CPU (reduced(), f32)")
def serving_moe_ssm_small(dev) -> dict:
    """deepseek-moe-16b, llama4-maverick and mamba2-370m at ``reduced()``
    size in f32, each served as phase 3d serves tinyllama, with every splice
    checked and admission pinned (``pin_admission``): the same tokens on
    the card and the CPU, the 77-token prefill's logits within
    SERVE_F32_TOL; for the MoE models the router's expert indices and keep
    masks equal on the card and the CPU at every MoE layer of the first
    prefill, and the smallest top-k margin of the run.  Returns each
    model's results with the card's launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import make_device

    out = {}
    for arch in (DEEPSEEK_MOE, LLAMA4, MAMBA2):
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        splices: list = []
        routing: dict = {}
        print(f"{arch} reduced: {cfg.num_layers} layers, d_model {cfg.d_model}")
        res = serve_card_and_cpu(dev, cfg, SLICE10_SMALL_PROMPTS, max_new=SLICE10_SMALL_NEW,
                                 prompt_seed=8, splices=splices, pin=True, routing=routing,
                                 device=make_device(n_instances=2, policy="least_loaded",
                                                    device=dev))
        check(len(splices) == 2 * len(SLICE10_SMALL_PROMPTS), f"{len(splices)} splices checked")
        res["splices_checked"] = len(splices)
        if cfg.moe is not None:
            n_moe = len(cfg.moe_layer_indices())
            card, cpu = routing["card"], routing["cpu"]
            check(len(card) == len(cpu) and len(card) >= n_moe,
                  f"{len(card)} router calls on the card, {len(cpu)} on the CPU")
            for i, (a, b) in enumerate(zip(card[:n_moe], cpu[:n_moe])):
                check(torch.equal(a["idx"], b["idx"]) and torch.equal(a["keep"], b["keep"]),
                      f"{arch}: MoE layer {i} of the first prefill routes otherwise on the "
                      f"card than on the CPU")
            differ = sum(not (torch.equal(a["idx"], b["idx"]) and torch.equal(a["keep"], b["keep"]))
                         for a, b in zip(card, cpu))
            res.update(router_calls=len(card), router_calls_differing=differ,
                       min_topk_margin=min(c["margin"] for c in card + cpu),
                       first_prefill_drops=[int((~c["keep"]).sum()) for c in card[:n_moe]])
            print(f"{arch}: {len(card)} router calls; the first prefill's {n_moe} MoE layers "
                  f"route alike on the card and the CPU (drops by layer "
                  f"{res['first_prefill_drops']}); calls that differ in the whole run: "
                  f"{differ}; smallest top-{cfg.moe.top_k} margin {res['min_topk_margin']:.3e}")
        out[arch] = res
    return out


@phase("4h serving deepseek-moe-16b at full width and depth (bf16, flash)")
def serving_moe_full(dev) -> dict:
    """deepseek-moe-16b (28 layers: a dense layer with d_ff 10944, then 27
    MoE layers of 64 experts top-6 with 2 shared experts, d_ff_expert 1408;
    MHA, 16 heads of 128; bf16, 16.38 G parameters) served as phase 4d
    serves tinyllama; ``flash_vs_chunked`` then reports its routing."""
    from repro_torch.configs import get_config

    release(dev)
    print(f"held on the card before the phase: {torch.cuda.memory_allocated(dev)} B")
    return serve_full(dev, get_config(DEEPSEEK_MOE))


def ssm_decode_chain(model, params, batch, dev) -> dict:
    """The last logits of a prefill of SSM_CHAIN_S + 1 tokens against a
    prefill of SSM_CHAIN_S tokens followed by one decode step (the card's
    counterpart of test_ssd.py's prefill-state-against-decode check): with
    the weights in f32 within SSM_CHAIN_F32_TOL, in bf16 within twice the
    bf16 rounding noise measured in the run (the bf16 prefill against the
    f32 one).  ``batch``'s tokens are extended to SSM_CHAIN_S + 1 from a
    seed."""
    from repro_torch import tree as ttree
    from repro_torch.models.api import build_model

    rng = np.random.default_rng(12)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                         (1, SSM_CHAIN_S + 1)).astype(np.int32)).to(dev)
    logits = {}
    cfg32 = dataclasses.replace(model.cfg, dtype="float32")
    for kind, cfg, p in (("bf16", model.cfg, params),
                         ("f32", cfg32, ttree.tree_map(lambda t: t.float(), params))):
        m = build_model(cfg, remat=False, attn_impl="flash", device=dev)
        t0 = time.perf_counter()
        _, logits[kind, "prefill"], _ = m.prefill(p, {"tokens": toks}, SSM_CHAIN_S + 1)
        sync(dev)
        t1 = time.perf_counter()
        cache, _, _ = m.prefill(p, {"tokens": toks[:, :SSM_CHAIN_S]}, SSM_CHAIN_S + 1)
        sync(dev)
        t2 = time.perf_counter()
        logits[kind, "chain"], _ = m.decode_step(p, cache, toks[:, SSM_CHAIN_S:])
        logits[kind, "seconds"] = (t1 - t0, t2 - t1)
    for key in (("bf16", "prefill"), ("bf16", "chain"), ("f32", "prefill"), ("f32", "chain")):
        lg = logits[key]
        check(bool(torch.isfinite(lg).all()) and lg.shape == (1, model.cfg.vocab_size),
              f"{key} logits: not finite, or shape {tuple(lg.shape)}")

    def gap(a, b):
        return float((logits[a] - logits[b]).abs().max())

    out = {"f32_chain_vs_prefill": gap(("f32", "chain"), ("f32", "prefill")),
           "bf16_chain_vs_prefill": gap(("bf16", "chain"), ("bf16", "prefill")),
           "bf16_noise": gap(("bf16", "prefill"), ("f32", "prefill")),
           "logits_absmax": float(logits["f32", "prefill"].abs().max()),
           "prefill_s": {f"{kind} {n} tokens": logits[kind, "seconds"][i]
                         for kind in ("bf16", "f32")
                         for i, n in enumerate((SSM_CHAIN_S + 1, SSM_CHAIN_S))}}
    print(f"prefill of {SSM_CHAIN_S} tokens and one decode step against a prefill of "
          f"{SSM_CHAIN_S + 1} (|logits| up to {out['logits_absmax']:.3f}): f32 "
          f"{out['f32_chain_vs_prefill']:.3e}; bf16 {out['bf16_chain_vs_prefill']:.3e} against a "
          f"bf16 noise of {out['bf16_noise']:.3e}; prefill seconds {out['prefill_s']}")
    check(torch.allclose(logits["f32", "chain"], logits["f32", "prefill"], **SSM_CHAIN_F32_TOL),
          f"f32: the decode chain is {out['f32_chain_vs_prefill']} from the prefill")
    check(out["bf16_chain_vs_prefill"] <= BF16_NOISE_FACTOR * out["bf16_noise"],
          f"bf16: the decode chain is {out['bf16_chain_vs_prefill']} from the prefill, more "
          f"than {BF16_NOISE_FACTOR} x the bf16 noise {out['bf16_noise']}")
    return out


@phase("4i serving mamba2-370m at full width and depth (bf16)")
def serving_ssm_full(dev) -> dict:
    """mamba2-370m (48 Mamba-2 layers, d_model 1024, d_inner 2048, 32 SSD
    heads of 64, d_state 128, chunk 256; tied embeddings; bf16, 0.37 G
    parameters) served as phase 4d serves tinyllama (no attention: the
    prompt copies are its kernels), then ``ssm_decode_chain``."""
    from repro_torch.configs import get_config

    release(dev)
    return serve_full(dev, get_config(MAMBA2))


# --------------------------------------------------------------------------- phases 3i, 4j and 4k
#: slice 11: the hybrid family (hymba-1.5b: attention and Mamba-2 heads side
#: by side in each layer, 128 meta tokens before every sequence, a
#: 1024-token window on all but the 3 global layers) and the
#: encoder-decoder (seamless-m4t-medium: 12 bidirectional encoder layers
#: over 160 stub frame embeddings, 12 decoder layers with cross-attention)
HYMBA, SEAMLESS = "hymba-1.5b", "seamless-m4t-medium"
#: phase 3i: hymba reduced() (4 layers, one-layer segments) and at 8 layers
#: with global layers (0, 4, 7), whose run of 3 local layers is a scanned
#: segment; served prompts, and a ring check of a 12-token prompt decoded
#: 12 steps past the reduced window of 16
HYBRID_SMALL_LAYERS = (4, 8)
HYBRID_SMALL_PROMPTS = (16, 77, 33, 50, 64, 21)
HYBRID_SMALL_NEW = 8
SMALL_RING_PROMPT, SMALL_STEPS = 12, 12
#: phase 4j's ring check: a 1000-token prompt decoded 200 greedy steps, past
#: the 1024-slot ring after 24; the steps whose logits are held against a
#: fresh prefill of the same prefix, in f32 within 1e-3 as 4i's decode
#: chain (1.57e-5 to 1.70e-5 on the card); test_window_cache.py's bf16
#: bound of 0.1 is below the 32 layers' bf16 rounding noise alone (0.118
#: at 1121 tokens on the card), so bf16 is held to twice that noise
RING_PROMPT, RING_STEPS, RING_CHECKS = 1000, 200, (50, 120, 199)
RING_F32_TOL = dict(atol=1e-3, rtol=1e-3)
#: phase 4k: batch, prompt and new tokens; the last decode step's logits
#: against a teacher-forced prefill within test_ssd.py's bound
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_NEW = 4, 64, 16
TEACHER_TOL = dict(atol=0.08, rtol=0.08)


def hybrid_cfg(layers=None, dtype=None):
    """hymba-1.5b, or its reduced() form at ``layers`` layers (global
    layers first, middle and last); ``dtype`` replaces the config's."""
    from repro_torch.configs import get_config

    cfg = get_config(HYMBA)
    if layers is not None:
        cfg = cfg.reduced()
        if layers != cfg.num_layers:
            cfg = dataclasses.replace(cfg, num_layers=layers, hybrid=dataclasses.replace(
                cfg.hybrid, global_layers=(0, layers // 2, layers - 1)))
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def check_rings(cache, n_meta: int, window: int, total: int) -> int:
    """Every local layer's ring (a ``pos`` leaf) holds the n_meta meta
    positions in its first slots and exactly the last ``window`` of
    ``total`` positions in the rest.  Returns the rings checked."""
    from repro_torch import tree as ttree

    rings = 0
    for name, pos in ttree.flatten_with_names(cache):
        if not name.endswith("/pos"):
            continue
        for row in pos.reshape(-1, pos.shape[-1]).tolist():
            check(row[:n_meta] == list(range(n_meta)),
                  f"{name}: the meta slots hold {row[:n_meta]}")
            check(sorted(row[n_meta:]) == list(range(total - window, total)),
                  f"{name}: the ring holds other positions than the last {window} of {total}")
            rings += 1
    return rings


@phase("3i hymba and seamless on the card and on the CPU (reduced(), f32)")
def serving_hybrid_encdec_small(dev) -> dict:
    """hymba at reduced() size and at 8 layers (a scanned hybrid segment),
    f32, each served as phase 3d serves tinyllama (a ``PagedKVPool``
    reserving the prompts' pages, then a swap out and back) with admission
    pinned and every splice checked (the same tokens on the card and the
    CPU; one flash launch a layer a prefill), then a 12-token prompt decoded 12
    steps past the window of 16 on both (``card_and_cpu_rollout``) with the
    4 meta tokens kept in every ring; seamless at reduced() size (2 + 4
    layers, 24 source frames): prefill of 2 x 24 tokens and 12 decode steps
    on both (``card_and_cpu_rollout``), no flash launch (the reference's
    encoder-decoder runs the chunked path).  Returns each model's results
    with the launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import make_device
    from repro_torch.serving.kv_pool import PagedKVPool

    release(dev)
    print(f"held on the card before the phase: {torch.cuda.memory_allocated(dev)} B")
    torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    for layers in HYBRID_SMALL_LAYERS:
        cfg = hybrid_cfg(layers, "float32")
        n_meta, W = cfg.hybrid.num_meta_tokens, cfg.window_size
        check(SMALL_RING_PROMPT + SMALL_STEPS > W and min(HYBRID_SMALL_PROMPTS) + HYBRID_SMALL_NEW > W,
              "phase 3i's rings must wrap in decode")
        splices: list = []
        print(f"{HYMBA} reduced to {layers} layers: {cfg.layer_types()}, {n_meta} meta tokens, "
              f"window {W}")
        device = make_device(n_instances=2, policy="least_loaded", device=dev)
        pool = PagedKVPool(n_device_pages=32, n_host_pages=16, page_tokens=16,
                           kv_dim=2 * cfg.num_kv_heads * cfg.head_dim, dtype=torch.float32,
                           device=device)
        res = serve_card_and_cpu(dev, cfg, HYBRID_SMALL_PROMPTS, max_new=HYBRID_SMALL_NEW,
                                 prompt_seed=9, splices=splices, pin=True, device=device,
                                 kv_pool=pool)
        check(pool.stats.device_pages_used == 0 and not pool.page_table,
              f"KV pages leaked: {pool.stats}")
        kv_pool_round_trip(pool, gen=torch.Generator(device=dev).manual_seed(5))
        check(len(splices) == 2 * len(HYBRID_SMALL_PROMPTS), f"{len(splices)} splices checked")
        check(res["launches"]["flash_attention"] == layers * len(HYBRID_SMALL_PROMPTS),
              f"flash launched {res['launches']['flash_attention']} times serving "
              f"{len(HYBRID_SMALL_PROMPTS)} prompts through {layers} layers")
        res["splices_checked"] = len(splices)
        toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (1, SMALL_RING_PROMPT))
        ring = card_and_cpu_rollout(dev, cfg, {"tokens": torch.from_numpy(toks.astype(np.int32))},
                                    SMALL_STEPS + 1, seed=11)
        total = n_meta + SMALL_RING_PROMPT + SMALL_STEPS
        rings = check_rings(ring.pop("cache"), n_meta, W, total)
        check(rings == sum(t == "local" for t in cfg.layer_types()), f"{rings} rings checked")
        res["ring"] = {k: v for k, v in ring.items() if k != "launches"}
        print(f"ring check: {SMALL_RING_PROMPT}-token prompt and {SMALL_STEPS} decode steps; "
              f"logits max |card - CPU| {ring['logits_err']:.3e}, cache leaves "
              f"{ring['cache_err']:.3e}; {rings} rings hold the {n_meta} meta positions and the "
              f"last {W} of {total}")
        out[f"{HYMBA} {layers}L"] = res
    cfg = dataclasses.replace(get_config(SEAMLESS).reduced(), dtype="float32")
    rng = np.random.default_rng(12)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)),
             "frame_embeds": torch.from_numpy(
                 (rng.normal(size=(2, cfg.encoder.source_len, cfg.d_model)) * 0.02)
                 .astype(np.float32))}
    res = card_and_cpu_rollout(dev, cfg, batch, 13, seed=12)
    res.pop("cache")
    check(res["launches"]["flash_attention"] == 0,
          f"seamless launched flash {res['launches']['flash_attention']} times")
    print(f"{SEAMLESS} reduced ({cfg.encoder.num_layers} + {cfg.num_layers} layers, "
          f"{cfg.encoder.source_len} frames): prefill of 2 x 24 tokens and 12 decode steps, "
          f"logits max |card - CPU| {res['logits_err']:.3e}, cache leaves {res['cache_err']:.3e}; "
          f"launches on the card {res['launches']}")
    out[SEAMLESS] = res
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"phase 3i: torch.cuda.max_memory_allocated {peak} B")
    out["max_memory_allocated"] = peak
    return out


def ring_rollout(model, params, prompt, tokens=None):
    """``prompt`` [1, RING_PROMPT] prefilled and decoded RING_STEPS steps,
    greedy or fed ``tokens`` (a list of [1] tensors, the first from the
    prefill).  Returns (the logits at RING_CHECKS, the tokens, seconds a
    decode step, the final cache)."""
    dev = prompt.device
    cache, logits, _ = model.prefill(params, {"tokens": prompt}, RING_PROMPT + RING_STEPS + 8)
    toks = [logits.argmax(-1).to(torch.int32)] if tokens is None else list(tokens)
    kept = {}
    sync(dev)
    t0 = time.perf_counter()
    for j in range(RING_STEPS):
        logits, cache = model.decode_step(params, cache, toks[j][:, None])
        if tokens is None:
            toks.append(logits.argmax(-1).to(torch.int32))
        if j in RING_CHECKS:
            kept[j] = logits
    sync(dev)
    return kept, toks, (time.perf_counter() - t0) / RING_STEPS, cache


def ring_check(model, params, dev) -> dict:
    """A RING_PROMPT-token prompt decoded RING_STEPS greedy steps at batch 1,
    past the window's ring, in bf16 and, with the weights copied to f32,
    in f32 fed the same tokens; every ring holds the meta positions and
    the last window of positions at the end.  At each of RING_CHECKS the
    step's logits against a fresh prefill of the same prefix: f32 within
    RING_F32_TOL, bf16 within BF16_NOISE_FACTOR x the bf16 rounding noise
    of that prefill (bf16 against f32).  Returns the differences and the
    seconds a decode step."""
    from repro_torch import tree as ttree
    from repro_torch.models.api import build_model

    cfg = model.cfg
    n_meta, W = model.n_meta, cfg.window_size
    check(RING_PROMPT < W < RING_PROMPT + 1 + min(RING_CHECKS),
          "phase 4j's ring checks must come after the ring wraps")
    rng = np.random.default_rng(13)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, RING_PROMPT))
                              .astype(np.int32)).to(dev)
    total = n_meta + RING_PROMPT + RING_STEPS
    p32 = ttree.tree_map(lambda t: t.float(), params)
    m32 = build_model(dataclasses.replace(cfg, dtype="float32"), remat=False,
                      attn_impl=model.attn_impl, device=dev)
    steps, toks, step_s, cache = ring_rollout(model, params, prompt)
    rings = check_rings(cache, n_meta, W, total)
    steps32, _, step32_s, cache = ring_rollout(m32, p32, prompt, toks)
    check(check_rings(cache, n_meta, W, total) == rings, "f32 rings")
    del cache
    out = {"ring_decode_step_s": step_s, "ring_decode_step_f32_s": step32_s,
           "rings_checked": rings, "ring_f32_err": {}, "ring_bf16_err": {}, "ring_bf16_noise": {}}
    for j in RING_CHECKS:
        n = RING_PROMPT + j + 1
        seq = torch.cat([prompt] + [t[:, None] for t in toks[:j + 1]], dim=1)
        _, tf, _ = model.prefill(params, {"tokens": seq}, n + 8)
        _, tf32, _ = m32.prefill(p32, {"tokens": seq}, n + 8)
        check(bool(torch.isfinite(steps[j]).all() and torch.isfinite(steps32[j]).all()),
              "ring check: non-finite logits")
        out["ring_f32_err"][n] = float((steps32[j] - tf32).abs().max())
        out["ring_bf16_err"][n] = float((steps[j] - tf).abs().max())
        out["ring_bf16_noise"][n] = noise = float((tf - tf32).abs().max())
        check(torch.allclose(steps32[j], tf32, **RING_F32_TOL),
              f"ring check, f32: the decode logits after {n} tokens are "
              f"{out['ring_f32_err'][n]} from a fresh prefill's")
        check(out["ring_bf16_err"][n] <= BF16_NOISE_FACTOR * noise,
              f"ring check, bf16: the decode logits after {n} tokens are "
              f"{out['ring_bf16_err'][n]} from a fresh prefill's, more than "
              f"{BF16_NOISE_FACTOR} x the bf16 noise {noise}")
    del p32, m32
    torch.cuda.empty_cache()
    print(f"ring check: a {RING_PROMPT}-token prompt decoded {RING_STEPS} steps at batch 1 "
          f"({step_s * 1e3:.2f} ms a step in bf16, {step32_s * 1e3:.2f} in f32), past the "
          f"{W}-slot ring; logits max |decode - prefill| by length: f32 {out['ring_f32_err']}, "
          f"bf16 {out['ring_bf16_err']} against a bf16 noise of {out['ring_bf16_noise']} "
          f"(|logits| up to {float(tf32.abs().max()):.3f}); {rings} rings hold the {n_meta} "
          f"meta positions and the last {W} of {total}")
    return out


@phase("4j serving hymba-1.5b at full width and depth (bf16, flash)")
def serving_hybrid_full(dev) -> dict:
    """hymba-1.5b (32 layers, d_model 1600, 25 heads over 5 KV heads of 64,
    50 SSD heads of 64 with d_state 16 beside them, 128 meta tokens, a
    1024-token window on all but layers 0, 15 and 31; bf16, 1.64 G
    parameters) served as phase 4d serves tinyllama: 32 x 8 flash launches,
    each admission's spliced slot bit-equal to its batch-1 prefill on every
    leaf (rings and SSM states included); then ``ring_check`` and the
    2048-token prefill's flash against chunked logits."""
    release(dev)
    print(f"held on the card before the phase: {torch.cuda.memory_allocated(dev)} B")
    torch.cuda.reset_peak_memory_stats(dev)
    out = serve_full(dev, hybrid_cfg())
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    print(f"phase 4j: torch.cuda.max_memory_allocated {out['max_memory_allocated']} B")
    return out


@phase("4k seamless-m4t-medium at full width and depth through the model API (bf16)")
def encdec_full(dev) -> dict:
    """seamless-m4t-medium (12 encoder and 12 decoder layers, d_model 1024,
    16 heads of 64, vocab 256206; bf16, 0.98 G parameters) through
    ``prefill`` and ``decode_step``: ENCDEC_BATCH x ENCDEC_PROMPT tokens
    over 160 frame embeddings, ENCDEC_NEW greedy steps, no flash launch
    (chunked attention, as the reference); the last step's logits against
    a teacher-forced prefill of the whole sequence within TEACHER_TOL."""
    from repro_torch import tree as ttree
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model

    cfg = get_config(SEAMLESS)
    release(dev)
    base = torch.cuda.memory_allocated(dev)
    print(f"held on the card before the phase: {base} B")
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, remat=False, attn_impl="flash", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(5))
    n_params = sum(t.numel() for t in ttree.leaves(params))
    rng = np.random.default_rng(14)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (ENCDEC_BATCH, ENCDEC_PROMPT))
                                        .astype(np.int32)),
             "frame_embeds": torch.from_numpy(
                 (rng.normal(size=(ENCDEC_BATCH, cfg.encoder.source_len, cfg.d_model)) * 0.02)
                 .astype(np.float32)).to(torch.bfloat16)}
    reset_counts()
    logits, fed, prefill_s, decode_s, cache = rollout(model, params, batch, ENCDEC_NEW, dev)
    counts = read_counts(("flash_attention",))
    del cache
    check(counts["flash_attention"] == 0, f"seamless launched flash: {counts}")
    check(all(bool(torch.isfinite(lg).all()) and lg.shape == (ENCDEC_BATCH, cfg.vocab_size)
              for lg in logits), "seamless logits: not finite, or of another shape")
    seq = torch.cat([batch["tokens"]] + [t[:, None] for t in fed], dim=1).to(dev)
    t0 = time.perf_counter()
    _, tf, _ = model.prefill(params, {"tokens": seq, "frame_embeds": batch["frame_embeds"].to(dev)},
                             seq.shape[1])
    sync(dev)
    tf_s = time.perf_counter() - t0
    err = float((logits[-1] - tf).abs().max())
    check(torch.allclose(logits[-1], tf, **TEACHER_TOL),
          f"seamless: the last decode step's logits are {err} from the teacher-forced prefill's")
    peak = torch.cuda.max_memory_allocated(dev)
    out = {"params": n_params, "prefill_s": prefill_s, "decode_step_s": decode_s / (ENCDEC_NEW - 1),
           "teacher_forced_prefill_s": tf_s, "teacher_forced_err": err,
           "logits_absmax": float(tf.abs().max()), "launches": counts,
           "peak_bytes": peak - base, "max_memory_allocated": peak}
    print(f"{cfg.name}: {cfg.encoder.num_layers} + {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n_params} params; prefill of {ENCDEC_BATCH} x {ENCDEC_PROMPT} tokens "
          f"over {cfg.encoder.source_len} frames {prefill_s:.4f} s, {ENCDEC_NEW - 1} decode "
          f"steps {decode_s:.4f} s ({out['decode_step_s'] * 1e3:.2f} ms a step); the last "
          f"step's logits max |decode - teacher-forced prefill| {err:.3e} (|logits| up to "
          f"{out['logits_absmax']:.3f}; the {seq.shape[1]}-token prefill {tf_s:.4f} s); "
          f"launches {counts}; torch.cuda.max_memory_allocated {peak} B")
    return out


# --------------------------------------------------------------------------- phase 6
def crc_launches(dev, gen, big: int = GiB) -> dict:
    """Launches of one ``ops.crc32`` at 4 KiB .. ``big`` bytes, by kernel,
    each counted from 0.  A chunk of W <= SUB_WORDS words keeps one CRC
    launch and no sub-chunk fold (4 KiB: 256 chunks of 4 words, then the
    fold of their states); a longer one adds the fold of its sub-chunk
    CRCs."""
    from repro_torch.kernels import crc32, ops

    src = rand_words(gen, big // 4, dev)
    out = {}
    for nbytes in (4 * KiB, MiB, 64 * MiB, big):
        reset_counts()
        ops.crc32(src[:nbytes // 4])
        out[nbytes] = read_counts(("crc32_chunk_states", "gf2_fold"))
        W = nbytes // 4 // ops._pick_chunks(nbytes // 4)
        sub_fold = int(crc32.subchunk_plan(W)[0] > 1)
        check(out[nbytes] == {"crc32_chunk_states": 1, "gf2_fold": 1 + sub_fold},
              f"ops.crc32 of {nbytes} B launched {out[nbytes]}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"launches of one ops.crc32, by size in bytes: {out}")
    return out


# --------------------------------------------------------------------------- phase 5
def cold_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device time of one call of ``fn`` with the L2 flushed before
    it.  Each call sits between its own pair of CUDA events; a spin kernel
    parks the stream first, so the host queues every flush and call before
    the card runs them back to back and the host's per-call cost does not
    show as device time (a plain version slower on the host than the spin
    shows its host time, which is its real cost)."""
    from repro_torch.calibrate import HOST_CALL_S, SPIN_HZ

    fn()
    torch.cuda.synchronize()
    pairs = []
    torch.cuda._sleep(int(reps * 2 * HOST_CALL_S * SPIN_HZ))
    for _ in range(reps):
        flush.max()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def interleaved_ms(fns: dict, reps: int, flush: torch.Tensor) -> dict:
    """Median device time of one call of each function of ``fns`` (name ->
    function), their calls interleaved: round r calls each once, in turns
    forward and backward, with the L2 flushed before each call and each
    call between its own pair of CUDA events.  A spin parks the stream
    before each round, as in ``cold_ms``.  Two designs compared this way
    share the card's clock and neighbours call by call."""
    from repro_torch.calibrate import HOST_CALL_S, SPIN_HZ

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    names = list(fns)
    pairs = {name: [] for name in names}
    for r in range(reps):
        torch.cuda._sleep(int(len(names) * 2 * HOST_CALL_S * SPIN_HZ))
        for name in (names if r % 2 == 0 else names[::-1]):
            flush.max()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fns[name]()
            e1.record()
            pairs[name].append((e0, e1))
    torch.cuda.synchronize()
    return {name: statistics.median(a.elapsed_time(b) for a, b in pairs[name])
            for name in names}


def device_work(fn) -> list:
    """(name, device µs) of each kernel and memset that one call of ``fn``
    put on the card, in order, from ``torch.profiler``'s trace of the
    call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us())
            for e in sorted(prof.events(), key=lambda e: e.time_range.start)
            if e.device_type == torch.autograd.DeviceType.CUDA]


def mem_bps() -> float:
    name = torch.cuda.get_device_name(0)
    return next((bps for word, bps in MEM_BPS if word in name), H100_SXM_MEM_BPS)


def _bound(nbytes: float, ops: float = 0.0):
    t_bytes = nbytes / mem_bps() * 1e3
    t_ops = ops / H100_SXM_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@phase("5 times")
def times(dev, gen, pool, plain_words: int = MiB // 4, big: int = GiB,
          leaf_bytes: int = 256 * MiB) -> list:
    from repro_torch.kernels import batch_copy, crc32, fused, memcpy, ops

    tabs = ops._tables(dev)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev).zero_()
    rows = []

    def row(name, shape, nbytes_moved, ops_count, ms, plain_ms, plain_shape,
            library_ms, library_call=None):
        bound_ms, bound_by = _bound(nbytes_moved, ops_count)
        r = {"name": name, "shape": shape, "ms": ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "plain_ms": plain_ms, "plain_shape": plain_shape,
             "library_ms": library_ms}
        if library_call:
            r["library_call"] = library_call
        rows.append(r)
        print(f"{name:20s} {shape:28s} {ms:10.4f} ms  bound {bound_ms:.4f} ms ({bound_by})  "
              f"plain {plain_ms:.4f} ms at {plain_shape}  library {library_ms}")

    # memcpy_words at 1 GiB; its plain version (clone) and Tensor.copy_ too
    src = rand_words(gen, big // 4, dev)
    dst = torch.empty_like(src)
    row("memcpy_words", "[268435456] u32 (1 GiB)", 2 * big, 0,
        cold_ms(lambda: memcpy.memcpy_words(src), 5, flush),
        cold_ms(lambda: memcpy.memcpy_words_plain(src), 5, flush), "[268435456] u32",
        cold_ms(lambda: dst.copy_(src), 5, flush), "Tensor.copy_")
    for nbytes in (4 * KiB, MiB, 64 * MiB):
        s = src[:nbytes // 4]
        print(f"  memcpy_words at {nbytes} B (cold L2): "
              f"{cold_ms(lambda: memcpy.memcpy_words(s), 50, flush):.4f} ms")
    del dst
    # CRC at 1 GiB: C = 256 chains of 1 Mi words, then the fold
    C = ops._pick_chunks(big // 4)
    data = src.view(C, -1)
    small = src[:plain_words].view(ops._pick_chunks(plain_words), -1)
    row("crc32_chunk_states", f"[{C}, {data.shape[1]}] u32 (1 GiB)", big + 4 * C,
        CRC_OPS_PER_WORD * (big // 4),
        cold_ms(lambda: crc32.crc32_chunk_states(data, tabs), 10, flush),
        cold_ms(lambda: crc32.crc32_chunk_states_plain(small, tabs), 3, flush),
        f"[{small.shape[0]}, {small.shape[1]}] u32", None)
    print(f"  crc32_chunk_states at {tuple(small.shape)} (cold L2): "
          f"{cold_ms(lambda: crc32.crc32_chunk_states(small, tabs), 20, flush):.4f} ms")
    for nbytes in (4 * KiB, MiB, 64 * MiB):
        s = src[:nbytes // 4]
        d = s.view(ops._pick_chunks(s.numel()), -1)
        print(f"  crc32_chunk_states at {nbytes} B {tuple(d.shape)} (cold L2): "
              f"{cold_ms(lambda: crc32.crc32_chunk_states(d, tabs), 10, flush):.4f} ms")
    states = crc32.crc32_chunk_states(data, tabs)
    mat = ops._shift_mat(data.shape[1] * 4, dev)
    row("gf2_fold", f"[{C}] u32 states", 4 * C + 128 + 4, 2 * 32 * (C - 1),
        cold_ms(lambda: crc32.combine_chunk_crcs(states, mat), 50, flush),
        cold_ms(lambda: crc32.combine_chunk_crcs_plain(states, mat), 3, flush),
        f"[{C}] u32 states", None)
    S, _ = crc32.subchunk_plan(data.shape[1])
    sub = rand_words(gen, C * S, dev).view(C, S)
    sub_mat = ops._shift_mat(4 * crc32.SUB_WORDS, dev)
    print(f"  fold_crcs at the sub-chunk CRCs of 1 GiB {tuple(sub.shape)} (cold L2): "
          f"{cold_ms(lambda: crc32.fold_crcs(sub, sub_mat), 20, flush):.4f} ms")
    # ops.crc32 end to end: the chunk choice, the CRC pair and its folds
    for nbytes in (4 * KiB, MiB, 64 * MiB, big):
        s = src[:nbytes // 4]
        ms = cold_ms(lambda: ops.crc32(s), 10, flush)
        bound_ms = _bound(nbytes)[0]
        print(f"  ops.crc32 end to end at {nbytes} B (cold L2): {ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms (bytes), {ms / bound_ms:.2f}x the bound")
    del data, src, sub
    # copy + CRC of the 256 MiB checkpoint leaf
    leaf = rand_words(gen, leaf_bytes // 4, dev)
    C = ops._pick_chunks(leaf.numel())
    ldata = leaf.view(C, -1)
    row("copy_crc_words", f"[{C}, {ldata.shape[1]}] u32 (256 MiB)", 2 * leaf_bytes + 4 * C,
        CRC_OPS_PER_WORD * leaf.numel(),
        cold_ms(lambda: fused.copy_crc_words(ldata, tabs), 10, flush),
        cold_ms(lambda: fused.copy_crc_words_plain(small, tabs), 3, flush),
        f"[{small.shape[0]}, {small.shape[1]}] u32", None)
    del leaf, ldata
    # batch copy: 1024 pages of 16 KiB within a 4096-page pool
    src_pool, dst_pool, si, di = pool
    n, pw = si.numel(), src_pool.shape[1]
    gathered = src_pool.view(torch.int32).index_select(0, si.long())
    dl = di.long()
    dst32 = dst_pool.view(torch.int32)
    row("batch_copy_pages", f"{n} x [{pw}] u32 pages", 2 * n * pw * 4 + 8 * n, 0,
        cold_ms(lambda: batch_copy.batch_copy_pages(src_pool, dst_pool, si, di), 50, flush),
        cold_ms(lambda: batch_copy.batch_copy_pages_plain(src_pool, dst_pool, si, di), 20, flush),
        f"{n} x [{pw}] u32 pages",
        cold_ms(lambda: dst32.index_copy_(0, dl, gathered), 50, flush),
        "Tensor.index_copy_ of the pre-gathered pages (unique destinations)")
    return rows


@phase("5b slice-2 times")
def times_2(dev, gen, shapes, big: int = GiB) -> list:
    from repro_torch.kernels import compare, delta_apply, delta_create, fill
    from repro_torch.kernels.ref import int32_bits

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev).zero_()
    rows = []

    def row(name, shape, nbytes_moved, ms, plain_ms, library_ms, library_call=None):
        bound_ms, bound_by = _bound(nbytes_moved)
        r = {"name": name, "shape": shape, "ms": ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "plain_ms": plain_ms, "plain_shape": shape,
             "library_ms": library_ms}
        if library_call:
            r["library_call"] = library_call
        rows.append(r)
        print(f"{name:20s} {shape:28s} {ms:10.4f} ms  bound {bound_ms:.4f} ms ({bound_by})  "
              f"plain {plain_ms:.4f} ms  library {library_ms}")

    # fill of 1 GiB with a 1-word pattern; Tensor.fill_ computes the same
    n = big // 4
    pat = (0x5A5A5A5A,)
    dst32 = torch.empty(n, dtype=torch.int32, device=dev)
    # the kernel and fill_ within 3 % of each other: interleaved call by call
    ms = interleaved_ms({"fill_words": lambda: fill.fill_words(n, pat, device=dev),
                         "Tensor.fill_": lambda: dst32.fill_(int32_bits(pat[0]))}, 30, flush)
    row("fill_words", "[268435456] u32 (1 GiB)", big, ms["fill_words"],
        cold_ms(lambda: fill.fill_words_plain(n, pat, device=dev), 5, flush),
        ms["Tensor.fill_"], "Tensor.fill_ (interleaved with the kernel, 30 calls each)")
    for nbytes in (4 * KiB, MiB, 64 * MiB):
        print(f"  fill_words at {nbytes} B (cold L2): "
              f"{cold_ms(lambda: fill.fill_words(nbytes // 4, pat, device=dev), 50, flush):.4f} ms")
    # compare of two equal 1 GiB buffers (every word read); torch.equal
    # computes the equality half
    a = rand_words(gen, n, dev)
    b = a.clone()
    a32, b32 = a.view(torch.int32), b.view(torch.int32)
    row("compare_words", "2 x [268435456] u32 (1 GiB each)", 2 * big,
        cold_ms(lambda: compare.compare_words(a, b), 5, flush),
        cold_ms(lambda: compare.compare_words_plain(a, b), 5, flush),
        cold_ms(lambda: torch.equal(a32, b32), 5, flush),
        "torch.equal (the equality half only; returns to the host)")
    for nbytes in (4 * KiB, MiB, 64 * MiB):
        sa, sb = a[:nbytes // 4], b[:nbytes // 4]
        print(f"  compare_words at {nbytes} B (cold L2): "
              f"{cold_ms(lambda: compare.compare_words(sa, sb), 50, flush):.4f} ms")
    del a, b, a32, b32, dst32
    # the checkpoint leaf: 256 MiB, 0.5 % of its words changed, cap 25 %
    lw, new_w, cap, offsets, data = shapes["delta"]
    nb = lw.numel() * 4
    shape = f"[{lw.numel()}] u32 (256 MiB), cap {cap}"
    row("delta_record_words", shape, 2 * nb + 8 * cap,
        cold_ms(lambda: delta_create.delta_record_words(new_w, lw, cap), 5, flush),
        cold_ms(lambda: delta_create.delta_record_words_plain(new_w, lw, cap), 5, flush),
        None)
    # apply reads the offsets, and the data word of each valid entry only
    valid = (offsets >= 0) & (offsets < lw.numel())
    n_valid = int(valid.sum())
    lw32, vidx, vwords = lw.view(torch.int32), offsets[valid].long(), data.view(torch.int32)[valid]
    row("delta_apply_words", shape, 2 * nb + 4 * cap + 4 * n_valid,
        cold_ms(lambda: delta_apply.delta_apply_words(lw, offsets, data), 20, flush),
        cold_ms(lambda: delta_apply.delta_apply_words_plain(lw, offsets, data), 5, flush),
        cold_ms(lambda: lw32.index_put((vidx,), vwords), 20, flush),
        "Tensor.index_put of the valid entries through int32 views (the entries "
        "filtered before timing; unique offsets, so the same result)")
    check(torch.equal(lw32.index_put((vidx,), vwords),
                      delta_apply.delta_apply_words(lw, offsets, data).view(torch.int32)),
          "index_put of the leaf's record differs from delta_apply_words")
    flush.max()
    work = device_work(lambda: delta_apply.delta_apply_words(lw, offsets, data))
    print(f"  delta_apply_words on the leaf: {n_valid} valid entries of {cap}; device work "
          f"of one call after an L2 flush (torch.profiler, µs): "
          + "; ".join(f"{name.split('(')[0]} {us:.1f}" for name, us in work))
    # DIF over 1 MiB of 512-byte blocks: the CRC kernel with one chunk a block;
    # its bound reads the data and writes the framed blocks once each
    from repro_torch.kernels import crc32, dif, ops
    blocks = shapes["dif"]
    tabs = ops._tables(dev)
    words = blocks.reshape(-1)
    framed_bytes = blocks.shape[0] * (blocks.shape[1] + 2) * 4
    dif_bound, dif_by = _bound(words.numel() * 4 + framed_bytes)
    print(f"  crc32_chunk_states at the DIF shape {tuple(blocks.shape)} (cold L2): "
          f"{cold_ms(lambda: crc32.crc32_chunk_states(blocks, tabs), 20, flush):.4f} ms")
    print(f"  dif_insert of {words.numel() * 4} B in {blocks.shape[0]} blocks (cold L2): "
          f"{cold_ms(lambda: dif.dif_insert(words), 20, flush):.4f} ms, "
          f"bound {dif_bound:.6f} ms ({dif_by}: the data read and the framed blocks "
          f"written once)")
    return rows


# --------------------------------------------------------------------------- phase 5c
@phase("5c slice-3 times")
def times_3(dev, gen, big: int = GiB) -> list:
    from repro_torch.kernels import compare, dualcast, fused
    from repro_torch.kernels.ref import int32_bits

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev).zero_()
    rows = []

    def row(name, shape, nbytes_moved, ms, plain_ms, library_ms, library_call):
        bound_ms, bound_by = _bound(nbytes_moved)
        rows.append({"name": name, "shape": shape, "ms": ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "plain_ms": plain_ms, "plain_shape": shape,
                     "library_ms": library_ms, "library_call": library_call})
        print(f"{name:20s} {shape:28s} {ms:10.4f} ms  bound {bound_ms:.4f} ms ({bound_by})  "
              f"plain {plain_ms:.4f} ms  library {library_ms:.4f} ms ({library_call})")

    n = big // 4
    shape = "[268435456] u32 (1 GiB)"
    # dualcast: one read, two writes; the library does it as two copies
    src = rand_words(gen, n, dev)
    d1, d2 = torch.empty_like(src), torch.empty_like(src)
    row("dualcast_words", shape, 3 * big,
        cold_ms(lambda: dualcast.dualcast_words(src), 5, flush),
        cold_ms(lambda: dualcast.dualcast_words_plain(src), 5, flush),
        cold_ms(lambda: (d1.copy_(src), d2.copy_(src)), 5, flush), "2 x Tensor.copy_")
    for nbytes in (4 * KiB, MiB, 64 * MiB):
        s = src[:nbytes // 4]
        print(f"  dualcast_words at {nbytes} B (cold L2): "
              f"{cold_ms(lambda: dualcast.dualcast_words(s), 50, flush):.4f} ms")
    del src, d1, d2
    # compare-pattern of a buffer that holds the 4-word pattern (every word
    # read); the library: torch.eq of the [n/p, p] view, .all(), on the card
    pat = (0x5A5A5A5A, 7, 0xFFFFFFFF, 0)
    a, _, _ = fused.fill_verify_words(n, pat, device=dev)
    a32 = a.view(torch.int32)
    pat32 = torch.tensor([int32_bits(w) for w in pat], dtype=torch.int32, device=dev)
    row("compare_pattern_words", shape + ", 4-word pattern", big,
        cold_ms(lambda: compare.compare_pattern_words(a, pat), 5, flush),
        cold_ms(lambda: compare.compare_pattern_words_plain(a, pat), 5, flush),
        cold_ms(lambda: torch.eq(a32.view(-1, 4), pat32).all(), 5, flush),
        "torch.eq(a.view(-1, 4), pattern).all()")
    for nbytes in (4 * KiB, MiB, 64 * MiB):
        s = a[:nbytes // 4]
        print(f"  compare_pattern_words at {nbytes} B (cold L2): "
              f"{cold_ms(lambda: compare.compare_pattern_words(s, pat), 50, flush):.4f} ms")
    del a, a32
    # fill-verify with a 1-word pattern; the library: Tensor.fill_, then the
    # compare above
    pat1 = (0x5A5A5A5A,)
    dst = torch.empty(n, dtype=torch.int32, device=dev)
    p1 = torch.tensor([int32_bits(pat1[0])], dtype=torch.int32, device=dev)
    row("fill_verify_words", shape + ", 1-word pattern", big,
        cold_ms(lambda: fused.fill_verify_words(n, pat1, device=dev), 5, flush),
        cold_ms(lambda: fused.fill_verify_words_plain(n, pat1, device=dev), 5, flush),
        cold_ms(lambda: torch.eq(dst.fill_(int32_bits(pat1[0])).view(-1, 1), p1).all(), 5,
                flush),
        "Tensor.fill_ then torch.eq(x.view(-1, 1), pattern).all()")
    for nbytes in (4 * KiB, MiB, 64 * MiB):
        print(f"  fill_verify_words at {nbytes} B (cold L2): "
              f"{cold_ms(lambda: fused.fill_verify_words(nbytes // 4, pat1, device=dev), 50, flush):.4f} ms")
    return rows


# --------------------------------------------------------------------------- phase 5d
@phase("5d flash attention times")
def times_4(dev, gen) -> list:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev).zero_()
    B, S, H, KV, hd = 1, 2048, 32, 4, 64
    q, k, v = flash_inputs(gen, dev, B, S, S, H, KV, hd, torch.bfloat16)
    try:
        F.scaled_dot_product_attention(q[:, :1].transpose(1, 2), k[:, :1].transpose(1, 2),
                                       v[:, :1].transpose(1, 2), enable_gqa=True)
        gqa = True
        call = "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True) on [B,H,S,hd] views"
    except TypeError:  # a torch without enable_gqa: the KV heads expanded first
        gqa = False
        call = "F.scaled_dot_product_attention(is_causal=True) on KV heads expanded beforehand"

    def sdpa(q, k, v):
        """The library call on [B, S, heads, hd] tensors, as a thunk."""
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if not gqa:
            kt, vt = kt.repeat_interleave(H // KV, 1), vt.repeat_interleave(H // KV, 1)
        kw = dict(enable_gqa=True) if gqa else {}
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, **kw)

    lib = sdpa(q, k, v)
    sdpa_err = float((lib().transpose(1, 2).float() - fa.flash_attention(q, k, v).float())
                     .abs().max())
    pairs = B * S * (S + 1) // 2  # visible (query, key) pairs of a causal mask
    flops = 4 * H * hd * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    t_ops = flops / H100_SXM_BF16_OPS * 1e3
    t_bytes = nbytes / mem_bps() * 1e3
    bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    shape = f"q [{B}, {S}, {H}, {hd}], k/v [{B}, {S}, {KV}, {hd}] bf16, causal"
    row = {"name": "flash_attention", "shape": shape,
           "ms": cold_ms(lambda: fa.flash_attention(q, k, v), 20, flush),
           "plain_ms": cold_ms(lambda: fa.flash_attention_plain(q, k, v), 5, flush),
           "plain_shape": shape, "library_ms": cold_ms(lib, 20, flush), "library_call": call,
           "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"flash_attention {shape}: {row['ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{flops} FLOP at {H100_SXM_BF16_OPS:.3g}/s, {nbytes} B at {mem_bps():.3g} B/s), "
          f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms ({call}); "
          f"max |kernel - library| {sdpa_err:.3e}")
    for n in FULL_PROMPTS[1:]:
        qs, ks, vs = q[:, :n].contiguous(), k[:, :n].contiguous(), v[:, :n].contiguous()
        print(f"  flash_attention at the {n}-token prefill (cold L2): "
              f"{cold_ms(lambda: fa.flash_attention(qs, ks, vs), 20, flush):.4f} ms")
    for hd_other in (128, 256):  # the other head dims the configs use, at the same S and H
        qh, kh, vh = flash_inputs(gen, dev, B, S, S, H, KV, hd_other, torch.bfloat16)
        bound_other = flops * hd_other // hd / H100_SXM_BF16_OPS * 1e3
        print(f"  flash_attention at hd {hd_other} (cold L2): "
              f"{cold_ms(lambda: fa.flash_attention(qh, kh, vh), 20, flush):.4f} ms, "
              f"SDPA {cold_ms(sdpa(qh, kh, vh), 20, flush):.4f} ms, "
              f"bound {bound_other:.4f} ms (operations)")
    row["prefill_shapes"] = [flash_at(dev, gen, flush, name, *shape, gqa=gqa)
                             for name, shape in PREFILL_FLASH_SHAPES]
    return [row]


#: phase 5d's prefill shapes of the models served since slice 9: (B, S, H,
#: KV, hd, window, n_meta), causal; hymba-1.5b's at its 2048-token prompt
#: behind the 128 meta tokens, a local layer and a global one
PREFILL_FLASH_SHAPES = (("gemma3-1b prefill", (1, 2048, 4, 1, 256, 1024, 0)),
                        ("qwen2-vl-2b prefill", (1, 2048, 12, 2, 128, 0, 0)),
                        ("deepseek-moe-16b prefill", (1, 2048, 16, 16, 128, 0, 0)),
                        ("hymba-1.5b local-layer prefill", (1, 2176, 25, 5, 64, 1024, 128)),
                        ("hymba-1.5b global-layer prefill", (1, 2176, 25, 5, 64, 0, 128)))


def flash_at(dev, gen, flush, name, B, S, H, KV, hd, window, n_meta, *, gqa: bool) -> dict:
    """The kernel at one causal bf16 shape beside its bound (over the (q, k)
    pairs the mask leaves visible), its plain version and
    ``scaled_dot_product_attention``: ``is_causal`` without a window; with
    one an explicit boolean ``attn_mask`` (the meta keys in it), which
    SDPA's flash backend does not take, so it runs another of its
    backends."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    q, k, v = flash_inputs(gen, dev, B, S, S, H, KV, hd, torch.bfloat16)
    kw = dict(causal=True, window=window, n_meta=n_meta)
    pos = torch.arange(S, device=dev)
    mask = fa.mask_block(pos, pos, causal=True, window=window, n_meta=n_meta)
    pairs = B * int(mask.sum())
    flops = 4 * H * hd * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    t_ops = flops / H100_SXM_BF16_OPS * 1e3
    t_bytes = nbytes / mem_bps() * 1e3
    bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if not gqa:
        kt, vt = kt.repeat_interleave(H // KV, 1), vt.repeat_interleave(H // KV, 1)
    lib_kw = dict(enable_gqa=True) if gqa else {}
    if window:
        lib_kw["attn_mask"] = mask
        call = "F.scaled_dot_product_attention(attn_mask=<bool [S, S]>)"
    else:
        lib_kw["is_causal"] = True
        call = "F.scaled_dot_product_attention(is_causal=True)"

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)

    got = fa.flash_attention(q, k, v, **kw)
    lib_err = float((lib().transpose(1, 2).float() - got.float()).abs().max())
    plain_err = float((fa.flash_attention_plain(q, k, v, **kw).float() - got.float())
                      .abs().max())
    out = {"name": name, "shape": f"q [{B}, {S}, {H}, {hd}], k/v [{B}, {S}, {KV}, {hd}] bf16, "
                                  f"causal, window {window}, n_meta {n_meta}",
           "ms": cold_ms(lambda: fa.flash_attention(q, k, v, **kw), 20, flush),
           "plain_ms": cold_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 5, flush),
           "library_ms": cold_ms(lib, 20, flush), "library_call": call,
           "bound_ms": bound_ms, "bound_by": bound_by, "flop": flops, "visible_pairs": pairs,
           "max_abs_err_library": lib_err, "max_abs_err_plain": plain_err}
    print(f"  flash_attention at the {name} shape ({out['shape']}): {out['ms']:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {flops} FLOP over {pairs} visible pairs, {nbytes} B), "
          f"plain {out['plain_ms']:.4f} ms, library {out['library_ms']:.4f} ms ({call}); "
          f"max |kernel - library| {lib_err:.3e}, |kernel - plain| {plain_err:.3e}")
    return out


# --------------------------------------------------------------------------- main
# --------------------------------------------------------------------------- phase 2e
#: phase 2e's shapes, (B, S, H, KV, hd): the reference test's f32 case, and
#: tinyllama-1.1b's attention at its 2048-token context in bf16, at batch 1
#: and at phase 4e(i)'s batch of 8
FLASH_BWD_CASES = ((torch.float32, (1, 128, 4, 2, 32)), (torch.bfloat16, (1, 2048, 32, 4, 64)),
                   (torch.bfloat16, (8, 2048, 32, 4, 64)))
#: f32: the JAX package's tolerance for its custom VJP.  bf16: both
#: backwards are the same chunked recompute, fed the cotangent of their own
#: forward (outputs within 2 bf16 ulps of each other, FLASH_TOL) and
#: rounded to bf16, so flash's gradients must stay within
#: FLASH_BWD_BF16_ULPS ulps of the largest entry of the chunked path's
#: (an ulp of x is 2^(floor(log2 |x|) - 7)); the chunked backward in bf16
#: against itself in f32 (the bf16 noise) is printed beside it
FLASH_BWD_F32_TOL = dict(atol=2e-4, rtol=2e-4)
FLASH_BWD_BF16_ULPS = 4


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


@phase("2e flash attention's backward against the chunked path's")
def flash_backward(dev, gen, cases=FLASH_BWD_CASES) -> dict:
    """Gradients of ``attention_trainable(impl="flash")`` (the kernel
    forward, the chunked recompute backward) against those of the plain
    chunked ``attention``, both on the card, under ``torch.func.grad`` and
    ``.backward()``.  The loss is half the squared output, so the output
    cotangent is the forward's own output and the kernel's forward feeds
    the backward."""
    from repro_torch.models import layers as L

    def loss(impl):
        def f(q, k, v):
            o = (L.attention_trainable(q, k, v, impl="flash") if impl == "flash"
                 else L.attention(q, k, v))
            return 0.5 * torch.sum(o.float() ** 2)
        return f

    out = {}
    for dtype, (B, S, H, KV, hd) in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=gen.device).to(dtype).to(dev)
                   for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
        want = torch.func.grad(loss("chunked"), argnums=(0, 1, 2))(q, k, v)
        got = {"torch.func.grad": torch.func.grad(loss("flash"), argnums=(0, 1, 2))(q, k, v)}
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        loss("flash")(*leaves).backward()
        got[".backward()"] = [t.grad for t in leaves]
        name = f"{str(dtype).split('.')[-1]} [{B},{S},{H},{hd}]/[{B},{S},{KV},{hd}]"
        if dtype == torch.float32:
            errs = {how: max(float((a - b).abs().max()) for a, b in zip(g, want))
                    for how, g in got.items()}
            for how, g in got.items():
                check(all(torch.allclose(a, b, **FLASH_BWD_F32_TOL) for a, b in zip(g, want)),
                      f"flash gradients under {how} ({name}) differ from the chunked path's "
                      f"by {errs[how]}")
            out[name] = {"max_err": errs, "tol": FLASH_BWD_F32_TOL}
        else:
            f32 = torch.func.grad(loss("chunked"), argnums=(0, 1, 2))(
                q.float(), k.float(), v.float())
            noise = [float((a.float() - b).abs().max()) for a, b in zip(want, f32)]
            scale = [float(a.float().abs().max()) for a in want]
            errs = {how: [float((a.float() - b.float()).abs().max()) for a, b in zip(g, want)]
                    for how, g in got.items()}
            tol = [FLASH_BWD_BF16_ULPS * bf16_ulp(m) for m in scale]
            for how, e in errs.items():
                check(all(torch.isfinite(a).all() for a in got[how]),
                      f"flash gradients under {how} ({name}) are not finite")
                check(all(x <= t for x, t in zip(e, tol)),
                      f"flash gradients under {how} ({name}) differ from the chunked path's "
                      f"by {e} (dq, dk, dv), more than {FLASH_BWD_BF16_ULPS} bf16 ulps of "
                      f"their largest entries {scale}")
            out[name] = {"max_err": errs, "tol": tol, "bf16_noise": noise,
                         "max_abs_grad": scale}
        print(f"flash backward {name}: " + json.dumps(out[name]))
    return out


# --------------------------------------------------------------------------- phase 3e
#: the kernels of the traced main path (phase 3e): copies, CRCs (and their
#: fold), fills and a fused batch copy
SLICE8_TRACED = ("memcpy_words", "crc32_chunk_states", "gf2_fold", "fill_words",
                 "batch_copy_pages")


def _traced_wait_policy(dev, gen, wait_policy: str, sizes) -> dict:
    """One traced device under ``wait_policy``, with a Sampler attached, over
    copies, CRCs, fills and a fused batch at ``sizes``, a ``.then`` chain and
    an ``after=`` fence.  Checks the phases, the edges, the host-free
    fraction against WaitStats, the Perfetto export and the Sampler's
    deltas against the telemetry snapshot."""
    from repro_torch.core import OpType, WorkDescriptor, make_device
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.kernels import ref
    from repro_torch.obs import PHASES, host_free_fraction, phase_breakdown, to_perfetto

    device = make_device(n_instances=2, policy="least_loaded", wait_policy=wait_policy,
                         trace=1.0, device=dev)
    tel = Telemetry(device)
    sampler = device.observe(interval_s=0.005)
    plain = []
    edges_want = []
    for nbytes in sizes:
        x = rand_words(gen, nbytes // 4, dev)
        a = device.memcpy_async(x)
        b = device.memcpy_async(x, after=[a])
        crc = device.crc32_async(x)
        hexed = crc.then(lambda c: int(c)).then(lambda c: f"0x{c:08x}")
        fill = device.fill_async((0xDEADBEEF, 7), nbytes // 4)
        parts = list(x.view(4, -1))
        batch = device.batch_async([WorkDescriptor(op=OpType.MEMCPY, src=p) for p in parts])
        device.wait_all([a, b, crc, hexed, fill, batch])
        # and 8 copies each waited for on its own, as Fig. 11's loop waits
        for _ in range(8):
            f = device.memcpy_async(x)
            f.wait()
            plain.append(f)
        check(same_bits(a.result(), x) and same_bits(b.result(), x), f"traced copies {nbytes} B")
        check(hexed.result() == f"0x{ref.crc32_ref(x):08x}", f"traced crc32 {nbytes} B != zlib")
        check(all(same_bits(o, p) for o, p in zip(batch.result(), parts)),
              f"traced batch {nbytes} B")
        pat = fill.result().view(torch.int32)[:4].tolist()
        check(pat == [0xDEADBEEF - (1 << 32), 7, 0xDEADBEEF - (1 << 32), 7],
              f"traced fill {nbytes} B")
        plain += [a, b, crc, fill, batch]
        edges_want += [(a.trace.desc_id, b.trace.desc_id, "after"),
                       (crc.trace.desc_id, hexed.parent.trace.desc_id, "then")]
        del x, parts
    device.drain()
    sampler.stop()
    for f in plain:
        check(f.trace is not None and set(f.trace.phase_durations()) == set(PHASES),
              f"{wait_policy}: a traced {f.op} lacks phases: "
              f"{sorted(f.trace.phase_durations()) if f.trace else None}")
    edges = set(device.tracer.edges())
    check(all(e in edges for e in edges_want), f"{wait_policy}: .then / after edges missing")
    # the tracer's host-free fraction and WaitStats' are the same numbers
    frac = host_free_fraction(device.tracer)
    busy = sum(s.busy_s for s in device.wait_stats.values())
    free = sum(s.free_s for s in device.wait_stats.values())
    check(busy + free > 0, f"{wait_policy}: no wait was billed")
    check(frac == free / (busy + free),
          f"{wait_policy}: host-free {frac} from the tracer, {free / (busy + free)} from WaitStats")
    doc = json.loads(to_perfetto(device.tracer))
    evs = [e for e in doc["traceEvents"] if "ts" in e]
    check(evs and all(e["ts"] >= 0 and e.get("dur", 0) >= 0 for e in evs),
          f"{wait_policy}: Perfetto export has negative times")
    check({e["name"] for e in evs if e.get("ph") == "X"} >= set(PHASES),
          f"{wait_policy}: Perfetto export lacks phases")
    snap = tel.snapshot()
    for key, col in (("bytes", "bytes"), ("count", "ops")):
        want = sum(c[key] for e in snap["engines"].values() for c in e["ops"].values())
        got = sum(t[col] for t in sampler.totals["engines"].values())
        check(got == want, f"{wait_policy}: the Sampler's {col} {got} != telemetry's {want}")
    return {"host_free": frac, "breakdown": phase_breakdown(device.tracer),
            "ticks": sampler.totals["device"]["ticks"], "waits": len(device.tracer.wait_spans())}


def _forced_queue_full(dev) -> None:
    """Copies parked behind a promise fill the fence list of a one-slot
    device with no retries: QueueFull, and its trace is closed."""
    from repro_torch.core import QueueFull, make_device

    device = make_device(n_instances=1, wq_size=1, max_retries=0, trace=1.0, device=dev)
    gate = device.promise()
    x = torch.zeros(1024, dtype=torch.int32, device=dev)
    futs = []
    try:
        for _ in range(10000):
            futs.append(device.memcpy_async(x, after=[gate]))  # dsalint: disable=DSA106 — filling the fence list one by one
    except QueueFull:
        pass
    else:
        raise SmokeError("QueueFull was not raised")
    gate.set_result(None)
    device.wait_all(futs)
    device.drain()
    errored = [t for t in device.tracer.traces() if t.attrs.get("error") == "QueueFull"]
    check(len(errored) == 1 and "resolved" in errored[0].marks,
          f"the QueueFull submit's trace: {errored}")
    print(f"QueueFull after {len(futs)} fenced copies; its trace is closed")


def _round_trips(dev, n: int, policies) -> dict:
    """Host seconds of one 4 KiB copy submitted and waited for under each
    wait policy of ``policies``, on an untraced and a traced device each:
    n trips a device, then n more in the reverse order of devices.  Per
    policy the mean and the median of each device's 2 n trips."""
    from repro_torch.core import make_device

    devices = {(wp, name): make_device(wait_policy=wp, trace=trace, device=dev)
               for wp in policies for name, trace in (("untraced", None), ("traced", 1.0))}
    x = torch.zeros(1024, dtype=torch.int32, device=dev)
    secs = {k: [] for k in devices}
    order = list(devices)
    for key in order + order[::-1]:
        d = devices[key]
        d.memcpy_async(x).wait()
        for _ in range(n):
            t0 = time.perf_counter()
            d.memcpy_async(x).wait()
            secs[key].append(time.perf_counter() - t0)
    out = {wp: {} for wp in policies}
    for (wp, name), v in secs.items():
        out[wp][name] = statistics.mean(v)
        out[wp][f"{name}_median"] = statistics.median(v)
    return out


#: phase 3e: a spin wait's median 4 KiB round trip may be at most this many
#: times umwait's (it was 60-90 times, PR 20, when its poll loop kept the GIL
#: the launching PE thread needs)
SPIN_OVER_UMWAIT_LIMIT = 1.25


@phase("3e traced main path")
def traced_main_path(dev, gen, sizes=(4 * KiB, MiB, 64 * MiB), n_round_trips=500) -> dict:
    """``n_round_trips``: 4 KiB round trips timed per device and pass
    (``_round_trips``: umwait and spin, each traced and untraced).  Spin's
    host-free share must be 0 and its median untraced round trip within
    SPIN_OVER_UMWAIT_LIMIT of umwait's."""
    from repro_torch.core.completion import WAIT_POLICIES

    out = {"host_free": {}, "breakdown": {}}
    for wp in WAIT_POLICIES:
        r = _traced_wait_policy(dev, gen, wp, sizes)
        out["host_free"][wp] = r["host_free"]
        out["breakdown"][wp] = {p: {k: s[k] for k in ("share", "mean_s", "p95_s", "count")}
                                for p, s in r["breakdown"].items()}
        print(f"{wp}: host-free share {r['host_free']:.4f} over {r['waits']} waits "
              f"(equal to WaitStats'); {r['ticks']} sampler ticks")
    _forced_queue_full(dev)
    out["round_trip_4k_s"] = rt = _round_trips(dev, n_round_trips, ("umwait", "spin"))
    spin, umwait = rt["spin"]["untraced_median"], rt["umwait"]["untraced_median"]
    print("4 KiB round trip by wait policy, untraced and traced, s: " + json.dumps(rt))
    print(f"median untraced 4 KiB round trip: spin {spin * 1e3:.4f} ms, umwait "
          f"{umwait * 1e3:.4f} ms; spin below umwait: {spin < umwait}")
    check(out["host_free"]["spin"] == 0.0,
          f"spin billed host-free time: share {out['host_free']['spin']}")
    check(spin <= SPIN_OVER_UMWAIT_LIMIT * umwait,
          f"the median 4 KiB round trip under spin, {spin} s, is more than "
          f"{SPIN_OVER_UMWAIT_LIMIT} x umwait's, {umwait} s")
    print("phase breakdown under umwait: " + json.dumps(out["breakdown"]["umwait"]))
    return out


@phase("3e traced serving (tinyllama-1.1b.reduced(), f32)")
def traced_serving(dev) -> dict:
    """The reduced model of phase 3d served once on a traced device: every
    descriptor a request submits carries the request's ``req<id>``."""
    from repro_torch.configs import get_config
    from repro_torch.core import make_device
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(), dtype="float32")
    model = build_model(cfg, remat=False, attn_impl="flash", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (16, 77, 33, 50, 64, 21)]
    device = make_device(n_instances=2, policy="least_loaded", trace=1.0, device=dev)
    serve(model, params, device, prompts, slots=3, max_cache=96, max_new=4, max_steps=500)
    ids = {}
    for tr in device.tracer.traces():
        ids.setdefault(tr.trace_id, []).append(tr.op)
    check(set(ids) == {f"req{i}" for i in range(len(prompts))},
          f"descriptors outside a request's trace id: {sorted(ids)}")
    print("descriptors by request: " + json.dumps({k: len(v) for k, v in sorted(ids.items())}))
    return {k: len(v) for k, v in ids.items()}


# --------------------------------------------------------------------------- phase 4e
#: phase 4e(i): tinyllama-1.1b at full width and depth, 6 steps of 8 x 2048
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 2048, 6, 1e-3


@phase("4e(i) training tinyllama-1.1b at full width and depth")
def training_full(dev, cfg=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
                  lr=TRAIN_LR) -> dict:
    """``make_train_step`` (flash attention, per-layer remat) for ``steps``
    steps on ``SyntheticLMDataset`` batches through the ``Prefetcher``; the
    loss must be finite and fall, and the flash kernel must launch twice per
    layer per step (forward and remat replay).  Eager PyTorch, no compile
    step.  ``cfg`` lets a CPU rehearsal run a reduced config."""
    from repro_torch import tree as ttree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Prefetcher, SyntheticLMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW

    cfg = cfg or get_config("tinyllama-1.1b")
    sync(dev)
    base = torch.cuda.memory_allocated(dev)
    model = build_model(cfg, remat=True, attn_impl="flash", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(2))
    opt = AdamW(lr=lr)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)
    n_params = sum(t.numel() for t in ttree.leaves(params))
    prefetch = Prefetcher(SyntheticLMDataset(cfg, batch, seq, seed=0), device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    losses, secs = [], []
    try:
        for _ in range(steps):
            t0 = time.perf_counter()
            _, b = next(prefetch)
            params, opt_state, metrics = step_fn(params, opt_state, b)
            losses.append(float(metrics["loss"]))  # waits for the step
            secs.append(time.perf_counter() - t0)
    finally:
        prefetch.stop()
    counts = read_counts(("flash_attention",))
    # the training's own peak: what earlier phases left allocated is not
    # counted
    peak = torch.cuda.max_memory_allocated(dev) - base
    profile = step_profile(lambda: step_fn(params, opt_state, b), dev)
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {n_params} params "
          f"({cfg.dtype}); losses {losses}; seconds a step {secs}; flash launches "
          f"{counts['flash_attention']}; peak memory {peak} B")
    check(all(np.isfinite(losses)), f"a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    want = 2 * cfg.num_layers * steps
    check(dev.type != "cuda" or counts["flash_attention"] == want,
          f"flash_attention launched {counts['flash_attention']} times, not 2 x "
          f"{cfg.num_layers} layers x {steps} steps = {want}")
    step_s = statistics.median(secs[1:])
    return {"losses": losses, "step_s": secs, "median_step_s": step_s,
            "tokens_per_s": batch * seq / step_s, "flash_launches": counts["flash_attention"],
            "peak_bytes": peak, "params": n_params, "mode": "eager, no compile step",
            "profile": profile}


#: device work of a train step by kind, from the kernel's name: the flash
#: kernel, f32 matmuls on the CUDA cores (cuBLAS ``f32f32`` / ``ffma``
#: kernels: the chunked attention's backward, with TF32 off), the other
#: matmuls (bf16 on the tensor cores), and everything else (casts, adds,
#: softmax and norm pieces, reductions, copies)
STEP_KINDS = (("flash_attention", ("flash_attention",)),
              ("f32 matmul (CUDA cores)", ("f32f32_f32f32", "ffma")),
              ("matmul (tensor cores)", ("gemm", "xmma", "cutlass", "nvjet")))


def step_profile(fn, dev, top: int = 8) -> dict:
    """One more call of ``fn`` (a train step) under ``torch.profiler``: its
    host seconds (with the profiler's own cost), the device's busy seconds
    (kernels and memsets, summed), those seconds by ``STEP_KINDS``, and the
    ``top`` kernels by summed device time."""
    if dev.type != "cuda":
        return {}
    sync(dev)
    t0 = time.perf_counter()
    work = device_work(fn)
    wall = time.perf_counter() - t0
    by_name: dict = {}
    for name, us in work:
        by_name[name] = by_name.get(name, 0.0) + us
    by_kind = {kind: 0.0 for kind, _ in STEP_KINDS}
    by_kind["other"] = 0.0
    for name, us in by_name.items():
        kind = next((k for k, words in STEP_KINDS if any(w in name for w in words)), "other")
        by_kind[kind] += us * 1e-6
    busy = sum(by_name.values()) * 1e-6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out = {"step_s": wall, "device_busy_s": busy, "launches": len(work),
           "device_s_by_kind": by_kind,
           "top_kernels_s": [(name[:120], us * 1e-6) for name, us in ranked]}
    print("one profiled train step: " + json.dumps(out))
    return out


def _train_args(directory: Path, dev, *, reduced, layers, batch, seq):
    import argparse

    return argparse.Namespace(
        arch="tinyllama-1.1b", reduced=reduced, steps=6, batch=batch, seq=seq, lr=TRAIN_LR,
        micro_steps=1, seed=0, ckpt_dir=str(directory), ckpt_every=2, full_every=2,
        replicas=1, log_every=1, no_remat=False, instances=2, policy="round_robin",
        crc_impl="kernel", device=str(dev), layers=layers)


class InjectedFailure(RuntimeError):
    """The failure phase 4e(ii) injects into launch/train.py's loop."""


@contextlib.contextmanager
def crash_after_save(step: int):
    """Within the block, launch/train.py's checkpoint manager raises
    InjectedFailure once, after its save of ``step`` has landed."""
    from repro_torch.launch import train as t_train

    base, crashed = t_train.CheckpointManager, []

    class CrashingManager(base):
        def save(self, s, tree, **kw):
            super().save(s, tree, **kw)
            if s == step and not crashed:
                crashed.append(s)
                self.wait()
                raise InjectedFailure(f"injected failure after step {s}'s save")

    t_train.CheckpointManager = CrashingManager
    try:
        yield
    finally:
        t_train.CheckpointManager = base


@phase("4e(ii) launch/train.py: checkpoints with kernel CRCs, a crash and a resume")
def training_driver(dev, directory: Path = CKPT_DIR / "train", *, reduced=False,
                    layers=TINYLLAMA_LAYERS_KEPT, batch=TRAIN_BATCH, seq=TRAIN_SEQ) -> dict:
    """``launch/train.py``'s ``train()`` at tinyllama-1.1b's width, depth
    cut to ``layers`` (the tree phase 4c checkpoints), on the host mesh with
    ZeRO-1 specs (the driver's own): 6 steps, a save every 2 (every other
    one full) with kernel CRCs on 2 engines, run whole and run with a crash
    injected after step 4's save.  The crashed run resumes from step 4
    through ``run_with_restarts``; both runs' step-6 checkpoints must be
    equal bit for bit, and the manifests' CRCs must be zlib's."""
    import io

    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.launch.train import train

    out = {}
    reset_counts()
    for name, crash in (("whole", None), ("crash", 4)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), \
                (crash_after_save(crash) if crash else contextlib.nullcontext()):
            final = train(_train_args(directory / name, dev, reduced=reduced, layers=layers,
                                      batch=batch, seq=seq))
        out[f"{name}_s"] = time.perf_counter() - t0
        log = buf.getvalue()
        print("\n".join("  " + line for line in log.splitlines()))
        check(final == 6, f"{name} run ended at step {final}")
        # run_with_restarts retries any failure: the whole run must need no
        # restart, the crashed run exactly the one injected
        restarts = [line for line in log.splitlines() if line.startswith("[fault] restarting")]
        want = ["[fault] restarting from step 4 after InjectedFailure"] if crash else []
        check(len(restarts) == len(want)
              and all(line.startswith(w) for line, w in zip(restarts, want)),
              f"{name} run restarted {len(restarts)} times: {restarts}")
        if crash:
            check("resumed from step 4" in log, "the crashed run did not resume from step 4")
    sync(dev)
    counts = read_counts(("copy_crc_words", "gf2_fold", "crc32_chunk_states", "flash_attention"))
    print(f"launches on launch/train.py's path (both runs): {counts}")
    check(dev.type != "cuda" or counts["copy_crc_words"] > 0,
          f"no checkpoint CRC went through copy_crc_words: {counts}")
    trees = {}
    for name in ("whole", "crash"):
        step, trees[name] = CheckpointManager(
            CheckpointConfig(directory=str(directory / name))).restore()
        check(step == 6, f"{name}: the newest restorable checkpoint is step {step}, not 6")
    check(sorted(trees["whole"]) == sorted(trees["crash"]), "the two runs' leaf names")
    worst = 0.0
    for key, want in trees["whole"].items():
        got = trees["crash"][key]
        check(torch.allclose(got.float(), want.float(), rtol=1e-5, atol=1e-6),
              f"{key}: the resumed run ends elsewhere than the uninterrupted run")
        worst = max(worst, float((got.float() - want.float()).abs().max()))
    check(worst == 0.0, f"the resumed run ends {worst} from the uninterrupted run, not bit "
          f"for bit")
    man = check_manifest(directory / "crash", 6, tree_crcs(trees["crash"]))
    out.update(launches=counts, max_abs_diff=worst, leaves=len(man["leaves"]))
    shutil.rmtree(directory, ignore_errors=True)
    return out


# --------------------------------------------------------------------------- phase 7
#: phase 7a: the bf16 matmul and the copy that say what the data sheet's
#: peaks mean on this card, each the median of PEAK_REPS calls
PEAK_MATMUL_N, PEAK_COPY_BYTES, PEAK_REPS = 8192, GiB, 10
#: phase 7b: the fake count and the real count of one step must agree to
#: this (relative): the same ops on the same shapes
COUNT_RTOL = 1e-6
#: phase 7c: phase 4d's decode shape, 4 slots against a 2048-token cache
ROOF_DECODE_SLOTS, ROOF_DECODE_CACHE, ROOF_DECODE_STEPS = 4, 2048, 10
#: phase 7d: the dry run's own entry point, in a process of its own
DRYRUN_CMD = ("-m", "repro_torch.launch.dryrun", "--arch", "tinyllama-1.1b", "--shape",
              "train_4k", "--mesh", "both", "--jobs", "2")
DRYRUN_OUT = ROOT / "chiprun_out" / "dryrun"
DRYRUN_TIMEOUT_S = 600


def events_ms(fn, reps: int) -> float:
    """Median device ms of one call of ``fn`` (after one warm-up call), each
    call between its own pair of CUDA events."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


@phase("7a the card's attained bf16 matmul and copy rates")
def attained_peaks(dev, gen, card: str) -> dict:
    """A bf16 ``torch.matmul`` of PEAK_MATMUL_N cubed and a 1 GiB
    ``Tensor.copy_`` (read once, written once), against H100's data-sheet
    peaks."""
    from repro_torch.roofline import H100

    n = PEAK_MATMUL_N
    a = torch.randn((n, n), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((n, n), generator=gen, device=dev).to(torch.bfloat16)
    mm_ms = events_ms(lambda: torch.matmul(a, b), PEAK_REPS)
    del a, b
    src = torch.empty(PEAK_COPY_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    cp_ms = events_ms(lambda: dst.copy_(src), PEAK_REPS)
    del src, dst
    out = {"matmul_ms": mm_ms, "matmul_flops_per_s": 2.0 * n ** 3 / (mm_ms * 1e-3),
           "copy_ms": cp_ms, "copy_bytes_per_s": 2.0 * PEAK_COPY_BYTES / (cp_ms * 1e-3)}
    out["matmul_of_spec"] = out["matmul_flops_per_s"] / H100.peak_flops
    out["copy_of_spec"] = out["copy_bytes_per_s"] / H100.hbm_bw
    print(f"attained peaks on {card}: " + json.dumps(out))
    check(all(math.isfinite(v) and v > 0 for v in out.values()), f"peaks: {out}")
    return out


def _roofline(cost, step_s: float) -> dict:
    """The roofline terms of a counted step against its measured seconds."""
    from repro_torch.roofline import roofline_terms

    terms = roofline_terms(cost.flops, cost.bytes, cost.coll_bytes)
    bound = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    return {"flops": cost.flops, "bytes": cost.bytes, "collective_bytes": cost.coll_bytes,
            **terms, "step_s": step_s, "roofline_share": bound / step_s}


@phase("7b tinyllama-1.1b's train step at full width: counted fake and real, timed")
def roofline_train(dev, mesh, peaks: dict, train_full: dict, card: str) -> dict:
    """tinyllama-1.1b at full width and depth, phase 4e(i)'s 8 x 2048 tokens,
    chunked attention, on the host mesh: counted by ``launch/dryrun.py``
    with fake tensors, then built with real ones on the card and counted
    again under the same counter (the same FLOPs and bytes to COUNT_RTOL,
    no collective bytes on one rank); one warm-up step, the median of 3
    timed; its roofline terms, share and MFU, and the dry run's memory
    estimate against the card's peak."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.annotate import use_rules
    from repro_torch.launch import dryrun
    from repro_torch.models.api import build_model
    from repro_torch.roofline import H100
    from repro_torch.roofline.analysis import model_flops_for_cell
    from repro_torch.roofline.op_cost import OpCounter

    release(dev)
    cfg = get_config("tinyllama-1.1b")
    shape = ShapeConfig("train_8x2048", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    fake, meta = dryrun.lower_cell(cfg.name, shape.name, mesh, cfg=cfg, shape=shape,
                                   device="cuda")
    fake_s = time.perf_counter() - t0
    fake_cost, rules = fake.cost(), meta["rules"]
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, mesh=mesh, remat=True, attn_impl="chunked", device=dev)
    secs = []
    with use_rules(mesh, rules):
        step, (params, opt_state, batch) = dryrun.cell_step(
            model, shape, mesh, rules, torch.Generator(device=dev).manual_seed(7))
        with OpCounter() as real:
            out = step(params, opt_state, batch)
        del out
        for _ in range(4):
            sync(dev)
            t0 = time.perf_counter()
            params, opt_state, metrics = step(params, opt_state, batch)
            loss = float(metrics["loss"])  # waits for the step
            secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) - base
    del params, opt_state, batch, metrics
    real_cost = real.cost()
    step_s = statistics.median(secs[1:])
    mf = model_flops_for_cell(cfg, shape, "train")
    res = {"fake": {"flops": fake_cost.flops, "bytes": fake_cost.bytes,
                    "collective_bytes": fake_cost.coll_bytes, "count_s": fake_s},
           **_roofline(real_cost, step_s), "step_s_all": secs, "loss": loss,
           "model_flops": mf, "mfu_of_spec": mf / (step_s * H100.peak_flops),
           "mfu_of_attained": mf / (step_s * peaks["matmul_flops_per_s"]),
           "memory_estimate_bytes": meta["memory"]["argument_bytes"]
           + meta["memory"]["temp_bytes"],
           "memory": meta["memory"], "max_memory_allocated": peak,
           "flash_step_4e_s": train_full["median_step_s"],
           "flash_step_4e_mfu_of_spec": mf / (train_full["median_step_s"] * H100.peak_flops),
           "flash_step_4e_mfu_of_attained":
               mf / (train_full["median_step_s"] * peaks["matmul_flops_per_s"])}
    print(f"train step roofline on {card}: " + json.dumps(res))
    for key, want in (("flops", fake_cost.flops), ("bytes", fake_cost.bytes)):
        check(abs(res[key] - want) <= COUNT_RTOL * want,
              f"the real count's {key} {res[key]} are not the fake count's {want}")
    check(real_cost.coll_bytes == 0 and fake_cost.coll_bytes == 0,
          f"collective bytes on one rank: {real_cost.coll_bytes}, {fake_cost.coll_bytes}")
    check(math.isfinite(loss), f"the counted train step's loss is {loss}")
    return res


@phase("7c tinyllama-1.1b's decode step at full width: counted, timed")
def roofline_decode(dev, card: str) -> dict:
    """Phase 4d's decode step (4 slots, a 2048-token cache, no mesh),
    counted for real and timed (the median of ROOF_DECODE_STEPS steps, each
    synchronised): its roofline terms against the measured step."""
    from repro_torch import tree as ttree
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models.api import build_model
    from repro_torch.roofline.op_cost import OpCounter

    release(dev)
    cfg = get_config("tinyllama-1.1b")
    model = build_model(cfg, attn_impl="flash", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(8))
    cache = model.init_cache(ROOF_DECODE_SLOTS, ROOF_DECODE_CACHE)
    step = make_decode_step(model)
    tokens = torch.zeros((ROOF_DECODE_SLOTS, 1), dtype=torch.int32, device=dev)
    with OpCounter() as counter:
        tokens, cache = step(params, cache, tokens)
    secs = []
    for _ in range(ROOF_DECODE_STEPS):
        sync(dev)
        t0 = time.perf_counter()
        tokens, cache = step(params, cache, tokens)
        sync(dev)
        secs.append(time.perf_counter() - t0)
    weights = sum(t.numel() * t.element_size() for t in ttree.leaves(params))
    res = {**_roofline(counter.cost(), statistics.median(secs)), "step_s_all": secs,
           "weight_bytes": weights, "ops": sum(r["n"] for r in counter.records)}
    del params, cache
    print(f"decode step roofline on {card}: " + json.dumps(res))
    check(res["bytes"] >= weights, f"the decode step's count reads {res['bytes']} B, less "
          f"than its {weights} B of weights")
    return res


@phase("7d launch/dryrun.py: tinyllama-1.1b train_4k on both production meshes")
def dryrun_records(card: str) -> dict:
    """The dry run's entry point in a process of its own (a session of its
    own, so that a timeout stops the processes it starts for its cells)."""
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, *DRYRUN_CMD, "--out", str(DRYRUN_OUT)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    print("\n".join("  " + line for line in out.splitlines() if not line.startswith("[rank")))
    recs = {}
    for mesh in ("single", "multi"):
        path = DRYRUN_OUT / f"{mesh}__tinyllama-1.1b__train_4k.json"
        check(path.exists(), f"the dry run wrote no {mesh} record (exit {proc.returncode})")
        rec = json.loads(path.read_text())
        check(rec["status"] == "ok", f"the dry run's {mesh} record: {rec['status']} "
              f"{rec.get('reason', '')}")
        recs[mesh] = {k: rec[k] for k in (
            "n_chips", "flops_per_dev", "bytes_per_dev", "collective_bytes_per_dev",
            "compute_s", "memory_s", "collective_s", "bottleneck", "useful_flops_ratio",
            "hbm_per_dev_gb", "fits_hbm", "compile_s")}
    check(proc.returncode == 0, f"launch/dryrun.py exited {proc.returncode}")
    print(f"dry-run records (host CPU beside {card}): " + json.dumps(recs))
    return recs


def main() -> int:
    try:
        return run()
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def run() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build  # noqa: F401  (fails outside the repo)

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    # float32 matmuls in full f32 (no TF32), stated and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # torch imports torch._dynamo on the first torch.utils.checkpoint call,
    # and that import keeps the calling frames, with the remat phase's
    # parameters in their locals, in a reference cycle; imported here, it
    # holds nothing, and release() can hold that no cycle keeps card memory
    importlib.import_module("torch._dynamo")
    build()
    errs: dict = {}
    kernels_vs_plain(dev, gen, errs)
    kernels_vs_plain_2(dev, gen, errs)
    kernels_vs_plain_3(dev, gen, errs)
    kernels_vs_plain_4(dev, gen, errs)
    bwd = flash_backward(dev, gen)
    # each slice's main path, with the counts set to 0 just before it and
    # read just after it
    reset_counts()
    main_path(dev, gen)
    shapes = real_sizes(dev, gen)
    torch.cuda.synchronize()
    counts = read_counts(SLICE1)
    print(f"launches on the slice-1 main path (phases 3 and 4): {counts}")
    check(all(v > 0 for v in counts.values()),
          f"a kernel of the slice-1 main path never launched: {counts}")
    reset_counts()
    main_path_2(dev, gen)
    shapes2 = real_sizes_2(dev, gen, errs)
    torch.cuda.synchronize()
    counts2 = read_counts(SLICE2)
    print(f"launches on the slice-2 main path (phases 3b and 4b): {counts2}")
    check(all(v > 0 for v in counts2.values()),
          f"a kernel of the slice-2 main path never launched: {counts2}")
    reset_counts()
    main_path_3(dev, gen)
    ckpt = real_sizes_3(dev, gen)
    torch.cuda.synchronize()
    counts3 = read_counts(SLICE3)
    print(f"launches on the slice-3 main path (phases 3c and 4c): {counts3}")
    check(all(v > 0 for v in counts3.values()),
          f"a kernel of the slice-3 main path never launched: {counts3}")
    reset_counts()
    small = serving_small(dev)
    torch.cuda.synchronize()
    counts_3d = read_counts(SLICE4)
    print(f"launches on the slice-4 main path at the small size (phase 3d): {counts_3d}")
    check(all(v > 0 for v in counts_3d.values()),
          f"a kernel of the slice-4 main path never launched in phase 3d: {counts_3d}")
    full = serving_full(dev)  # sets the counts to 0 itself, reads them after serving
    counts4 = full["launches"]
    # slice 9: gemma3 and the VLM frontend; each phase sets the counts to 0
    # just before its main path and reads them just after it
    gemma_small = serving_gemma_small(dev)
    counts_3f = gemma_small["launches"]
    print(f"launches on the slice-9 main path at the small size (phase 3f): {counts_3f}")
    check(counts_3f["flash_attention"] > 0 and counts_3f["memcpy_words"] > 0,
          f"phase 3f did not launch flash_attention and memcpy_words: {counts_3f}")
    gemma = serving_gemma(dev)
    print(f"launches while serving gemma3-1b (phase 4f): {gemma['launches']}")
    vlm = vlm_full(dev)
    print(f"launches of qwen2-vl-2b's prefill and decode (phase 4g): {vlm['launches']}")
    check(vlm["launches"]["flash_attention"] > 0, "phase 4g did not launch flash_attention")
    reset_counts()
    traced = traced_main_path(dev, gen)
    sync(dev)
    counts_3e = read_counts(SLICE8_TRACED)
    print(f"launches on the traced main path (phase 3e): {counts_3e}")
    check(all(v > 0 for v in counts_3e.values()),
          f"a kernel of the traced main path never launched: {counts_3e}")
    reset_counts()
    traced_requests = traced_serving(dev)
    sync(dev)
    counts_3e_serve = read_counts(SLICE4)
    print(f"launches while serving on the traced device (phase 3e): {counts_3e_serve}")
    check(counts_3e_serve["flash_attention"] > 0 and counts_3e_serve["memcpy_words"] > 0,
          f"traced serving did not launch flash_attention and memcpy_words: {counts_3e_serve}")
    train_full = training_full(dev)  # sets the counts to 0 itself, reads them after
    driver = training_driver(dev)  # the same
    crc_launches(dev, gen)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    rows = {r["name"]: r for r in times(dev, gen, shapes["pool"])}
    del shapes
    rows.update({r["name"]: r for r in times_2(dev, gen, shapes2)})
    del shapes2
    rows.update({r["name"]: r for r in times_3(dev, gen)})
    rows.update({r["name"]: r for r in times_4(dev, gen)})
    # slice 11: hymba and seamless, before 4h (which needs the card's memory
    # to itself); each path sets the counts to 0 just before it and reads
    # them just after it
    hybrid_small = serving_hybrid_encdec_small(dev)
    for name, res in hybrid_small.items():
        if isinstance(res, dict):
            print(f"launches of {name} reduced on the card (phase 3i): {res['launches']}")
    hybrid_full = serving_hybrid_full(dev)
    print(f"launches while serving hymba-1.5b (phase 4j): {hybrid_full['launches']}")
    encdec = encdec_full(dev)
    print(f"launches of seamless-m4t-medium's prefill and decode (phase 4k): "
          f"{encdec['launches']}")
    # slice 10: the MoE and SSM families, last: 4h holds deepseek-moe-16b in
    # f32 (65.5 GB), so nothing of the earlier phases may still be held;
    # each path sets the counts to 0 just before it and reads them just
    # after it
    moe_ssm_small = serving_moe_ssm_small(dev)
    for arch, res in moe_ssm_small.items():
        launched = res["launches"]
        print(f"launches serving {arch} reduced on the card (phase 3h): {launched}")
        check(launched["memcpy_words"] > 0
              and (launched["flash_attention"] > 0) == (arch != MAMBA2),
              f"phase 3h, {arch}: launches {launched}")
    moe_full = serving_moe_full(dev)
    print(f"launches while serving deepseek-moe-16b (phase 4h): {moe_full['launches']}")
    ssm_full = serving_ssm_full(dev)
    print(f"launches while serving mamba2-370m (phase 4i): {ssm_full['launches']}")
    # slice 12: the host mesh, last (4l serves deepseek-moe-16b again); each
    # path sets the counts to 0 just before it and reads them just after it
    from repro_torch.launch.mesh import make_host_mesh

    mesh, host_mesh = make_host_mesh(), make_host_mesh(device="cpu")
    mesh_small = serving_mesh_small(dev, mesh, host_mesh)
    for arch, res in mesh_small.items():
        print(f"launches serving {arch} reduced on the host mesh (phase 3j): "
              f"{res['launches']}, all-reduces {res['all_reduces']}")
    mesh_full = serving_mesh_full(dev, mesh, full)
    # slice 13: the roofline, last; 7d's dry run after the timed 7a-7c, so
    # that its host work shares no cores with them
    peaks = attained_peaks(dev, gen, card)
    roof_train = roofline_train(dev, mesh, peaks, train_full, card)
    roof_decode = roofline_decode(dev, card)
    dry_recs = dryrun_records(card)
    print("checkpoint of tinyllama-1.1b (2 of 22 layers), seconds: " + json.dumps(ckpt))
    print("serving, tinyllama-1.1b.reduced() f32 (phase 3d): " + json.dumps(small))
    print("serving, tinyllama-1.1b full width and depth (phase 4d): "
          + json.dumps(shown(full)))
    print("serving, gemma3-1b.reduced() at 8 layers f32 (phase 3f): " + json.dumps(gemma_small))
    print("serving, gemma3-1b full width and depth (phase 4f): "
          + json.dumps(shown(gemma)))
    print("qwen2-vl-2b full width and depth, prefill and decode (phase 4g): " + json.dumps(vlm))
    print("serving the MoE and SSM families reduced, f32 (phase 3h): "
          + json.dumps({a: {k: v for k, v in r.items() if k != "launches"}
                        for a, r in moe_ssm_small.items()}))
    print("serving, deepseek-moe-16b full width and depth (phase 4h): "
          + json.dumps(shown(moe_full)))
    print("serving, mamba2-370m full width and depth (phase 4i): "
          + json.dumps(shown(ssm_full)))
    print(f"hymba and seamless reduced, f32, card vs CPU (phase 3i) on {card}: " + json.dumps(
        {a: ({k: v for k, v in r.items() if k != "launches"} if isinstance(r, dict) else r)
         for a, r in hybrid_small.items()}))
    print(f"serving, hymba-1.5b full width and depth (phase 4j) on {card}: "
          + json.dumps(shown(hybrid_full)))
    print(f"seamless-m4t-medium full width and depth, prefill and decode (phase 4k) on {card}: "
          + json.dumps(shown(encdec)))
    print("flash_attention at the served models' prefill shapes (phase 5d): "
          + json.dumps(rows["flash_attention"]["prefill_shapes"]))
    print("flash backward against the chunked path (phase 2e): " + json.dumps(bwd))
    print("traced main path (phase 3e): " + json.dumps(
        {"host_free": traced["host_free"], "round_trip_4k_s": traced["round_trip_4k_s"],
         "launches": counts_3e, "traced_serving_descriptors": traced_requests}))
    print("training tinyllama-1.1b full width and depth, eager (phase 4e(i)): "
          + json.dumps(train_full))
    print("launch/train.py at full width, 2 of 22 layers (phase 4e(ii)): " + json.dumps(driver))
    print(f"serving on the host mesh, reduced, f32 (phase 3j) on {card}: " + json.dumps(
        {a: shown(r) for a, r in mesh_small.items()}))
    for arch, res in mesh_full.items():
        print(f"serving, {arch} full width and depth on the host mesh (phase 4l) on {card}: "
              + json.dumps(shown(res)))
    for key in ("ttft_split", "decode_s", "decode_steps", "decode_tok_s"):
        print(f"deepseek-moe-16b {key}: no mesh, dense (4h) {json.dumps(moe_full[key])}; "
              f"host mesh, a2a (4l) {json.dumps(mesh_full[DEEPSEEK_MOE][key])}")
    print(f"roofline (phase 7) on {card}: " + json.dumps({
        "peaks": peaks, "train_step": {k: roof_train[k] for k in (
            "compute_s", "memory_s", "collective_s", "bottleneck", "step_s", "roofline_share",
            "mfu_of_spec", "mfu_of_attained", "memory_estimate_bytes", "max_memory_allocated",
            "flash_step_4e_mfu_of_spec")},
        "decode_step": {k: roof_decode[k] for k in (
            "compute_s", "memory_s", "collective_s", "bottleneck", "step_s", "roofline_share")},
        "dryrun": dry_recs}))
    table = kernel_table()
    kernels = []
    for name, (_, replaces) in table.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": FLASH_SOURCE if name == "flash_attention" else SOURCE,
            "replaces": replaces,
            "launches": (counts[name] if name in SLICE1 else counts2[name] if name in SLICE2
                         else counts3[name] if name in SLICE3 else counts4[name]),
            "max_abs_err": errs.get(name, 0),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "plain_shape": r["plain_shape"],
            **({"library_call": r["library_call"]} if "library_call" in r else {}),
            **({"prefill_shapes": r["prefill_shapes"]} if "prefill_shapes" in r else {}),
        })
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
