#!/usr/bin/env python3
"""Drive the repro_torch port on one NVIDIA GPU and hold each of its CUDA
kernels against its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught and skipped):

  1. build the kernels from src/repro_torch/kernels/csrc/ and print the card;
  2. each slice-1 kernel against its plain version on the card, bit-exact, at
     ragged word counts (a CRC with one chain among them), over float32,
     bfloat16, int8 and uint32, batches with duplicate destinations and
     untouched pages; CRC and copy+CRC also against zlib (sizes <= 1 MiB);
  2b. each slice-2 kernel the same way: fills with 1-, 2- and 4-word
     patterns, compares with the difference at word 0, in the middle, at
     the last word and nowhere, delta records with 0, a few, exactly cap and
     cap + 1 differences (word 0 among them) and an overflow, applies of
     records with duplicates, -1 pads and offsets past the end, DIF with a
     corrupted block;
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
  2d. the flash-attention kernel against its plain version: head dims 32,
     64, 128 and 256, GQA groups of 1, 2 and 8, causal and not, a window
     with and without a meta prefix, Sq = Skv of 1, 77, 1000 and 2048, a
     windowed Sq > Skv case with rows that see no key, bf16 and f32;
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
  5. each kernel's time at the phase 4 / 4b / 4c / 4d shapes beside its
     bound, its plain version's time and, where one PyTorch call computes
     the same function, that call's time (for flash attention
     ``scaled_dot_product_attention``); the save and restore seconds of
     phase 4c;
  6. the launch counts of each slice's main path, set to 0 just before it
     and read just after: every kernel of the path must have launched.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Exits with 2, printing
no result, where ``torch.cuda.is_available()`` is false.
"""
from __future__ import annotations

import dataclasses
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
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
#: ones; 1000, 333 and 77 leave the kernel's last 32-row tile partial and do
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
        "gf2_fold": (crc32.combine_chunk_crcs, "src/repro/kernels/crc32.py:97"),
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
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    print(f"built {_build.library_path().name} in {secs:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    return {"build_s": secs}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- phase 2
@phase("2 kernels against their plain versions")
def kernels_vs_plain(dev, gen, errs: dict, big_words: int = MiB // 4) -> None:
    from repro_torch.kernels import batch_copy, crc32, fused, memcpy, ops, ref

    def note(name, err):
        errs[name] = max(errs.get(name, 0), err)
        check(err == 0, f"{name}: kernel disagrees with its plain version (max err {err})")

    # memcpy: ragged counts, an unaligned start (scalar path), PE spans
    base = rand_words(gen, big_words + 8, dev)
    for n in sorted({1, 5, 4099, min(65539, big_words), big_words}):
        for start in (0, 1):
            src = base[start:start + n]
            for n_pe in (1, 3, 4):
                got = memcpy.memcpy_words(src, n_pe=n_pe)
                note("memcpy_words", max_abs_err(got, memcpy.memcpy_words_plain(src, n_pe=n_pe)))
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


def record_err(got, want) -> int:
    """Largest word difference over the four parts of a delta record."""
    return max(max_abs_err(g.reshape(-1).view(torch.int32), w.reshape(-1).view(torch.int32))
               if g.dtype != torch.bool else int(bool(g) != bool(w))
               for g, w in zip(got, want))


@phase("2b slice-2 kernels against their plain versions")
def kernels_vs_plain_2(dev, gen, errs: dict, big_words: int = MiB // 4) -> None:
    from repro_torch.kernels import compare, delta_apply, delta_create, dif, fill, ops, ref

    def note(name, err):
        errs[name] = max(errs.get(name, 0), err)
        check(err == 0, f"{name}: kernel disagrees with its plain version (max err {err})")

    counts = sorted({1, 3, 5, 257, 1000, 4099, min(65539, big_words), big_words})
    # fill: ragged counts, the three pattern widths, PE spans
    for n in counts:
        for pat in ((0xDEADBEEF,), (1, 0x80000001), (7, 8, 0xFFFFFFFF, 0)):
            for n_pe in (1, 3):
                got = fill.fill_words(n, pat, n_pe=n_pe, device=dev)
                note("fill_words", max_abs_err(got, fill.fill_words_plain(n, pat, device=dev)))
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
    # compare, delta create and delta apply read nothing back to the host:
    # PyTorch raises on any synchronizing call in this mode
    if dev.type == "cuda":
        src = base[:big_words]
        changed = src.clone()
        changed.view(torch.int32)[::997] += 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            ops.compare(src, changed)
            o, d, _, _ = ops.delta_create(changed, src, cap=4096)
            ops.delta_apply(src, o, d)
        finally:
            torch.cuda.set_sync_debug_mode("default")
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
    (1, 2048, 2048, 8, 4, 128, True, 512, 16, torch.bfloat16),
    (1, 2048, 2048, 4, 4, 256, False, 0, 0, torch.bfloat16),
    (1, 2048, 2048, 4, 1, 32, True, 0, 0, torch.float32),
    (1, 300, 100, 4, 2, 64, True, 32, 0, torch.float32),
    (1, 300, 100, 4, 2, 64, False, 32, 0, torch.bfloat16),
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


def serve(model, params, device, prompts, *, slots, max_cache, max_new, max_steps=2000,
          wrap_decode=None, kv_pool=None):
    """Serve ``prompts`` through a VhostStyleServer; every request must
    complete with ``max_new`` tokens.  ``wrap_decode`` wraps the server's
    decode step.  Returns (requests, server, seconds)."""
    from repro_torch.serving.pipeline import Request, VhostStyleServer

    server = VhostStyleServer(model, params, slots=slots, max_cache_len=max_cache,
                              device=device, kv_pool=kv_pool)
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


@phase("3d serving on the card and on the CPU (tinyllama-1.1b.reduced(), f32)")
def serving_small(dev) -> dict:
    from repro_torch import tree as ttree
    from repro_torch.configs import get_config
    from repro_torch.core import make_device
    from repro_torch.models.api import build_model
    from repro_torch.serving.kv_pool import PagedKVPool

    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(), dtype="float32")
    card = build_model(cfg, remat=False, attn_impl="flash", device=dev)
    params = card.init(torch.Generator(device=dev).manual_seed(1))
    host_model = build_model(cfg, remat=False, attn_impl="flash", device="cpu")
    host_params = ttree.tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (16, 77, 33, 50, 64, 21)]
    kw = dict(slots=3, max_cache=96, max_new=4, max_steps=500)
    device = make_device(n_instances=2, policy="least_loaded", device=dev)
    # admission reserves each prompt's KV pages in a pool on the card
    pool = PagedKVPool(n_device_pages=32, n_host_pages=16, page_tokens=16,
                       kv_dim=2 * cfg.num_kv_heads * cfg.head_dim, dtype=torch.float32,
                       device=device)
    on_card, server, secs = serve(card, params, device, prompts, kv_pool=pool, **kw)
    check(pool.stats.device_pages_used == 0 and not pool.page_table,
          f"KV pages leaked: {pool.stats}")
    kv_pool_round_trip(pool, gen=torch.Generator(device=dev).manual_seed(5))
    on_cpu, _, cpu_secs = serve(host_model, host_params,
                                make_device(n_instances=2, policy="least_loaded", device="cpu"),
                                prompts, **kw)
    check([r.output for r in on_card] == [r.output for r in on_cpu],
          f"the card served other tokens than the CPU: {[r.output for r in on_card]} vs "
          f"{[r.output for r in on_cpu]}")
    toks = torch.from_numpy(prompts[1])[None]
    _, lc, _ = card.prefill(params, {"tokens": toks.to(dev)}, 96)
    _, lh, _ = host_model.prefill(host_params, {"tokens": toks}, 96)
    err = float((lc.cpu() - lh).abs().max())
    check(bool(torch.isfinite(lc).all()) and lc.shape == (1, cfg.vocab_size), "prefill logits")
    check(torch.allclose(lc.cpu(), lh, **SERVE_F32_TOL),
          f"prefill logits of the card and the CPU differ by {err}")
    print(f"6 requests served on the card in {secs:.3f} s and on the CPU in {cpu_secs:.3f} s: "
          f"the same {sum(len(r.output) for r in on_card)} tokens; 77-token prefill logits "
          f"max |card - CPU| {err:.3e}; placements "
          f"{dict(server.device.policy_stats['decisions'])}")
    return {"card_s": secs, "cpu_s": cpu_secs, "logits_err": err}


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
def serving_full(dev, cfg=None) -> dict:
    """``cfg`` (default: tinyllama-1.1b) lets a CPU rehearsal run a reduced
    config through the same steps."""
    from repro_torch import tree as ttree
    from repro_torch.configs import get_config
    from repro_torch.core import make_device
    from repro_torch.models.api import build_model

    cfg = cfg or get_config("tinyllama-1.1b")
    model = build_model(cfg, remat=False, attn_impl="flash", device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(2))
    sync(dev)
    n_params = sum(t.numel() for t in ttree.leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in ttree.leaves(params))
    print(f"tinyllama-1.1b: {cfg.num_layers} layers, d_model {cfg.d_model}, {n_params} params, "
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

    reset_counts()
    reqs, server, secs = serve(model, params, device, prompts, slots=FULL_SLOTS,
                               max_cache=FULL_CACHE, max_new=FULL_NEW, wrap_decode=timed)
    counts = read_counts(SLICE4)
    print(f"launches while serving: {counts}")
    check(counts["flash_attention"] == cfg.num_layers * len(prompts),
          f"flash_attention launched {counts['flash_attention']} times, not "
          f"{cfg.num_layers} layers x {len(prompts)} prefills")
    check(counts["memcpy_words"] > 0 and counts["batch_copy_pages"] > 0,
          f"the prompt copies did not go through memcpy_words and batch_copy_pages: {counts}")
    m = server.metrics
    ttft = [(len(r.prompt), r.first_token_at - r.arrived_at) for r in reqs]
    decoded = m["decoded_tokens"]
    out = {"seconds": secs, "ttft_s": ttft, "decode_s": decode_s[0], "decode_steps": decode_s[1],
           "decoded_tokens": decoded, "decode_tok_s": decoded / decode_s[0],
           "steps": m["steps"], "copy_bursts": m["copy_bursts"], "launches": counts,
           "params": n_params, "param_bytes": n_bytes}
    print(f"served 8 requests in {secs:.3f} s ({m['steps']} steps, {m['copy_bursts']} copy "
          f"bursts); {decoded} decoded tokens in {decode_s[1]} decode steps, "
          f"{decode_s[0]:.3f} s ({decoded / decode_s[0]:.1f} tokens/s); time to first token "
          f"by prompt length: " + ", ".join(f"{n}: {t:.3f} s" for n, t in ttft))
    out.update(flash_vs_chunked(model, params, prompts[0], dev))
    return out


def flash_vs_chunked(model, params, prompt, dev) -> dict:
    """One prompt's prefill logits under "flash" and "chunked" (plain
    PyTorch), with the model's bf16 weights and with the same weights in
    f32."""
    from repro_torch import tree as ttree
    from repro_torch.models.api import build_model

    cfg32 = dataclasses.replace(model.cfg, dtype="float32")
    p32 = ttree.tree_map(lambda t: t.float(), params)
    toks = torch.from_numpy(prompt)[None].to(dev)
    logits = {}
    for kind, cfg, p in (("bf16", model.cfg, params), ("f32", cfg32, p32)):
        for impl in ("flash", "chunked"):
            m = build_model(cfg, remat=False, attn_impl=impl, device=dev)
            _, logits[kind, impl], _ = m.prefill(p, {"tokens": toks}, FULL_CACHE)
    del p32
    for key, lg in logits.items():
        check(bool(torch.isfinite(lg).all()) and lg.shape == (1, model.cfg.vocab_size),
              f"{key} prefill logits: not finite, or shape {tuple(lg.shape)}")

    def gap(a, b):
        return float((logits[a] - logits[b]).abs().max())

    out = {"f32_flash_vs_chunked": gap(("f32", "flash"), ("f32", "chunked")),
           "bf16_flash_vs_chunked": gap(("bf16", "flash"), ("bf16", "chunked")),
           "bf16_noise": gap(("bf16", "chunked"), ("f32", "chunked")),
           "bf16_flash_vs_f32": gap(("bf16", "flash"), ("f32", "chunked")),
           "logits_absmax": float(logits["f32", "chunked"].abs().max()),
           "same_argmax": len({int(lg.argmax()) for lg in logits.values()}) == 1}
    print(f"{len(prompt)}-token prefill logits (|logits| up to {out['logits_absmax']:.3f}): "
          f"f32 flash vs chunked {out['f32_flash_vs_chunked']:.3e}; bf16 flash vs chunked "
          f"{out['bf16_flash_vs_chunked']:.3e}, bf16 noise (chunked bf16 vs f32) "
          f"{out['bf16_noise']:.3e}, flash bf16 vs f32 {out['bf16_flash_vs_f32']:.3e}; "
          f"one argmax: {out['same_argmax']}")
    check(torch.allclose(logits["f32", "flash"], logits["f32", "chunked"], **SERVE_F32_TOL),
          f"f32 prefill logits: flash and chunked differ by {out['f32_flash_vs_chunked']}")
    check(out["bf16_flash_vs_chunked"] <= BF16_NOISE_FACTOR * out["bf16_noise"],
          f"bf16 prefill logits: flash and chunked differ by {out['bf16_flash_vs_chunked']}, "
          f"more than {BF16_NOISE_FACTOR} x the bf16 noise {out['bf16_noise']}")
    check(out["bf16_flash_vs_f32"] <= BF16_FROM_F32_FACTOR * out["bf16_noise"],
          f"bf16 flash is {out['bf16_flash_vs_f32']} from the f32 model, more than "
          f"{BF16_FROM_F32_FACTOR} x chunked's {out['bf16_noise']}")
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
        cold_ms(lambda: crc32.crc32_chunk_states(data, tabs), 3, flush),
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
    del data, src
    # copy + CRC of the 256 MiB checkpoint leaf
    leaf = rand_words(gen, leaf_bytes // 4, dev)
    C = ops._pick_chunks(leaf.numel())
    ldata = leaf.view(C, -1)
    row("copy_crc_words", f"[{C}, {ldata.shape[1]}] u32 (256 MiB)", 2 * leaf_bytes + 4 * C,
        CRC_OPS_PER_WORD * leaf.numel(),
        cold_ms(lambda: fused.copy_crc_words(ldata, tabs), 3, flush),
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
    row("fill_words", "[268435456] u32 (1 GiB)", big,
        cold_ms(lambda: fill.fill_words(n, pat, device=dev), 5, flush),
        cold_ms(lambda: fill.fill_words_plain(n, pat, device=dev), 5, flush),
        cold_ms(lambda: dst32.fill_(int32_bits(pat[0])), 5, flush), "Tensor.fill_")
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
    n_valid = int(((offsets >= 0) & (offsets < lw.numel())).sum())
    row("delta_apply_words", shape, 2 * nb + 4 * cap + 4 * n_valid,
        cold_ms(lambda: delta_apply.delta_apply_words(lw, offsets, data), 5, flush),
        cold_ms(lambda: delta_apply.delta_apply_words_plain(lw, offsets, data), 5, flush),
        None)
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
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    try:
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,  # noqa: E731
                                                     enable_gqa=True)
        lib()
        call = "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True) on [B,H,S,hd] views"
    except TypeError:  # a torch without enable_gqa: the KV heads expanded first
        ke, ve = kt.repeat_interleave(H // KV, 1), vt.repeat_interleave(H // KV, 1)
        lib = lambda: F.scaled_dot_product_attention(qt, ke, ve, is_causal=True)  # noqa: E731
        call = "F.scaled_dot_product_attention(is_causal=True) on KV heads expanded beforehand"
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
    return [row]


# --------------------------------------------------------------------------- main
def main() -> int:
    try:
        return run()
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)


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
    build()
    errs: dict = {}
    kernels_vs_plain(dev, gen, errs)
    kernels_vs_plain_2(dev, gen, errs)
    kernels_vs_plain_3(dev, gen, errs)
    kernels_vs_plain_4(dev, gen, errs)
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
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    rows = {r["name"]: r for r in times(dev, gen, shapes["pool"])}
    del shapes
    rows.update({r["name"]: r for r in times_2(dev, gen, shapes2)})
    del shapes2
    rows.update({r["name"]: r for r in times_3(dev, gen)})
    rows.update({r["name"]: r for r in times_4(dev, gen)})
    print("checkpoint of tinyllama-1.1b (2 of 22 layers), seconds: " + json.dumps(ckpt))
    print("serving, tinyllama-1.1b.reduced() f32 (phase 3d): " + json.dumps(small))
    print("serving, tinyllama-1.1b full width and depth (phase 4d): "
          + json.dumps({k: v for k, v in full.items() if k != "launches"}))
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
