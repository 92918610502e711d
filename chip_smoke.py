#!/usr/bin/env python3
"""Drive the repro_torch port on one NVIDIA GPU and hold each of its CUDA
kernels against its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught and skipped):

  1. build the kernels from src/repro_torch/kernels/csrc/ and print the card;
  2. each kernel against its plain version on the card, bit-exact, at ragged
     word counts (a CRC with one chain among them), over float32, bfloat16,
     int8 and uint32, batches with duplicate destinations and untouched
     pages; CRC and copy+CRC also against zlib (sizes <= 1 MiB);
  3. the main path: ``make_device(n_instances=2, policy="least_loaded")``
     runs the quickstart flow (memcpy, crc32 with ``.then``, a promise
     fence, an 8-descriptor fused batch), copy_crc, batch_copy into a
     destination pool, a 32-descriptor ``submit_many`` burst, and a drain;
  4. the same path at the sizes its users submit (copies and CRCs of
     4 KiB .. 1 GiB, a 256 MiB checkpoint leaf, DPDK's 32 x 2 KiB burst,
     1024 pages of 16 KiB within a 4096-page pool);
  5. each kernel's time at the phase 4 shapes beside its bound, its plain
     version's time and, where one PyTorch call computes the same function,
     that call's time;
  6. the launch counts of phases 3 and 4: every kernel must have launched.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Exits with 2, printing
no result, where ``torch.cuda.is_available()`` is false.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
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
#: integer operations of one slice-by-4 CRC step: xor, 3 shifts, 4 masks,
#: 4 table reads, 3 xors of the lookups
CRC_OPS_PER_WORD = 15
SOURCE = "src/repro_torch/kernels/csrc/dsa_kernels.cu"
#: bytes read between two timed calls, to push the last call's data out of
#: the 50 MB L2 (read, not written, so no dirty lines are left to evict)
FLUSH_BYTES = 256 * MiB


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
def kernel_table():
    """name -> (wrapper with its ``launches`` count, file:line replaced)."""
    from repro_torch.kernels import batch_copy, crc32, fused, memcpy

    return {
        "memcpy_words": (memcpy.memcpy_words, "src/repro/kernels/memcpy.py:20"),
        "batch_copy_pages": (batch_copy.batch_copy_pages,
                             "src/repro/kernels/batch_copy.py:30"),
        "crc32_chunk_states": (crc32.crc32_chunk_states,
                               "src/repro/kernels/crc32.py:58"),
        "gf2_fold": (crc32.combine_chunk_crcs, "src/repro/kernels/crc32.py:97"),
        "copy_crc_words": (fused.copy_crc_words, "src/repro/kernels/fused.py:56"),
    }


def reset_counts() -> None:
    for wrapper, _ in kernel_table().values():
        wrapper.launches = 0


def read_counts() -> dict:
    return {name: wrapper.launches for name, (wrapper, _) in kernel_table().items()}


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


# --------------------------------------------------------------------------- main
def main() -> int:
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
    build()
    errs: dict = {}
    kernels_vs_plain(dev, gen, errs)
    reset_counts()
    main_path(dev, gen)
    shapes = real_sizes(dev, gen)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"launches on the main path (phases 3 and 4): {counts}")
    check(all(v > 0 for v in counts.values()),
          f"a kernel of the main path never launched: {counts}")
    rows = {r["name"]: r for r in times(dev, gen, shapes["pool"])}
    table = kernel_table()
    kernels = []
    for name, (_, replaces) in table.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": counts[name], "max_abs_err": errs.get(name, 0),
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
