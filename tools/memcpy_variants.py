#!/usr/bin/env python3
"""Time copy-kernel variants against each other and ``Tensor.copy_`` on one
NVIDIA GPU, to choose the design of the port's ``memcpy_words``.

    python3 tools/memcpy_variants.py [--out build/memcpy_variants.json]

Builds ``tools/memcpy_variants.cu`` with nvcc (sm_90a) into ``build/``,
checks every variant bit for bit against its source, then times each one
at 1 GiB with the L2 flushed before every call (median of 5 calls, three
rounds in alternating order), and the variants again at 4 KiB, 1 MiB and
64 MiB.  The variants are listed at the top of the .cu file.  Prints one
line per timing and one JSON object; exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

KiB, MiB, GiB = 1 << 10, 1 << 20, 1 << 30
SMS = 132
#: name -> (variant, blocks, stages, chunk bytes)
VARIANTS = {
    "loop (1 x uint4, 132x8 CTAs)": (0, SMS * 8, 0, 0),
    "U4 default, 132x4": (1, SMS * 4, 0, 0),
    "U4 default, 132x8": (1, SMS * 8, 0, 0),
    "U4 cs, 132x4": (2, SMS * 4, 0, 0),
    "U4 cs, 132x8": (2, SMS * 8, 0, 0),
    "U8 cs, 132x4": (3, SMS * 4, 0, 0),
    "U8 cs, 132x8": (3, SMS * 8, 0, 0),
    "U4 nc, 132x8": (4, SMS * 8, 0, 0),
    "U8 nc, 132x4": (5, SMS * 4, 0, 0),
    "U8 nc, 132x8": (5, SMS * 8, 0, 0),
    "bulk 1/SM, 4 x 32 KiB": (6, SMS, 4, 32 * KiB),
    "bulk 1/SM, 6 x 32 KiB": (6, SMS, 6, 32 * KiB),
    "bulk 1/SM, 3 x 64 KiB": (6, SMS, 3, 64 * KiB),
    "bulk 2/SM, 3 x 32 KiB": (6, 2 * SMS, 3, 32 * KiB),
    "bulk 2/SM, 4 x 16 KiB": (6, 2 * SMS, 4, 16 * KiB),
    "bulk 4/SM, 4 x 8 KiB": (6, 4 * SMS, 4, 8 * KiB),
    "bulk contiguous, 1/SM, 4 x 32 KiB": (7, SMS, 4, 32 * KiB),
    "bulk contiguous, 2/SM, 3 x 32 KiB": (7, 2 * SMS, 3, 32 * KiB),
    "bulk evict-first, 1/SM, 4 x 32 KiB": (8, SMS, 4, 32 * KiB),
    "U4 default contiguous, 132x4": (9, SMS * 4, 0, 0),
    "U4 default contiguous, 132x8": (9, SMS * 8, 0, 0),
    "cudaMemcpyAsync": (10, 0, 0, 0),
    "bulk evict-first stores, 1/SM, 4 x 32 KiB": (11, SMS, 4, 32 * KiB),
    "bulk 1/SM, 5 x 32 KiB": (6, SMS, 5, 32 * KiB),
    "bulk 1/SM, 4 x 48 KiB": (6, SMS, 4, 48 * KiB),
    "bulk 4 rings/SM, 3 x 16 KiB each": (12, SMS, 3, 16 * KiB),
    "bulk 4 rings/SM, 2 x 24 KiB each": (12, SMS, 2, 24 * KiB),
}


def build() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out = ROOT / "build" / "memcpy_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
                    str(ROOT / "tools" / "memcpy_variants.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mv_copy.argtypes = [I, P, P, LL, I, I, I, P]
    lib.mv_copy.restype = I
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "memcpy_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("memcpy_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import FLUSH_BYTES, card_line, cold_ms

    card = card_line()
    print(f"card: {card}", flush=True)
    lib = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    src = torch.randint(0, 2**31 - 1, (GiB // 4,), generator=gen, device=dev,
                        dtype=torch.int32).view(torch.uint32)
    dst = torch.empty_like(src)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev).zero_()
    stream = torch.cuda.current_stream().cuda_stream

    def call(spec, s, d):
        variant, blocks, stages, chunk = spec
        err = lib.mv_copy(variant, s.data_ptr(), d.data_ptr(), s.numel(), blocks, stages,
                          chunk, stream)
        if err:
            raise RuntimeError(f"variant {spec}: CUDA error {err}")

    for name, spec in VARIANTS.items():
        for n in (GiB // 4, 4 * 250001):
            d = torch.zeros(n, dtype=torch.uint32, device=dev)
            call(spec, src[:n], d)
            torch.cuda.synchronize()
            if not torch.equal(d.view(torch.int32), src[:n].view(torch.int32)):
                print(f"{name}: WRONG at {n} words")
                return 1
    print("every variant copies bit for bit", flush=True)

    big = {name: [] for name in VARIANTS}
    big["Tensor.copy_"] = []
    big["clone"] = []
    order = list(big)
    for rnd in range(3):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            if name == "Tensor.copy_":
                fn = lambda: dst.copy_(src)  # noqa: E731
            elif name == "clone":
                fn = lambda: src.clone()  # noqa: E731
            else:
                fn = lambda spec=VARIANTS[name]: call(spec, src, dst)  # noqa: E731
            big[name].append(cold_ms(fn, 5, flush))
    bound = 2 * GiB / 3.35e12 * 1e3
    print(f"1 GiB, L2 flushed, median of 5 calls in each of 3 rounds (bound {bound:.4f} ms):")
    for name, ts in sorted(big.items(), key=lambda kv: statistics.median(kv[1])):
        med = statistics.median(ts)
        print(f"  {name:32s} {med:.4f} ms ({100 * bound / med:.1f} % of bound)  rounds "
              + " ".join(f"{t:.4f}" for t in ts))
    small = {}
    for nbytes in (4 * KiB, MiB, 64 * MiB):
        s, d = src[:nbytes // 4], dst[:nbytes // 4]
        row = {"Tensor.copy_": cold_ms(lambda: d.copy_(s), 50, flush)}
        for name, spec in VARIANTS.items():
            row[name] = cold_ms(lambda spec=spec: call(spec, s, d), 50, flush)
        small[nbytes] = row
        print(f"{nbytes} B, L2 flushed, median of 50:")
        for name, t in row.items():
            print(f"  {name:32s} {t:.4f} ms")
    out = {"card": card, "bound_ms_1GiB": bound,
           "ms_1GiB": {k: statistics.median(v) for k, v in big.items()},
           "rounds_1GiB": big, "ms_small": small}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: round(v, 4) for k, v in out["ms_1GiB"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
