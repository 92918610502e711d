#!/usr/bin/env python3
"""Time fill-kernel variants against each other and ``Tensor.fill_`` on one
NVIDIA GPU, to choose the design of the port's ``fill_words``.

    python3 tools/fill_variants.py [--out build/fill_variants.json]

Builds ``tools/fill_variants.cu`` with nvcc (sm_90a) into ``build/``,
checks every variant bit for bit against the pattern tiled over the buffer
(ragged word counts included), then times every variant and
``Tensor.fill_`` interleaved call by call (round r runs each once, in turns
forward and backward), with the L2 flushed before every call: the median of
30 calls each at 1 GiB and of 50 at 4 KiB, 1 MiB and 64 MiB.  The variants
are listed at the top of the .cu file.  Prints one line per variant and
size and one JSON object; exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

KiB, MiB, GiB = 1 << 10, 1 << 20, 1 << 30
#: name -> variant number in fill_variants.cu
VARIANTS = {
    "loop (1 x uint4, 132x8 CTAs)": 0,
    "bulk 1/SM, 32 KiB tile, 8 in flight": 1,
    "bulk 2/SM, 16 KiB tiles, 8 in flight": 2,
    "bulk 1/SM, 32 KiB, contiguous chunks": 3,
    "bulk 1/SM, 32 KiB, 4 issuing warps": 4,
    "bulk 1/SM, 16 KiB tile, 16 in flight": 5,
    "bulk 1/SM, 64 KiB tile, 4 in flight": 6,
    "one-shot U4, 256 threads": 7,
    "one-shot U8, 256 threads": 8,
    "one-shot U4, 128 threads": 9,
    "one-shot U1, 128 threads": 10,
    "one-shot U8 streaming, 256 threads": 11,
    "one-shot U2, 128 threads": 12,
}
PATTERN = (0x5A5A5A5A, 0x5A5A5A5A, 0x5A5A5A5A, 0x5A5A5A5A)
CHECK_PATTERN = (7, 8, 0xFFFFFFFF, 0)


def build() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out = ROOT / "build" / "fill_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
                    str(ROOT / "tools" / "fill_variants.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    P, I, LL, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    lib.fv_fill.argtypes = [I, P, LL, U, U, U, U, I, P]
    lib.fv_fill.restype = I
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "fill_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fill_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import FLUSH_BYTES, card_line, interleaved_ms
    from repro_torch.kernels.ref import fill_ref, int32_bits

    card = card_line()
    print(f"card: {card}", flush=True)
    lib = build()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    dst = torch.empty(GiB // 4, dtype=torch.uint32, device=dev)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev).zero_()
    stream = torch.cuda.current_stream().cuda_stream

    def call(variant, d, pat=PATTERN):
        err = lib.fv_fill(variant, d.data_ptr(), d.numel(), *pat, sms, stream)
        if err:
            raise RuntimeError(f"variant {variant}: CUDA error {err}")

    for name, variant in VARIANTS.items():
        for n in (GiB // 4, 4 * 250001, 4 * 250001 + 3, 1, 5, 1024, 8191):
            d = dst[:n]
            d.view(torch.int32).fill_(-1)
            call(variant, d, CHECK_PATTERN)
            torch.cuda.synchronize()
            if not torch.equal(d.view(torch.int32),
                               fill_ref((n,), CHECK_PATTERN, device=dev).view(torch.int32)):
                print(f"{name}: WRONG at {n} words")
                return 1
    print("every variant fills bit for bit", flush=True)

    d32 = dst.view(torch.int32)
    word = int32_bits(PATTERN[0])
    out = {"card": card, "ms": {}}
    for nbytes, reps in ((GiB, 30), (4 * KiB, 50), (MiB, 50), (64 * MiB, 50)):
        d, f = dst[:nbytes // 4], d32[:nbytes // 4]
        fns = {"Tensor.fill_": lambda f=f: f.fill_(word)}
        fns.update({name: (lambda v=v, d=d: call(v, d)) for name, v in VARIANTS.items()})
        ms = interleaved_ms(fns, reps, flush)
        bound = nbytes / 3.35e12 * 1e3
        print(f"{nbytes} B, L2 flushed, median of {reps} interleaved calls "
              f"(bound {bound:.6f} ms):")
        for name, t in sorted(ms.items(), key=lambda kv: kv[1]):
            print(f"  {name:40s} {t:.4f} ms ({100 * bound / t:.1f} % of bound, "
                  f"{t / ms['Tensor.fill_']:.3f}x fill_)")
        out["ms"][nbytes] = ms
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: round(v, 4) for k, v in out["ms"][GiB].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
