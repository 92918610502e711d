#!/usr/bin/env python3
"""Time patched copies of the port's bf16 flash-attention kernel against the
kernel as it stands and against ``scaled_dot_product_attention``, on one
NVIDIA GPU.

    python3 tools/flash_variants.py [--out build/flash_variants.json]

Each variant is src/repro_torch/kernels/csrc/flash_attention.cu with a few
lines replaced (PATCHES below), built with nvcc (sm_90a) into ``build/``.
Every variant is checked against the plain version on a few shapes (bf16
tolerance of chip_smoke.py), then timed at q [1, 2048, 32, hd], k/v [1,
2048, 4, hd], causal, hd 64, 128 and 256, with the L2 flushed before every
call (median of 20 calls, three rounds in alternating order).  Prints one
line per shape and one JSON object; exits non-zero without a card.
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

SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
#: name -> [(text, replacement)] applied to the source
PATCHES = {
    "as it stands (exp2)": [],
    "expf": [("const float scale2 = scale * 1.4426950408889634f;", "const float scale2 = scale;"),
             ("exp2f(", "expf(")],
    "3 stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "launch_bounds(128, 4)": [("__launch_bounds__(kThreads)\nflash_attention_wgmma_kernel",
                               "__launch_bounds__(kThreads, 4)\nflash_attention_wgmma_kernel")],
}
CHECKS = ((2, 100, 100, 8, 1, 64, True, 0, 0), (1, 129, 129, 8, 2, 256, True, 0, 0),
          (2, 129, 129, 8, 2, 128, True, 40, 3), (1, 300, 100, 4, 2, 64, True, 32, 4),
          (1, 2048, 2048, 32, 4, 64, True, 0, 0))


def build(name: str, patches) -> tuple:
    from repro_torch.kernels import _build

    text = SOURCE.read_text()
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"variant {name!r}: {old!r} is not in {SOURCE.name}")
        text = text.replace(old, new)
    stem = "flash_variant_" + "".join(c if c.isalnum() else "_" for c in name)
    out = ROOT / "build" / "flash_variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{stem}.cu").write_text(text)
    proc = subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                             str(out / f"{stem}.so"), str(out / f"{stem}.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out / f"{stem}.so", proc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "flash_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_variants: needs a CUDA card", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from chip_smoke import FLASH_TOL, FLUSH_BYTES, card_line, cold_ms, flash_inputs
    from repro_torch.kernels import flash_attention as fa

    card = card_line()
    print(f"card: {card}", flush=True)
    builds = {name: build(name, patches) for name, patches in PATCHES.items()}  # in parallel
    fns = {}
    for name, (so, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(log)
            raise SystemExit(f"variant {name!r} did not build")
        fn = ctypes.CDLL(str(so)).dsa_flash_attention_bf16
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn

    def run(fn, q, k, v, causal=True, window=0, n_meta=0):
        B, Sq, H, hd = q.shape
        o = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, k.shape[1], H,
                 k.shape[2], hd, hd ** -0.5, int(causal), window, n_meta,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return o

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, Sq, Skv, H, KV, hd, causal, window, n_meta in CHECKS:
        q, k, v = flash_inputs(gen, dev, B, Sq, Skv, H, KV, hd, torch.bfloat16)
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window, n_meta=n_meta)
        for name, fn in fns.items():
            got = run(fn, q, k, v, causal, window, n_meta)
            if not torch.allclose(got.float(), want.float(), **FLASH_TOL[torch.bfloat16]):
                raise SystemExit(f"variant {name!r} disagrees with the plain version at "
                                 f"{(B, Sq, Skv, H, KV, hd, causal, window, n_meta)}")
    print("every variant agrees with the plain version", flush=True)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev).zero_()
    out = {"card": card, "ms": {}}
    for hd in (64, 128, 256):
        q, k, v = flash_inputs(gen, dev, 1, 2048, 2048, 32, 4, hd, torch.bfloat16)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        calls = {name: (lambda fn=fn: run(fn, q, k, v)) for name, fn in fns.items()}
        calls["SDPA"] = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                enable_gqa=True)
        times = {name: [] for name in calls}
        for rnd in range(3):
            for name in (list(calls) if rnd % 2 == 0 else list(calls)[::-1]):
                times[name].append(cold_ms(calls[name], 20, flush))
        out["ms"][hd] = {name: statistics.median(t) for name, t in times.items()}
        print(f"hd {hd}: " + ", ".join(f"{n} {t:.4f} ms" for n, t in out["ms"][hd].items()))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
