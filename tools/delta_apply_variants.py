#!/usr/bin/env python3
"""Time the parts of the port's ``delta_apply_words`` on a checkpoint leaf's
record, and variants of the part after its copy, on one NVIDIA GPU.

    python3 tools/delta_apply_variants.py [--out build/delta_apply_variants.json]

The record is the one ``chip_smoke.py`` phase 4b applies: a bf16 leaf of
256 MiB with 0.5 % of its words changed, cap 25 % of its words (16 Mi
entries, an ascending prefix of 335,544 valid entries, then -1 pads).
Builds ``tools/delta_apply_variants.cu`` with nvcc (sm_90a) into
``build/``, checks that the copy and each storing variant restore the
changed leaf bit for bit, then times, interleaved call by call with the L2
flushed before each call (median of 30): the port's call, its copy alone,
the copy followed by each variant, each variant alone, ``Tensor.clone``
and ``Tensor.index_put`` of the valid entries.  The variants are listed at
the top of the .cu file.  Prints one line per timing and one JSON object;
exits non-zero without a card.
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

MiB = 1 << 20
#: name -> variant number in delta_apply_variants.cu
VARIANTS = {
    "scan + stores + barrier (cooperative, memset)": 0,
    "scan + stores, plain launch": 1,
    "scan alone (no stores)": 2,
    "scan + stores, 2 groups a thread a step": 3,
    "memset of the scratch": 4,
}
STORING = (0, 1, 3)


def build() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out = ROOT / "build" / "delta_apply_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
                    str(ROOT / "tools" / "delta_apply_variants.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dv_apply.argtypes = [I, P, LL, P, P, LL, P, I, P]
    lib.dv_apply.restype = I
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "delta_apply_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("delta_apply_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import (FLUSH_BYTES, _bound, card_line, device_work, drifted,
                            interleaved_ms, rand_words)
    from repro_torch.kernels import _build, delta_apply, delta_create

    card = card_line()
    print(f"card: {card}", flush=True)
    lib = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    lw = rand_words(gen, 256 * MiB // 4, dev)
    new_w, k = drifted(gen, lw, 0.005)
    cap = lw.numel() // 4
    offsets, data, count, _ = delta_create.delta_record_words(new_w, lw, cap)
    out = torch.empty_like(lw)
    state = torch.empty(3, dtype=torch.int32, device=dev)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev).zero_()

    def copy():
        _build.launch("dsa_memcpy_words", lw.data_ptr(), out.data_ptr(), lw.numel(), 1, stream)

    def variant(v):
        err = lib.dv_apply(v, out.data_ptr(), lw.numel(), offsets.data_ptr(), data.data_ptr(),
                           cap, state.data_ptr(), sms, stream)
        if err:
            raise RuntimeError(f"variant {v}: CUDA error {err}")

    for name, v in VARIANTS.items():
        if v in STORING:
            copy()
            variant(v)
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int32), new_w.view(torch.int32)):
                print(f"{name}: WRONG")
                return 1
    print(f"{k} valid entries of {cap}; the copy and every storing variant restore the "
          f"leaf bit for bit", flush=True)

    valid = (offsets >= 0) & (offsets < lw.numel())
    lw32, vidx, vwords = lw.view(torch.int32), offsets[valid].long(), data.view(torch.int32)[valid]
    fns = {"delta_apply_words (the port)":
           lambda: delta_apply.delta_apply_words(lw, offsets, data),
           "copy alone (memcpy_words' launch)": copy,
           "Tensor.clone": lambda: lw.clone(),
           "Tensor.index_put of the valid entries": lambda: lw32.index_put((vidx,), vwords)}
    for name, v in VARIANTS.items():
        fns[f"copy + {name}"] = lambda v=v: (copy(), variant(v))
        fns[f"{name} alone"] = lambda v=v: variant(v)
    ms = interleaved_ms(fns, 30, flush)
    bound = _bound(2 * lw.numel() * 4 + 4 * cap + 4 * k)[0]
    print(f"256 MiB leaf, cap {cap}, L2 flushed, median of 30 interleaved calls "
          f"(bound {bound:.4f} ms):")
    for name, t in sorted(ms.items(), key=lambda kv: kv[1]):
        print(f"  {name:60s} {t:.4f} ms")
    work = []
    for _ in range(3):
        flush.max()
        work.append(device_work(lambda: delta_apply.delta_apply_words(lw, offsets, data)))
    print("device work of one call of the port, after an L2 flush (name, us), three calls:")
    for w in work:
        print("  " + "; ".join(f"{name.split('(')[0]} {us:.1f}" for name, us in w))
    result = {"card": card, "bound_ms": bound, "ms": ms, "device_work_us": work}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({k: round(v, 4) for k, v in ms.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
