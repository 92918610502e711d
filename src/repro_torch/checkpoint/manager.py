"""Asynchronous incremental checkpointing: the paper's Delta Record + CRC +
Dualcast ops as a fault-tolerance subsystem (DESIGN.md §7).

Layout (one directory per save), byte for byte the JAX package's
(repro/checkpoint/manager.py), so either package restores the other's saves:

  <dir>/step_00000010/            full snapshot
      manifest.json               {step, kind, leaves: {key: {mode, shape,
                                   dtype, crc, nbytes, base_step}}}
      <key>.bin                   raw little-endian bytes
  <dir>/step_00000012/            delta save (vs. the last full snapshot)
      manifest.json
      <key>.delta.npz             offsets[int32] + data[uint32] word granules

Leaf keys are the tree paths in JAX's order and naming (repro_torch.tree:
dict keys sorted, NamedTuple fields as ``.field``); ``dtype`` is the numpy
name (``"bfloat16"``, never ``"torch.bfloat16"``).  Bytes go through
``Tensor.view(torch.uint8)`` and ``torch.frombuffer``, so no numpy bf16 type
is needed.

Semantics mirror DSA:
  * Create Delta Record with a capacity cap: when a leaf's delta overflows
    (> delta_cap_frac of its words), the completion status is OVERFLOW and
    the manager falls back to a full copy of that leaf (exactly how software
    must handle DSA's delta overflow status).  The record is built with
    numpy on the host, as in the JAX package.
  * CRC32 per shard file, verified on restore; torn/corrupt saves are
    detected and the manager falls back to the previous valid manifest.
  * replicas=2 copies each save to ``<dir>-replica`` for rack-failure
    tolerance (a directory copy, as in the JAX package).
  * Saves run on a background thread, overlapped with the next train step
    (G2: async always); ``wait()`` joins the in-flight save and raises what
    it raised.
  * Kernel CRCs with a Device are engine descriptors, gathered with one
    ``wait_all``; when they fill the work queues, the save retires those in
    flight and submits again (the JAX package's manager raises QueueFull
    there).

Restored leaves are CPU tensors.  Restore onto a device mesh
(``shardings=``) comes with the distributed package (ROADMAP module 12).
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.core.device import QueueFull
from repro_torch.distributed.annotate import full
from repro_torch.distributed.sharding import place

#: numpy dtype names of the manifest <-> torch dtypes
_DTYPE_NAMES: Dict[torch.dtype, str] = {
    torch.float64: "float64", torch.float32: "float32", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.complex64: "complex64",
    torch.complex128: "complex128", torch.int64: "int64", torch.int32: "int32",
    torch.int16: "int16", torch.int8: "int8", torch.uint64: "uint64",
    torch.uint32: "uint32", torch.uint16: "uint16", torch.uint8: "uint8",
    torch.bool: "bool",
}
_TORCH_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """A leaf's bytes on the host, with its shape and numpy dtype name."""
    data: bytes
    shape: Tuple[int, ...]
    dtype: str


def _host_leaf(leaf) -> _Leaf:
    if isinstance(leaf, torch.Tensor):
        t = full(leaf.detach()).contiguous().cpu()  # a DTensor's whole value
        name = _DTYPE_NAMES.get(t.dtype)
        if name is None:
            raise TypeError(f"checkpoint: dtype {t.dtype} has no numpy name")
        return _Leaf(t.reshape(-1).view(torch.uint8).numpy().tobytes(), tuple(t.shape), name)
    arr = np.asarray(leaf)
    return _Leaf(arr.tobytes(), tuple(arr.shape), str(arr.dtype))


def _place_on_mesh(t: torch.Tensor, sharding) -> torch.Tensor:
    """A restored CPU tensor on ``sharding``'s mesh, laid out by it."""
    kind = sharding.mesh.device_type
    dev = (torch.device(kind, torch.cuda.current_device()) if kind == "cuda"
           else torch.device(kind))
    return place(t.to(dev), sharding)


def _tensor(data: bytes, dtype: str, shape) -> torch.Tensor:
    """A CPU tensor of ``dtype`` (a numpy name) and ``shape`` over a copy of
    ``data``."""
    dt = _TORCH_DTYPES.get(dtype)
    if dt is None:
        raise IOError(f"checkpoint: unknown dtype {dtype!r}")
    if not data:
        return torch.empty(tuple(shape), dtype=dt)
    return torch.frombuffer(bytearray(data), dtype=dt).reshape(tuple(shape))


def _u32_view(data: bytes) -> np.ndarray:
    pad = (-len(data)) % 4
    if pad:
        data = data + b"\0" * pad
    return np.frombuffer(data, dtype="<u4").copy()


def _words(data: bytes, device: torch.device) -> torch.Tensor:
    """``data`` zero-padded to whole words, as uint32 on ``device``."""
    buf = bytearray(data)
    buf += b"\0" * ((-len(buf)) % 4)
    if not buf:
        return torch.empty(0, dtype=torch.uint32, device=device)
    return torch.frombuffer(buf, dtype=torch.int32).view(torch.uint32).to(device)


@dataclasses.dataclass
class CheckpointConfig:
    directory: str
    full_every: int = 4  # every k-th save is a full snapshot
    delta_cap_frac: float = 0.25  # overflow threshold (fraction of words)
    replicas: int = 1  # 2 => a copy of every save in <dir>-replica
    verify_crc: bool = True
    async_save: bool = True
    keep: int = 8  # retained saves
    crc_impl: str = "zlib"  # "zlib" (host) | "kernel" (the CRC kernel on the card)


class CheckpointManager:
    def __init__(self, config: CheckpointConfig, device=None):
        self.cfg = config
        self.dir = Path(config.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.replica_dir = Path(str(self.dir) + "-replica") if config.replicas > 1 else None
        if self.replica_dir:
            self.replica_dir.mkdir(parents=True, exist_ok=True)
        self.device = device
        # where kernel CRCs run: the attached Device's engines, else CUDA;
        # with neither, this raises here rather than in the save thread
        self._crc_device = self._kernel_device() if config.crc_impl == "kernel" else None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._save_count = 0
        self._base: Optional[Dict[str, np.ndarray]] = None  # last full snapshot (u32 views)
        self._base_step: Optional[int] = None
        self.stats = {"full_leaves": 0, "delta_leaves": 0, "delta_overflows": 0,
                      "bytes_written": 0, "bytes_saved_by_delta": 0}

    def _kernel_device(self) -> torch.device:
        if self.device is not None:
            return self.device.engines[0].device
        if not torch.cuda.is_available():
            raise RuntimeError(
                "crc_impl='kernel' with no Device runs the CRC kernel on CUDA, and "
                "torch.cuda.is_available() is False: attach a Device "
                "(make_device(device='cpu') runs the kernels' plain versions) or "
                "use crc_impl='zlib'")
        return torch.device("cuda", torch.cuda.current_device())

    # ------------------------------------------------------------------ crc
    def _crc_submit(self, data: bytes):
        """CRC of ``data``: an int for host zlib, or a Future when the CRC
        runs as an engine descriptor (crc_impl="kernel" with a device):
        the save path submits one per leaf and gathers them with ONE
        ``device.wait_all`` instead of blocking leaf by leaf.  Kernel CRCs
        are over ``data`` zero-padded to whole words, as in the JAX
        package."""
        if self.cfg.crc_impl == "kernel":
            words = _words(data, self._crc_device)
            if self.device is not None:
                # fused copy+CRC descriptor: the save path reads each leaf
                # out anyway, so one copy_crc launch replaces the separate
                # copy and CRC passes; shows up in telemetry and shares the
                # instance pool with other checkpoint traffic
                fut = self.device.copy_crc_async(words, producer="checkpoint")
                return fut.then(lambda r: int(r[1]))
            from repro_torch.kernels import ops as kops

            return int(kops.crc32(words))
        return zlib.crc32(data) & 0xFFFFFFFF

    def _crc(self, data: bytes) -> int:
        c = self._crc_submit(data)
        return int(c.result()) if hasattr(c, "result") else c

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, *, force_full: bool = False):
        self.wait()  # one in-flight save at a time
        leaves = [(k, _host_leaf(v)) for k, v in _tree.flatten_with_names(tree)]
        # a second save of the step that holds the last full snapshot is full
        # too: as a delta against itself, its publish would delete the base
        # files it points at (the JAX package loses the step there)
        is_full = (force_full or self._base is None or step == self._base_step
                   or self._save_count % self.cfg.full_every == 0)
        self._save_count += 1

        def work():
            try:
                self._write(step, leaves, is_full)
            except Exception as e:  # re-raised by wait()
                self._error = e

        if self.cfg.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise()

    def _raise(self):
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _write(self, step: int, leaves: List[Tuple[str, _Leaf]], is_full: bool):
        tmp = self.dir / f".tmp_step_{step:08d}"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest: Dict[str, Any] = {
            "step": step,
            "kind": "full" if is_full else "delta",
            "base_step": None if is_full else self._base_step,
            "leaves": {},
        }
        new_base: Dict[str, np.ndarray] = {}
        # kernel CRCs are engine descriptors: submit per leaf, gather ONCE
        # through the completion subsystem (device.wait_all) at the end:
        # all leaf CRCs stream concurrently instead of blocking per leaf
        pending: List[Tuple[Dict[str, Any], str, Any]] = []

        def put_crc(entry: Dict[str, Any], field: str, data: bytes):
            try:
                c = self._crc_submit(data)
            except QueueFull:
                # the work queues are full of this save's own CRCs (a model
                # has hundreds of leaves, a WQ holds 32): retire them, then
                # submit again, as a DSA client retries a full WQ
                self.device.wait_all([f for _, _, f in pending])
                c = self._crc_submit(data)
            if hasattr(c, "result"):
                pending.append((entry, field, c))
            else:
                entry[field] = c

        for key, leaf in leaves:
            fn = key.replace("/", "__")
            data = leaf.data
            words = _u32_view(data)
            entry: Dict[str, Any] = {
                "shape": list(leaf.shape),
                "dtype": leaf.dtype,
                "nbytes": len(data),
            }
            if is_full or key not in (self._base or {}):
                (tmp / f"{fn}.bin").write_bytes(data)
                entry["mode"] = "full"
                put_crc(entry, "crc", data)
                self.stats["full_leaves"] += 1
                self.stats["bytes_written"] += len(data)
                new_base[key] = words
            else:
                base = self._base[key]
                cap = max(int(len(words) * self.cfg.delta_cap_frac), 16)
                diff = np.nonzero(words != base)[0]
                if len(diff) == 0:
                    entry["mode"] = "same"
                    put_crc(entry, "crc", data)
                    self.stats["bytes_saved_by_delta"] += len(data)
                elif len(diff) > cap:
                    # DSA delta-overflow status -> fall back to full copy
                    (tmp / f"{fn}.bin").write_bytes(data)
                    entry["mode"] = "full"
                    put_crc(entry, "crc", data)
                    self.stats["delta_overflows"] += 1
                    self.stats["bytes_written"] += len(data)
                else:
                    offs = diff.astype(np.int32)
                    vals = words[diff]
                    payload = offs.tobytes() + vals.tobytes()
                    np.savez(tmp / f"{fn}.delta.npz", offsets=offs, data=vals)
                    entry["mode"] = "delta"
                    entry["count"] = int(len(diff))
                    put_crc(entry, "crc", data)  # crc of FINAL contents
                    put_crc(entry, "payload_crc", payload)
                    self.stats["delta_leaves"] += 1
                    self.stats["bytes_written"] += len(payload)
                    self.stats["bytes_saved_by_delta"] += len(data) - len(payload)
            manifest["leaves"][key] = entry
        if pending:
            self.device.wait_all([f for _, _, f in pending])
            for entry, field, fut in pending:
                entry[field] = int(fut.result())
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        if self.replica_dir is not None:  # replica fan-out
            rep = self.replica_dir / final.name
            if rep.exists():
                shutil.rmtree(rep)
            shutil.copytree(final, rep)
        if is_full:
            self._base = new_base
            self._base_step = step
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        # never drop the full snapshots that live deltas depend on
        needed = set()
        for s in steps[-self.cfg.keep:]:
            m = self._manifest(s)
            if m and m.get("base_step") is not None:
                needed.add(m["base_step"])
        for s in steps[: -self.cfg.keep]:
            if s not in needed:
                shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------------ restore
    def all_steps(self) -> List[int]:
        return sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*") if p.is_dir()
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _manifest(self, step: int, directory: Optional[Path] = None) -> Optional[dict]:
        p = (directory or self.dir) / f"step_{step:08d}" / "manifest.json"
        if not p.exists():
            return None
        try:
            return json.loads(p.read_text())
        except json.JSONDecodeError:
            return None

    def _load_leaf_bytes(self, step: int, key: str, entry: dict, directory: Path) -> bytes:
        fn = key.replace("/", "__")
        data = (directory / f"step_{step:08d}" / f"{fn}.bin").read_bytes()
        if self.cfg.verify_crc and self._crc(data) != entry["crc"]:
            raise IOError(f"CRC mismatch for {key} at step {step}")
        return data

    def restore(self, step: Optional[int] = None, *, shardings=None, treedef_like=None):
        """Returns (step, {name: CPU tensor}, or a tree shaped like
        ``treedef_like``).  With ``shardings`` (a tree of
        ``distributed.sharding.NamedSharding``, e.g. ``{"params":
        tree_shardings(...), "opt": opt_state_shardings(...)}``) each leaf
        it names goes onto its mesh's device as a DTensor laid out by it;
        the others stay CPU tensors.

        Falls back step-by-step past CRC-corrupt saves (replica dir tried
        when the primary's copy of a step is unusable)."""
        self.wait()
        candidates = self.all_steps()
        if step is not None:
            candidates = [s for s in candidates if s <= step]
        for s in reversed(candidates):
            try:
                tree = self._restore_step(s)
                if shardings is not None:
                    named = dict(_tree.flatten_with_names(shardings))
                    tree = {k: _place_on_mesh(v, named[k]) if k in named else v
                            for k, v in tree.items()}
                if treedef_like is not None:
                    tree = self._unflatten_like(treedef_like, tree)
                return s, tree
            except (IOError, FileNotFoundError, KeyError) as e:
                print(f"[checkpoint] step {s} unusable ({e}); falling back")
        raise FileNotFoundError(f"no restorable checkpoint in {self.dir}")

    def _restore_step(self, step: int) -> Dict[str, torch.Tensor]:
        for directory in filter(None, [self.dir, self.replica_dir]):
            m = self._manifest(step, directory)
            if m is None:
                continue
            try:
                return self._materialize(m, step, directory)
            except IOError:
                continue  # try replica
        raise IOError(f"step {step}: no valid manifest/replica")

    def _materialize(self, manifest: dict, step: int, directory: Path) -> Dict[str, torch.Tensor]:
        base_step = manifest.get("base_step")
        base_manifest = self._manifest(base_step, directory) if base_step is not None else None
        out: Dict[str, torch.Tensor] = {}
        for key, entry in manifest["leaves"].items():
            mode = entry["mode"]
            if mode == "full":
                data = self._load_leaf_bytes(step, key, entry, directory)
            elif mode in ("same", "delta"):
                if base_manifest is None:
                    raise IOError(f"delta save {step} missing base {base_step}")
                data = self._load_leaf_bytes(base_step, key, base_manifest["leaves"][key],
                                             directory)
                if mode == "delta":
                    fn = key.replace("/", "__")
                    z = np.load(directory / f"step_{step:08d}" / f"{fn}.delta.npz")
                    words = _u32_view(data)
                    words[z["offsets"]] = z["data"]  # Apply Delta Record
                    data = words.tobytes()[: entry["nbytes"]]
                if self.cfg.verify_crc and self._crc(data) != entry["crc"]:
                    raise IOError(f"CRC mismatch after delta-apply for {key} at {step}")
            else:
                raise IOError(f"unknown mode {mode}")
            out[key] = _tensor(data, entry["dtype"], entry["shape"])
        return out

    @staticmethod
    def _unflatten_like(like, named: Dict[str, torch.Tensor]):
        names = [k for k, _ in _tree.flatten_with_names(like)]
        leaves = [named[k] for k in names]
        return _tree.unflatten(_tree.flatten(like)[1], leaves)
