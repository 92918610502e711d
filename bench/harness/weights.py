"""The benchmark's own weights, drawn on the device from the run's seed.

Every leaf of every layer comes from a generator of its own, seeded from
(seed, the leaf's path inside its layer, the layer's index), in the
leaf's own type and shape.  So the program's tree (stacked [n, ...] where
a segment scans its layers) and the reference's layer-by-layer copy hold
the same values, and the reference can draw one layer again after the
program's state is gone, without keeping a second copy.

The program's tree layout is read from its own ``init`` run on fake
tensors (shapes and types only, no values); the values are this file's.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

def _a_log(h: int) -> np.ndarray:
    """Mamba-2's A = -exp(A_log) over 1..16 across the heads."""
    return np.log(np.linspace(1.0, 16.0, h))


def _dt_bias(h: int) -> np.ndarray:
    """Mamba-2's dt bias: softplus^-1 of dt over 1e-3..1e-1 across the heads."""
    return np.log(np.expm1(np.linspace(1e-3, 1e-1, h)))


def rule(path: str, shape) -> Tuple[str, Any]:
    """How a leaf is drawn, by its name and shape: a table over the heads
    (Mamba-2's ``A_log``, ``dt_bias``), a constant (``D``), a normal draw
    times a scale: 0.02 for a vector (a norm's gain, the program's
    ``1 + w``, or a bias), an embedding table or the meta tokens; 0.05 for
    a convolution's taps; fan-in ** -0.5 for any other matrix, whose
    contraction is its next-to-last dim.  The scales keep every bf16 leaf
    small enough that an AdamW step of 1e-3 moves it by several of its
    bf16 steps."""
    name = path.split(".")[-1]
    if name == "A_log":
        return "table", _a_log
    if name == "dt_bias":
        return "table", _dt_bias
    if name == "D":
        return "const", 1.0
    if name == "conv_w":
        return "normal", 0.05
    if len(shape) < 2 or name in ("embed", "meta_tokens"):
        return "normal", 0.02
    return "normal", float(shape[-2]) ** -0.5


def leaf_seed(seed: int, path: str, layer: Optional[int]) -> int:
    digest = hashlib.sha256(f"{seed}/{path}/{layer}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def fill(t: torch.Tensor, seed: int, path: str, layer: Optional[int]) -> torch.Tensor:
    """Draw leaf ``path`` of ``layer`` (None: outside the layers) into
    ``t`` in place."""
    kind, arg = rule(path, t.shape)
    if kind == "normal":
        gen = torch.Generator(device=t.device).manual_seed(leaf_seed(seed, path, layer))
        t.normal_(0.0, arg, generator=gen)
    elif kind == "const":
        t.fill_(arg)
    else:
        t.copy_(torch.as_tensor(arg(t.shape[-1]), dtype=torch.float64).expand(t.shape))
    return t


def _walk(tree: Any, prefix: str = ""):
    """(path, leaf) of a nested dict, in key order."""
    for k, v in tree.items():
        p = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _walk(v, p)
        else:
            yield p, v


def _is_stack(tree: dict) -> bool:
    """Whether every leaf of ``tree`` has the same leading dim."""
    dims = {t.shape[0] if t.dim() else None for _, t in _walk(tree)}
    return len(dims) == 1 and None not in dims


def _get(tree: dict, path: str):
    for k in path.split("."):
        tree = tree[k]
    return tree


def _set(tree: dict, path: str, value) -> None:
    keys = path.split(".")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


class Layout:
    """The program's parameter tree as (path, layer) leaves: ``top`` the
    leaves outside the layers, ``layers[i]`` layer i's {path: (shape,
    dtype)}.  The layers sit in stacks, each unrolled (a list of layers)
    or scanned (one dict of [n, ...] leaves, a layer a trip): the items
    of a top-level list (the decoder's ``segments``), or a top-level dict
    whose leaves share their leading dim (an encoder-decoder's
    ``enc_layers`` and ``dec_layers``).  ``stacks`` lists them in order
    as (key, index in the key's list or None, kind, layers, first layer).
    """

    def __init__(self, model_cfg, build_model):
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            fake = build_model(model_cfg, device="cpu").init(torch.Generator())
        self.top: Dict[str, Tuple[tuple, torch.dtype]] = {}
        self.layers: List[Dict[str, Tuple[tuple, torch.dtype]]] = []
        self.stacks: List[Tuple[str, Optional[int], str, int, int]] = []
        self.keys = list(fake)
        for key, val in fake.items():
            if isinstance(val, list):
                for j, seg in enumerate(val):
                    self._add_stack(key, j, seg)
            elif isinstance(val, dict) and _is_stack(val):
                self._add_stack(key, None, val)
            elif isinstance(val, dict):
                for p, t in _walk(val, key):
                    self.top[p] = (tuple(t.shape), t.dtype)
            else:
                self.top[key] = (tuple(val.shape), val.dtype)

    def _add_stack(self, key: str, j: Optional[int], seg) -> None:
        first = len(self.layers)
        if isinstance(seg, list):
            self.stacks.append((key, j, "unroll", len(seg), first))
            for layer in seg:
                self.layers.append({p: (tuple(t.shape), t.dtype) for p, t in _walk(layer)})
        else:
            leaves = list(_walk(seg))
            n = leaves[0][1].shape[0]
            self.stacks.append((key, j, "scan", n, first))
            for _ in range(n):
                self.layers.append({p: (tuple(t.shape[1:]), t.dtype) for p, t in leaves})

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def program_params(self, seed: int, device) -> dict:
        """The program's tree on ``device``, every value drawn here."""
        params: Dict[str, Any] = {}
        for p, (shape, dtype) in self.top.items():
            _set(params, p, fill(torch.empty(shape, dtype=dtype, device=device), seed, p, None))
        for key, j, kind, n, i in self.stacks:
            if kind == "unroll":
                seg = []
                for k in range(n):
                    layer: dict = {}
                    for p, (shape, dtype) in self.layers[i + k].items():
                        _set(layer, p, fill(torch.empty(shape, dtype=dtype, device=device),
                                            seed, p, i + k))
                    seg.append(layer)
            else:
                seg = {}
                for p, (shape, dtype) in self.layers[i].items():
                    t = torch.empty((n,) + shape, dtype=dtype, device=device)
                    for k in range(n):
                        fill(t[k], seed, p, i + k)
                    _set(seg, p, t)
            if j is None:
                params[key] = seg
            else:
                params.setdefault(key, []).append(seg)
        return {k: params[k] for k in self.keys}

    def views(self, tree: dict) -> Dict[Tuple[str, Optional[int]], torch.Tensor]:
        """{(path, layer): the leaf's tensor} of a tree laid out like the
        program's parameters (the parameters themselves, or the optimizer's
        moments): a scanned stack's leaves as views of one layer."""
        out: Dict[Tuple[str, Optional[int]], torch.Tensor] = {}
        for p in self.top:
            out[(p, None)] = _get(tree, p)
        for key, j, kind, n, i in self.stacks:
            seg = tree[key] if j is None else tree[key][j]
            if kind == "unroll":
                for k, layer in enumerate(seg):
                    for p, t in _walk(layer):
                        out[(p, i + k)] = t
            else:
                for p, t in _walk(seg):
                    for k in range(n):
                        out[(p, i + k)] = t[k]
        return out

    def leaf(self, seed: int, path: str, layer: Optional[int], device,
             dtype=torch.float32) -> torch.Tensor:
        """One leaf drawn again, in its own type, then as ``dtype``."""
        shape, own = self.top[path] if layer is None else self.layers[layer][path]
        return fill(torch.empty(shape, dtype=own, device=device), seed, path, layer).to(dtype)

    def layer(self, seed: int, i: int, device, dtype=torch.float32) -> dict:
        """Layer i's leaves drawn again, as a nested dict of ``dtype``."""
        out: dict = {}
        for p in self.layers[i]:
            _set(out, p, self.leaf(seed, p, i, device, dtype))
        return out


class Weights:
    """What a reference reads: the leaves outside the layers and each
    layer, drawn again from the seed on ``device`` in float32."""

    def __init__(self, layout: Layout, seed: int, device):
        self.layout, self.seed, self.device = layout, seed, device

    @property
    def n_layers(self) -> int:
        return self.layout.n_layers

    def top(self, name: str) -> torch.Tensor:
        return self.layout.leaf(self.seed, name, None, self.device)

    def layer(self, i: int) -> dict:
        return self.layout.layer(self.seed, i, self.device)

    def leaves(self) -> Dict[Tuple[str, Optional[int]], torch.Tensor]:
        """Every (path, layer) leaf at once (for a training step)."""
        out = {(p, None): self.top(p) for p in self.layout.top}
        for i, layer in enumerate(self.layout.layers):
            for p in layer:
                out[(p, i)] = self.layout.leaf(self.seed, p, i, self.device)
        return out
