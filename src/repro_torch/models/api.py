"""Public model API: ``build_model(cfg)``, ``make_batch`` and
``params_from_numpy`` (the JAX package's parameter tree, carried over).
"""
from __future__ import annotations

from typing import Any, Dict, Protocol, Tuple

import numpy as np
import torch

from repro_torch import tree as ttree
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models.decoder import DecoderModel


class Model(Protocol):
    cfg: ModelConfig

    def init(self, gen) -> dict: ...
    def loss(self, params, batch) -> Tuple[torch.Tensor, dict]: ...
    def prefill(self, params, batch, max_cache_len: int): ...
    def decode_step(self, params, cache, tokens, batch=None): ...
    def init_cache(self, bsz: int, max_cache_len: int) -> dict: ...


def build_model(cfg: ModelConfig, mesh=None, moe_dispatch: str = "dense",
                remat: bool = True, attn_impl: str = "chunked",
                tp_comm: str = "auto", remat_group: int = 1, device=None) -> Model:
    """The reference's keyword arguments, plus ``device``: None means CUDA
    (raising where no card is present), ``"cpu"`` the CPU."""
    if cfg.family == "audio":
        raise NotImplementedError("the encoder-decoder model is not ported yet (ROADMAP.md, "
                                  "queue 1, item 11: the other families)")
    return DecoderModel(cfg, mesh=mesh, moe_dispatch=moe_dispatch, remat=remat,
                        attn_impl=attn_impl, tp_comm=tp_comm, remat_group=remat_group,
                        device=device)


def make_batch(cfg: ModelConfig, bsz: int, seq: int, gen: torch.Generator,
               kind: str = "train") -> Dict[str, Any]:
    """Concrete small batch, drawn from ``gen`` on the generator's device."""
    if cfg.vlm is not None or cfg.encoder is not None:
        raise NotImplementedError("VLM and encoder-decoder batches are not ported yet "
                                  "(ROADMAP.md, queue 1, item 11: the other families)")
    batch: Dict[str, Any] = {
        "tokens": torch.randint(0, cfg.vocab_size, (bsz, seq), generator=gen,
                                device=gen.device, dtype=torch.int32)
    }
    if kind == "train":
        batch["loss_mask"] = torch.ones((bsz, seq), dtype=torch.float32, device=gen.device)
    return batch


def _leaf_to_tensor(a: Any) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16: carry the 16-bit words (the card's machine has
        # no ml_dtypes, and torch.from_numpy does not take the type)
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(tree: Any, device=None) -> Any:
    """The JAX package's parameter tree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's tree of tensors on
    ``device`` (None: CUDA), leaf for leaf, with JAX's structure and leaf
    names (``repro_torch.tree``)."""
    dev = resolve_device(device)
    return ttree.tree_map(lambda a: _leaf_to_tensor(a).to(dev), tree)
