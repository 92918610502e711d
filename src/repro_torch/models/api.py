"""Public model API: ``build_model(cfg)``, ``make_batch``, and
``params_from_numpy`` / ``opt_state_from_numpy`` (the JAX package's
parameter tree and AdamW state, carried over).
"""
from __future__ import annotations

from typing import Any, Dict, Protocol, Tuple

import numpy as np
import torch

from repro_torch import tree as ttree
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models.decoder import DecoderModel
from repro_torch.models.encdec import EncDecModel
from repro_torch.optim.adamw import AdamWState


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
    (raising where no card is present), ``"cpu"`` the CPU.  The
    encoder-decoder ignores ``attn_impl`` and the decoder-only options, as
    the reference's does."""
    if cfg.family == "audio":
        return EncDecModel(cfg, mesh=mesh, remat=remat, device=device)
    return DecoderModel(cfg, mesh=mesh, moe_dispatch=moe_dispatch, remat=remat,
                        attn_impl=attn_impl, tp_comm=tp_comm, remat_group=remat_group,
                        device=device)


def make_batch(cfg: ModelConfig, bsz: int, seq: int, gen: torch.Generator,
               kind: str = "train") -> Dict[str, Any]:
    """Concrete small batch, drawn from ``gen`` on the generator's device.
    A VLM's batch adds patch embeddings [B, min(num_patches, S - 2), D]
    (they replace the tokens from position 1 and are left out of the loss)
    and ``positions_thw`` [3, B, S], the sequence index in each stream.  An
    encoder-decoder's adds ``frame_embeds`` [B, source_len, D], 0.02 x a
    normal draw in the model's dtype."""
    dev = gen.device
    dt = getattr(torch, cfg.dtype)
    batch: Dict[str, Any] = {
        "tokens": torch.randint(0, cfg.vocab_size, (bsz, seq), generator=gen,
                                device=dev, dtype=torch.int32)
    }
    if kind == "train":
        batch["loss_mask"] = torch.ones((bsz, seq), dtype=torch.float32, device=dev)
    if cfg.vlm is not None:
        npch = min(cfg.vlm.num_patches, max(seq - 2, 1))
        batch["patch_embeds"] = torch.randn((bsz, npch, cfg.d_model), generator=gen,
                                            device=dev).to(dt) * 0.02
        pos = torch.arange(seq, dtype=torch.int32, device=dev)[None].expand(bsz, seq)
        batch["positions_thw"] = torch.stack([pos, pos, pos])
        if kind == "train":
            batch["loss_mask"][:, 1:1 + npch] = 0.0
    if cfg.encoder is not None:
        batch["frame_embeds"] = torch.randn((bsz, cfg.encoder.source_len, cfg.d_model),
                                            generator=gen, device=dev).to(dt) * 0.02
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


def opt_state_from_numpy(state: Any, device=None):
    """The JAX package's ``AdamWState`` with numpy leaves (e.g.
    ``jax.tree.map(np.asarray, opt_state)``) as the port's ``AdamWState``
    on ``device`` (None: CUDA): the int32 step and the f32 moments, leaf
    for leaf."""
    step, m, v = state
    return AdamWState(step=params_from_numpy(step, device=device),
                      m=params_from_numpy(m, device=device),
                      v=params_from_numpy(v, device=device))
