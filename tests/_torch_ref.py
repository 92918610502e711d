"""Helpers shared by the tests that hold the port's model families against
the JAX package's (``test_torch_gemma_vlm.py``, ``test_torch_moe_ssm.py``,
``test_torch_hybrid_encdec.py``): the comparisons and their tolerances, the
reference model with its entry points jitted, the norm gains moved off
zero, and admission pinned for served-token tests."""
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.api import build_model as j_build

#: f32: 1e-5 relative, with an atol of 1e-5 of the reference's largest
#: magnitude (the same f32 arithmetic with sums in another order)
RTOL = 1e-5
#: bf16: within BF16_NOISE_FACTOR x the reference's own bf16-vs-f32
#: distance, or BF16_ATOL where that is larger
BF16_ATOL = 5e-2
BF16_NOISE_FACTOR = 2.0


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close_rel(got, want, err_msg=""):
    """rtol 1e-5, atol 1e-5 of ``want``'s largest magnitude."""
    w = np32(want)
    scale = float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(np32(got), w, rtol=RTOL, atol=RTOL * scale, err_msg=err_msg)


def close_bf16(got, want, want32, err_msg=""):
    """Within BF16_NOISE_FACTOR x the reference's own bf16-vs-f32 distance
    (or BF16_ATOL where that is larger)."""
    noise = float(np.abs(np32(want) - np32(want32)).max()) if np32(want).size else 0.0
    np.testing.assert_allclose(np32(got), np32(want), rtol=BF16_ATOL,
                               atol=max(BF16_ATOL, BF16_NOISE_FACTOR * noise),
                               err_msg=f"{err_msg} (bf16 noise {noise})")


def same(got, want):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(g, np.asarray(want))


def moved_norms(params, seed):
    """The JAX parameters with every norm gain (zeros at init) drawn at 0.1
    scale, so the norms' weights are held as well."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        name = str(path[-1])
        if "norm" in name or "ln" in name:
            return (a.astype(jnp.float32) + 0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(move, params)


class JaxModel:
    """The reference model with its entry points jitted."""

    def __init__(self, cfg, impl, remat):
        self.model = j_build(cfg, remat=remat, attn_impl=impl)
        self.cfg = cfg
        self.init = self.model.init
        self.init_cache = self.model.init_cache
        self.prefill = jax.jit(self.model.prefill, static_argnums=(2,))
        self.decode_step = jax.jit(self.model.decode_step)
        self.value_and_grad = jax.jit(jax.value_and_grad(self.model.loss, has_aux=True))


def pin_admission(device):
    """Wait for each prompt copy burst as it is submitted, so the server
    admits every request in the step after its copies went out, whatever
    the engines' speed.  At decode the reduced MoE's capacity is 1 (3
    slots, top-2 of 4 experts), so a request's tokens depend on which
    requests share its decode steps (ROADMAP.md, held for parity), and two
    servers that admit at other steps serve other tokens.  The wrapper
    holds the device weakly, so it makes no reference cycle."""
    submit = weakref.WeakMethod(device.batch_async)

    def batch_async(*a, **kw):
        fut = submit()(*a, **kw)
        fut.wait()
        return fut

    device.batch_async = batch_async
    return device
