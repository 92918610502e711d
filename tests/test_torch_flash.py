"""The port's flash attention (repro_torch.kernels.flash_attention) and the
attention layers (repro_torch.models.layers) against the JAX package's.

On the CPU the port's ``flash_attention`` runs its plain version; the JAX
package's Pallas kernel runs in interpret mode, as its own tests run it.
Inputs are made with numpy from a seed and handed to both.

Tolerances: f32 atol = rtol = 2e-5.  The two compute the same f32 sums in
another order (the Pallas kernel in 64-row tiles or the block its halving
gives, the plain version in one pass), which moves a result by a few f32
ulps of the largest terms.  bf16 atol = rtol = 2e-2: p is rounded to bf16
before P.V in both, relative to the running max of a tile in the kernel
and to the row's max in the plain version, so one p can round one bf16 ulp
(2^-8) apart, and the output is rounded to bf16 (2^-8 relative) at the end.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as tflash
from repro_torch.models import layers as TL

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)

# the reference's own cases (tests/test_flash_attention.py), then ragged
# lengths: 1, 33 and 77 tokens (the Pallas kernel's blocks halve to 1 row)
CASES = [
    # B, Sq, Skv, H, KV, hd, causal, window, n_meta
    (2, 128, 128, 4, 2, 32, True, 0, 0),
    (1, 256, 256, 8, 8, 64, True, 0, 0),
    (2, 128, 128, 4, 1, 32, True, 64, 0),
    (1, 256, 256, 4, 2, 32, True, 64, 16),
    (2, 128, 128, 4, 4, 64, False, 0, 0),
    (1, 64, 64, 2, 2, 128, True, 0, 0),
    (1, 1, 1, 4, 2, 32, True, 0, 0),
    (1, 33, 33, 4, 1, 64, True, 0, 0),
    (2, 77, 77, 4, 2, 32, True, 16, 4),
]


def _inputs(rng, B, Sq, Skv, H, KV, hd):
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Skv, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Skv, KV, hd)).astype(np.float32)
    return q, k, v


def _t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x, jnp.float32).astype(dtype)


@pytest.mark.parametrize("case", CASES)
def test_plain_flash_matches_the_pallas_kernel(rng, case):
    B, Sq, Skv, H, KV, hd, causal, window, n_meta = case
    q, k, v = _inputs(rng, B, Sq, Skv, H, KV, hd)
    want = j_flash(_j(q), _j(k), _j(v), causal=causal, window=window, n_meta=n_meta)
    got = tflash.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                                 n_meta=n_meta)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, Sq, H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_plain_flash_bf16_matches_the_pallas_kernel(rng):
    q, k, v = _inputs(rng, 1, 128, 128, 4, 2, 64)
    want = j_flash(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16),
                   q_blk=64, kv_blk=64)
    got = tflash.flash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                                 _t(v, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_a_row_with_no_visible_key_is_the_mean_of_v(rng, causal):
    """Sq > Skv with a window: rows at or past Skv - 1 + window see no key.
    Their masked scores are all NEG_INF, so p = 1 for every key and the row
    is the mean of V, in the reference and in the port."""
    B, Sq, Skv, H, KV, hd, window = 1, 64, 16, 2, 1, 32, 8
    q, k, v = _inputs(rng, B, Sq, Skv, H, KV, hd)
    want = np.asarray(j_flash(_j(q), _j(k), _j(v), causal=causal, window=window))
    got = tflash.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    empty = np.arange(Sq) >= Skv - 1 + window
    assert empty.any() and not empty.all()
    mean_v = v.mean(axis=1)[:, None]  # [B, 1, KV, hd]; one KV head serves both
    np.testing.assert_allclose(got[:, empty], np.broadcast_to(mean_v, got[:, empty].shape),
                               **F32_TOL)
    mask = tflash.mask_block(torch.arange(Sq), torch.arange(Skv), causal=causal,
                             window=window, n_meta=0)
    assert not mask[empty].any() and mask[~empty].any(dim=1).all()


def test_plain_flash_keeps_the_scale_argument(rng):
    q, k, v = _inputs(rng, 1, 48, 48, 2, 2, 32)
    want = j_flash(_j(q), _j(k), _j(v), scale=0.3, q_blk=16, kv_blk=16)
    got = tflash.flash_attention(_t(q), _t(k), _t(v), scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("bad", ["hd", "dtype", "mixed", "heads", "rank", "no_keys"])
def test_flash_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 4, 4, 32)
    k = v = torch.zeros(1, 4, 2, 32)
    if bad == "hd":
        q, k, v = torch.zeros(1, 4, 4, 48), torch.zeros(1, 4, 2, 48), torch.zeros(1, 4, 2, 48)
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        q = q.bfloat16()
    elif bad == "heads":
        k = v = torch.zeros(1, 4, 3, 32)
    elif bad == "rank":
        q = q[0]
    else:
        k = v = torch.zeros(1, 0, 2, 32)
    with pytest.raises((ValueError, TypeError)):
        tflash.flash_attention(q, k, v)


def test_flash_on_cpu_tensors_takes_the_plain_version_and_counts_nothing(rng, monkeypatch):
    from repro_torch.kernels import _build

    def no_library():
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(_build, "library", no_library)
    before = tflash.flash_attention.launches
    q, k, v = _inputs(rng, 1, 8, 8, 2, 1, 32)
    tflash.flash_attention(_t(q), _t(k), _t(v))
    assert tflash.flash_attention.launches == before


# --------------------------------------------------------------------------- the layers' attention
@pytest.mark.parametrize("case", CASES[:6] + [(1, 1056, 1056, 2, 1, 32, True, 0, 0),
                                              (1, 1100, 1100, 2, 2, 32, True, 256, 8)])
def test_chunked_attention_matches_the_reference(rng, case):
    """``layers.attention``: the dense block below 1 Mi scores, the chunked
    online softmax with block skipping above (the last two cases)."""
    B, Sq, Skv, H, KV, hd, causal, window, n_meta = case
    q, k, v = _inputs(rng, B, Sq, Skv, H, KV, hd)
    want = JL.attention(_j(q), _j(k), _j(v), causal=causal, window=window, n_meta=n_meta)
    got = TL.attention(_t(q), _t(k), _t(v), causal=causal, window=window, n_meta=n_meta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("Sq", [16, 1100])
def test_chunked_attention_bf16_matches_the_reference(rng, Sq):
    q, k, v = _inputs(rng, 1, Sq, Sq, 4, 2, 32)
    bf = jnp.bfloat16
    want = JL.attention(_j(q, bf), _j(k, bf), _j(v, bf))
    got = TL.attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_the_reference(rng, dtype):
    B, S, H, KV, hd = 3, 40, 4, 2, 32
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kc = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    vc = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    valid = np.arange(S)[None] <= np.array([0, 17, 39])[:, None]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    want = JL.decode_attention(_j(q, jdt), _j(kc, jdt), _j(vc, jdt), jnp.asarray(valid))
    got = TL.decode_attention(_t(q, tdt), _t(kc, tdt), _t(vc, tdt), torch.from_numpy(valid))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_attention_trainable_dispatches_like_the_reference(rng, impl):
    q, k, v = _inputs(rng, 1, 64, 64, 4, 2, 32)
    want = JL.attention_trainable(_j(q), _j(k), _j(v), impl=impl)
    got = TL.attention_trainable(_t(q), _t(k), _t(v), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_flash_has_no_backward_yet(rng):
    q, k, v = (t.requires_grad_() for t in map(_t, _inputs(rng, 1, 8, 8, 2, 1, 32)))
    with pytest.raises(NotImplementedError):
        TL.attention_trainable(q, k, v, impl="flash")
