"""The decode attention on the CPU: the wrapper's contract
(``repro_torch.kernels.decode_attention``), its plain version against the
JAX package's ``decode_attention``, the mask built with a Python scalar
against the ``torch.tensor(NEG_INF)`` it replaced, and the bound on live
slots (``n_live``) that each decode step passes it.  The kernel itself runs
only on the card (tests/test_torch_decode_attention_card.py)."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.configs.registry import get_config
from repro_torch.kernels import decode_attention as dk
from repro_torch.models import layers as TL
from repro_torch.models.api import build_model

F32_TOL = dict(rtol=1e-5, atol=1e-5)
#: bf16 inputs on both sides; the outputs round to bf16 (2^-8)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _inputs(rng, B=3, S=40, H=4, KV=2, hd=32, dtype=torch.float32):
    q = torch.from_numpy(rng.normal(size=(B, H, hd)).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.normal(size=(B, S, KV, hd)).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.normal(size=(B, S, KV, hd)).astype(np.float32)).to(dtype)
    return q, k, v


def _full(lengths, S):
    """(valid_mask, n_live) of full caches holding ``lengths`` tokens."""
    n = torch.tensor(lengths, dtype=torch.int32).clamp(max=S)
    return torch.arange(S)[None] < n[:, None], n


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values with a last dim that steps by 2."""
    out = t.new_zeros(*t.shape[:-1], 2 * t.shape[-1])
    out[..., ::2] = t
    return out[..., ::2]


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values starting one element past 16 bytes."""
    flat = t.new_zeros(t.numel() + 1)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def _odd_slot_stride(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in rows of KV * hd + 1 elements."""
    B, S, KV, hd = t.shape
    out = t.new_zeros(B, S, KV * hd + 1)
    view = out[..., :KV * hd].unflatten(-1, (KV, hd))
    view.copy_(t)
    return view


#: name -> (change to the arguments (q, k, v, valid, n_live), error, match)
REFUSED = {
    "q 4-D": (lambda a: (a[0][:, None],) + a[1:], ValueError, "expected q"),
    "cache 3-D": (lambda a: (a[0], a[1][:, :, 0], a[2][:, :, 0]) + a[3:], ValueError,
                  "expected q"),
    "mask 1-D": (lambda a: a[:3] + (a[3][0], a[4]), ValueError, "expected q"),
    "q bf16, cache f32": (lambda a: (a[0].bfloat16(),) + a[1:], TypeError, "types differ"),
    "k f32, v bf16": (lambda a: a[:2] + (a[2].bfloat16(),) + a[3:], TypeError, "types differ"),
    "f16": (lambda a: tuple(t.half() for t in a[:3]) + a[3:], TypeError, "bfloat16 or float32"),
    "mask int": (lambda a: a[:3] + (a[3].int(), a[4]), TypeError, "expected bool"),
    "n_live int64": (lambda a: a[:4] + (a[4].long(),), ValueError, "n_live"),
    "n_live of another length": (lambda a: a[:4] + (a[4][:2],), ValueError, "n_live"),
    "head dim 48": (lambda a: (a[0][..., :24].repeat(1, 1, 2), a[1][..., :24].repeat(1, 1, 1, 2),
                               a[2][..., :24].repeat(1, 1, 1, 2)) + a[3:], ValueError,
                    "head dim 48"),
    "9 query heads a KV head": (lambda a: (a[0][:, :1].repeat(1, 9, 1), a[1][:, :, :1],
                                           a[2][:, :, :1]) + a[3:], ValueError, "up to 8"),
    "3 query heads over 2": (lambda a: (a[0][:, :3],) + a[1:], ValueError, "query heads"),
    "last dim strided": (lambda a: (a[0], _strided(a[1])) + a[2:], ValueError, "copied"),
    "start off 16 bytes": (lambda a: a[:2] + (_misaligned(a[2]),) + a[3:], ValueError,
                           "copied"),
    "slot stride off 16 bytes": (lambda a: (a[0], _odd_slot_stride(a[1])) + a[2:], ValueError,
                                 "copied"),
    "an empty cache": (lambda a: (a[0], a[1][:, :0], a[2][:, :0], a[3][:, :0], a[4]),
                       ValueError, "S == 0"),
    "not a tensor": (lambda a: (a[0].numpy(),) + a[1:], TypeError, "torch.Tensor"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_wrapper_refuses_what_the_kernel_does_not_take(rng, case):
    """On either device: the CPU's plain version takes what the kernel
    takes, so a CPU run meets the card's refusals first."""
    change, err, match = REFUSED[case]
    q, k, v = _inputs(rng)
    valid, n_live = _full([1, 17, 40], 40)
    args = change((q, k, v, valid, n_live))
    for fn in (dk.decode_attention, dk.decode_attention_partials):
        with pytest.raises(err, match=match):
            fn(*args)


def test_the_wrapper_refuses_a_dtensor(rng):
    """A DTensor is a wrapper with no storage of its own: the kernel takes
    each rank's local tensors, inside ``layers.decode_attention``'s
    ``shard_map``."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device="cpu")
    q, k, v = _inputs(rng)
    valid, n_live = _full([1, 17, 40], 40)
    kd = DTensor.from_local(k, mesh, [Replicate(), Replicate()], run_check=False)
    with pytest.raises(TypeError, match="DTensor"):
        dk.decode_attention(q, kd, v, valid, n_live)


def test_the_wrapper_takes_a_layer_view_as_it_lies(rng):
    """A layer's view of a stacked cache (and a cache sliced along its
    slots) needs no copy: the plain version runs on it."""
    q, k, v = _inputs(rng)
    stack_k, stack_v = torch.stack([k, k * 2]), torch.stack([v, v * 2])
    valid, n_live = _full([1, 17, 40], 40)
    got = dk.decode_attention(q, stack_k[1], stack_v[1], valid, n_live)
    assert torch.equal(got, dk.decode_attention_plain(q, k * 2, v * 2, valid, n_live))
    got = dk.decode_attention(q, k[:, 8:], v[:, 8:], valid[:, 8:], None)
    assert got.shape == q.shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_n_live", [False, True], ids=["mask", "mask+n_live"])
def test_plain_version_matches_the_reference(rng, dtype, with_n_live):
    """Ragged rows, a row that holds one token, and a row with no valid
    slot at all, whose output is the mean of V over every slot."""
    B, S, H, KV, hd = 4, 40, 8, 2, 32
    q, k, v = _inputs(rng, B, S, H, KV, hd)
    lengths = [1, 17, 40, 0]
    valid, n_live = _full(lengths, S)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    want = JL.decode_attention(jnp.asarray(q.numpy(), jdt), jnp.asarray(k.numpy(), jdt),
                               jnp.asarray(v.numpy(), jdt), jnp.asarray(valid.numpy()))
    args = (q.to(tdt), k.to(tdt), v.to(tdt), valid, n_live if with_n_live else None)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for got in (dk.decode_attention_plain(*args), dk.decode_attention(*args),
                TL.decode_attention(*args[:4], n_live=args[4])):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    mean_v = v.to(tdt).float().mean(dim=1).repeat_interleave(H // KV, dim=1)
    np.testing.assert_allclose(dk.decode_attention_plain(*args)[3].float().numpy(),
                               mean_v[3].numpy(), **tol)


def _with_tensor_neg_inf(q, k_cache, v_cache, valid_mask):
    """The port's decode attention before the kernel: the reference's
    einsums with the masked score as a 0-d tensor made on the device."""
    B, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float()) * (1.0 / math.sqrt(hd))
    s = torch.where(valid_mask[:, None, None, :], s,
                    torch.tensor(dk.NEG_INF, dtype=torch.float32, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return s, o.reshape(B, H, hd).to(v_cache.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_n_live", [False, True], ids=["mask", "mask+n_live"])
def test_the_scalar_mask_is_bit_for_bit_the_tensor_mask(rng, dtype, with_n_live):
    """``torch.where`` with the Python float ``NEG_INF`` (no host tensor,
    no copy to the device, no wait) gives the same bits, scores and
    output, as the 0-d tensor it replaced; ``n_live`` at each full row's
    length changes no bit either."""
    q, k, v = _inputs(rng, 4, 40, 8, 2, 32, dtype)
    valid, n_live = _full([1, 17, 40, 0], 40)
    n_live = n_live if with_n_live else None
    want_s, want = _with_tensor_neg_inf(q, k, v, valid)
    assert torch.equal(dk.scores_plain(q, k, valid, n_live), want_s)
    assert torch.equal(dk.decode_attention(q, k, v, valid, n_live), want)
    assert torch.equal(TL.decode_attention(q, k, v, valid, n_live=n_live), want)


def test_partials_are_the_softmax_before_its_division(rng):
    """(o, m, l): the f32 output, the row's largest score and its sum of
    exp(s - m); a row with no valid slot reads NEG_INF and S, its output
    the mean of V."""
    q, k, v = _inputs(rng, 4, 40, 8, 2, 32)
    valid, n_live = _full([1, 17, 40, 0], 40)
    o, m, l = dk.decode_attention_partials(q, k, v, valid, n_live)
    s = dk.scores_plain(q, k, valid, n_live)
    assert torch.equal(m, s.amax(-1).reshape(4, 8))
    torch.testing.assert_close(l, torch.exp(s - s.amax(-1, keepdim=True)).sum(-1).reshape(4, 8))
    torch.testing.assert_close(o, dk.decode_attention_plain(q, k, v, valid, n_live), **F32_TOL)
    assert bool((m[3] == dk.NEG_INF).all()) and bool((l[3] == 40).all())


def test_sequence_split_path_on_the_cpu_host_mesh(rng):
    """Under rules that put the cache's sequence on a mesh axis, the
    existing max / sum combine (one rank here) gives the plain output."""
    from repro_torch.distributed.annotate import use_rules
    from repro_torch.distributed.sharding import rules_for_mesh
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device="cpu")
    rules = rules_for_mesh(mesh, {"seq": "model", "kv_heads": None, "heads": None})
    q, k, v = _inputs(rng, 4, 40, 8, 2, 32)
    valid, n_live = _full([1, 17, 40, 0], 40)
    with use_rules(mesh, rules):
        got = TL.decode_attention(q, k, v, valid, n_live=n_live)
    torch.testing.assert_close(got, dk.decode_attention_plain(q, k, v, valid, n_live),
                               **F32_TOL)


# --------------------------------------------------------------------------- n_live
def _decode_calls(monkeypatch, arch: str, lengths) -> tuple:
    """One decode step of ``arch``'s reduced f32 model on the CPU, its
    cache's lengths set to ``lengths`` first; every call of
    ``layers.decode_attention`` it made, as (valid_mask, n_live, S)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = build_model(cfg, remat=False, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    B = len(lengths)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, 6), generator=g,
                                     dtype=torch.int32)}
    if cfg.encoder is not None:
        batch["frame_embeds"] = torch.randn(B, cfg.encoder.source_len, cfg.d_model, generator=g)
    cache, _, _ = model.prefill(params, batch, max_cache_len=16)
    cache["lengths"] = torch.tensor(lengths, dtype=torch.int32)
    calls = []
    plain = TL.decode_attention

    def spy(q, k_cache, v_cache, valid_mask, *, n_live=None, scale=None):
        calls.append((valid_mask.clone(), None if n_live is None else n_live.clone(),
                      k_cache.shape[1]))
        return plain(q, k_cache, v_cache, valid_mask, n_live=n_live, scale=scale)

    monkeypatch.setattr(TL, "decode_attention", spy)
    logits, _ = model.decode_step(params, cache, batch["tokens"][:, :1])
    assert bool(torch.isfinite(logits).all())
    return cfg, calls


#: arch -> the kinds of cache its reduced() decode attends (gemma3's 4 layers
#: are all local): "full" (n_live from the lengths), "ring" and "cross"
#: (n_live None: every slot may be live)
KINDS = {"tinyllama-1.1b": {"full"}, "gemma3-1b": {"ring"},
         "hymba-1.5b": {"full", "ring"}, "seamless-m4t-medium": {"full", "cross"}}


@pytest.mark.parametrize("arch", list(KINDS))
def test_n_live_bounds_every_valid_slot(monkeypatch, arch):
    """Rows short, full and past the end (an idle slot that keeps counting):
    a full cache's n_live is lengths + 1 (the kernel reads no slot past S
    either); a ring's and the cross attention's is None (S); in every call
    the mask is False at and past the bound, and at least one slot below it
    is valid."""
    cfg, calls = _decode_calls(monkeypatch, arch, [3, 15, 16, 40])
    lengths = torch.tensor([3, 15, 16, 40])
    seen = set()
    for valid, n_live, S in calls:
        if n_live is not None:
            seen.add("full")
            assert torch.equal(n_live, (lengths + 1).to(torch.int32))
            bound = n_live.long().clamp(max=S)
        else:
            cross = cfg.encoder is not None and S == cfg.encoder.source_len
            seen.add("cross" if cross else "ring")
            bound = torch.full((valid.shape[0],), S)
        past = torch.arange(S)[None] >= bound[:, None]
        assert not bool((valid & past).any())
        assert bool(valid.any(dim=1).all())
    assert seen == KINDS[arch], seen
