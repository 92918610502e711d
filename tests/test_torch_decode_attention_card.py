"""The decode attention kernel on the card (marked ``card``: each test skips
where no CUDA card is present).  Run them on the card with
``python -m pytest -q -m card tests/test_torch_decode_attention_card.py``.

Each holds the kernel (csrc/decode_attention.cu) against its plain version
(``decode_attention_plain``: the reference's einsums, on the same card and
the same inputs).  Both compute scores, softmax and P.V in f32 from the same
stored values; they differ only in the order of their f32 sums.  So the
kernel's f32 output (``decode_attention_partials``) must agree to F32_TOL,
and its output in the cache's type must be the plain version's f32 result
rounded to that type, give or take one rounding step (a value that lies on
a rounding boundary may go either way)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as dk

#: kernel against plain, both in f32: sums of up to 3584 terms in another
#: order (f32's 6e-8 a step), over values of order 1
F32_TOL = dict(rtol=2e-5, atol=2e-6)

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode attention kernel has no CPU form")
    return torch.device("cuda", 0)


def mix_lengths(rng, B: int, mix: str) -> np.ndarray:
    """Live slots of B decoding rows: a prompt and part of its output, drawn
    as the benchmark's chat mix (lognormal prompts of median 1020, sigma
    0.9, 64-3072; outputs of median 129, sigma 0.8, 16-512) or rag mix
    (prompts uniform 2048-3584, outputs 16-64) draws them."""
    if mix == "chat":
        prompt = np.clip(1020 * np.exp(0.9 * rng.standard_normal(B)), 64, 3072)
        out = np.clip(129 * np.exp(0.8 * rng.standard_normal(B)), 16, 512)
    else:
        prompt, out = rng.integers(2048, 3585, B), rng.integers(16, 65, B)
    return (prompt + rng.uniform(0, 1, B) * out).astype(np.int64) + 1


def inputs(dev, B, S, H, KV, hd, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return normal(B, H, hd), normal(B, S, KV, hd), normal(B, S, KV, hd)


def full_cache(dev, lengths, S):
    """(valid_mask, n_live) of full caches holding ``lengths`` tokens (the
    current one included), clipped at S."""
    n = torch.as_tensor(np.minimum(lengths, S), dtype=torch.int32, device=dev)
    return torch.arange(S, device=dev)[None] < n[:, None], n


def rounding_step(want: torch.Tensor, dtype) -> torch.Tensor:
    """One step of ``dtype``'s rounding at each of ``want``'s values."""
    if dtype == torch.float32:
        return want.abs() * 2.0 ** -23 + 1e-30
    return 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)


def check_against_plain(q, k, v, valid, n_live):
    want = dk.decode_attention_partials_plain(q, k, v, valid, n_live)
    got = dk.decode_attention_partials(q, k, v, valid, n_live)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F32_TOL)
    out = dk.decode_attention(q, k, v, valid, n_live)
    assert out.dtype == q.dtype and out.shape == q.shape
    # the rounded output: the plain version's f32 value to within one
    # rounding step of the cache's type, on top of F32_TOL
    slack = rounding_step(want[0], q.dtype) + F32_TOL["atol"] + F32_TOL["rtol"] * want[0].abs()
    assert bool(((out.float() - want[0]).abs() <= slack).all())
    return float((out.float() - want[0]).abs().max())


#: (name, B, S, H, KV, hd): deepseek-moe-16b's chat and rag decode shapes
#: (G = 1), hymba-1.5b's (G = 5, hd 64), gemma3-1b's (G = 4, hd 256),
#: tinyllama's (G = 8) and the reduced configs' (hd 32)
SHAPES = (("deepseek chat", 24, 3584, 16, 16, 128), ("deepseek rag", 16, 3648, 16, 16, 128),
          ("hymba", 8, 1152, 25, 5, 64), ("gemma3", 4, 2048, 4, 1, 256),
          ("tinyllama", 4, 1024, 32, 4, 64), ("reduced", 3, 96, 4, 2, 32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_kernel_matches_plain_on_full_caches(card, shape, dtype):
    name, B, S, H, KV, hd = shape
    rng = np.random.default_rng(B * S + hd)
    q, k, v = inputs(card, B, S, H, KV, hd, dtype)
    lengths = mix_lengths(rng, B, "rag" if "rag" in name else "chat")
    lengths[0] = 1  # a row that holds only its first token
    lengths[-1] = S + 7  # an idle row that kept counting past the end
    valid, n_live = full_cache(card, lengths, S)
    launches = dk.decode_attention.launches
    check_against_plain(q, k, v, valid, n_live)
    assert dk.decode_attention.launches == launches + 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernel_on_rings_and_empty_rows(card, dtype):
    """A ring with meta tokens (holes anywhere, n_live None), a row with no
    valid slot at all (the mean of V over all S), n_live 0 and n_live past
    S in one batch."""
    B, S, H, KV, hd = 6, 1152, 25, 5, 64
    q, k, v = inputs(card, B, S, H, KV, hd, dtype, seed=1)
    g = torch.Generator(device=card).manual_seed(2)
    valid = torch.rand(B, S, generator=g, device=card) < 0.7
    valid[:, :128] = True  # meta tokens
    valid[2] = False
    check_against_plain(q, k, v, valid, None)
    n_live = torch.tensor([S, 700, S, 0, 1, S + 50], dtype=torch.int32, device=card)
    check_against_plain(q, k, v, valid, n_live)
    out = dk.decode_attention(q, k, v, valid, n_live).float()
    mean_v = v.float().mean(dim=1).repeat_interleave(H // KV, dim=1)
    for row in (2, 3):  # no valid slot: the mean of V over all S slots
        want = mean_v[row]
        slack = rounding_step(want, dtype) + F32_TOL["atol"] + F32_TOL["rtol"] * want.abs()
        assert bool(((out[row] - want).abs() <= slack).all())


def test_layer_view_of_the_stacked_cache_is_read_in_place(card, monkeypatch):
    """A layer's view of a stacked [L, B, S, KV, hd] cache reaches the kernel
    as it lies: the pointer the kernel gets is the view's, and the call
    allocates no more than its output and partials (far below one layer's
    cache)."""
    Lyr, B, S, H, KV, hd = 3, 8, 2048, 16, 16, 128
    stack_k = torch.randn(Lyr, B, S, KV, hd, device=card).to(torch.bfloat16)
    stack_v = torch.randn(Lyr, B, S, KV, hd, device=card).to(torch.bfloat16)
    q = torch.randn(B, H, hd, device=card).to(torch.bfloat16)
    valid, n_live = full_cache(card, np.full(B, S), S)
    seen = []
    launch = _build.launch

    def spy(name, *args):
        seen.append(args[1:3])
        return launch(name, *args)

    monkeypatch.setattr(_build, "launch", spy)
    k1, v1 = stack_k[1], stack_v[1]
    dk.decode_attention(q, k1, v1, valid, n_live)  # builds and warms up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = dk.decode_attention(q, k1, v1, valid, n_live)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert seen[-1] == (k1.data_ptr(), v1.data_ptr())
    assert k1.data_ptr() == stack_k.data_ptr() + stack_k[0].numel() * stack_k.element_size()
    assert grown < k1.numel() * k1.element_size() // 16, grown
    # both round an f32 result to bf16 once: at most one bf16 step (2^-7
    # relative) apart where the f32 values straddle a rounding boundary
    torch.testing.assert_close(out.float(), dk.decode_attention_plain(q, k1, v1, valid, n_live)
                               .float(), rtol=2 ** -7, atol=1e-3)
    # a cache the kernel would have to copy is refused, not copied
    with pytest.raises(ValueError, match="copied"):
        dk.decode_attention(q, k1.new_empty(B, S, KV, 2 * hd)[..., ::2], v1, valid, n_live)


def test_decode_step_never_waits_for_the_card(card):
    """A reduced deepseek-moe-16b decode step (bf16, the served path's
    flash prefill first) under ``set_sync_debug_mode("error")``: nothing in
    it synchronises with the card, and its attention is the kernel's."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model

    cfg = get_config("deepseek-moe-16b").reduced()
    model = build_model(cfg, remat=False, attn_impl="flash", device=card)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (3, 24), device=card, dtype=torch.int32)
    cache, _, _ = model.prefill(params, {"tokens": tokens}, 64)
    step = torch.randint(0, cfg.vocab_size, (3, 1), device=card, dtype=torch.int32)
    model.decode_step(params, cache, step)  # warm: first calls may build or allocate
    torch.cuda.synchronize()
    launches = dk.decode_attention.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = model.decode_step(params, cache, step)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert dk.decode_attention.launches == launches + cfg.num_layers
    assert bool(torch.isfinite(logits).all())


def test_sequence_split_combine_on_the_card(card):
    """The rules path with the cache's sequence on a mesh axis (a world-1
    host mesh: one rank holds it all): the kernel's rows, maxima and sums
    combined over the axis give the plain version's output."""
    from repro_torch.distributed.annotate import use_rules
    from repro_torch.distributed.sharding import rules_for_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L

    mesh = make_host_mesh()
    rules = rules_for_mesh(mesh, {"seq": "model", "kv_heads": None, "heads": None})
    B, S, H, KV, hd = 4, 512, 16, 16, 128
    q, k, v = inputs(card, B, S, H, KV, hd, torch.bfloat16, seed=3)
    valid, n_live = full_cache(card, np.array([1, 100, 511, 600]), S)
    launches = dk.decode_attention.launches
    with use_rules(mesh, rules):
        got = L.decode_attention(q, k, v, valid, n_live=n_live)
    assert dk.decode_attention.launches == launches + 1
    want = dk.decode_attention_plain(q, k, v, valid, n_live)
    assert got.dtype == want.dtype and got.shape == want.shape
    slack = rounding_step(want.float(), torch.bfloat16) * 2
    assert bool(((got.float() - want.float()).abs() <= slack).all())
