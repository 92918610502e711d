"""The latent decode kernel on the card (marked ``card``: each test skips
where no CUDA card is present).  Run them on the card with
``python -m pytest -q -m card tests/test_torch_mla_decode_card.py``.

Each holds the kernel (csrc/mla_decode.cu) against its plain version
(``mla_decode_plain``) on the same card and the same stored values, the
plain version computed in f32 from them.  In f32 (the CUDA-core split
kernel) both compute scores, softmax and P.C in f32 and differ only in the
order of their sums, so they agree to F32_TOL.  In bf16 (the tensor-core
kernel) the scores are f32 sums of exact bf16 products in another order,
and p enters P.C as two bf16 terms (about 2^-17 of p), so the f32 results
agree to BF16_F32_TOL; the kernel's output in bf16 is that value rounded
once, give or take one rounding step (a value on a rounding boundary may
go either way)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import mla_decode as mk

#: f32 against f32: sums of up to a few hundred terms of order 1 in
#: another order (f32's 6e-8 a step)
F32_TOL = dict(rtol=2e-5, atol=2e-6)
#: the bf16 kernel's f32 value against the plain version's: p carried to
#: 2^-17 of itself over ~18k slots, sums in another order
BF16_F32_TOL = dict(rtol=1e-3, atol=2e-5)
#: the cell's scale: 192 ** -0.5 x m(0.707) ** 2
SCALE = 0.114721

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the latent decode kernel has no CPU form")
    return torch.device("cuda", 0)


def longctx_lengths(rng, B: int) -> np.ndarray:
    """Live slots of B decoding rows as the longctx mix draws them: a
    prompt uniform over 8192-16384 and part of an output of 64-2048."""
    prompt, out = rng.integers(8192, 16385, B), rng.integers(64, 2049, B)
    return prompt + (rng.uniform(0, 1, B) * out).astype(np.int64) + 1


def inputs(dev, B, S, dtype, seed=0):
    """The absorbed query (about the size q_nope W_UK has in the model),
    and c_kv and k_pe as views of one latent [B, S, 576] (the kernel reads
    them in place, rows of 1152 bytes)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((B, 16, 576), generator=g, device=dev) * 0.5).to(dtype)
    lat = torch.randn((B, S, 576), generator=g, device=dev).to(dtype)
    return q, lat[..., :512], lat[..., 512:]


def rounding_step(want: torch.Tensor) -> torch.Tensor:
    return 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_plain_at_the_cells_shape(card, seed):
    """q [32, 16, 576] against a latent [32, 18432, 576] in bf16, live
    slots drawn as the longctx mix draws them."""
    B, S = 32, 18432
    q, c, kpe = inputs(card, B, S, torch.bfloat16, seed)
    lengths = longctx_lengths(np.random.default_rng(seed), B)
    n = torch.as_tensor(np.minimum(lengths, S), dtype=torch.int32, device=card)
    launches = mk.mla_decode.launches
    got = mk.mla_decode(q, c, kpe, n, scale=SCALE)
    torch.cuda.synchronize()
    assert mk.mla_decode.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == (B, 16, 512)
    want = mk.mla_decode_plain(q.float(), c.float(), kpe.float(), n, scale=SCALE)
    slack = (rounding_step(want) + BF16_F32_TOL["atol"]
             + BF16_F32_TOL["rtol"] * want.abs())
    err = (got.float() - want).abs()
    assert bool((err <= slack).all()), float((err - slack).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_a_small_shape(card, dtype):
    """B 5, S 300: rows with no live slot, one, a ragged tile, a whole
    split and every slot; f32 takes the CUDA-core kernel."""
    B, S = 5, 300
    q, c, kpe = inputs(card, B, S, dtype, seed=3)
    n = torch.tensor([0, 1, 77, 256, 300], dtype=torch.int32, device=card)
    got = mk.mla_decode(q, c, kpe, n, scale=SCALE)
    want = mk.mla_decode_plain(q.float(), c.float(), kpe.float(), n, scale=SCALE)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **F32_TOL)
    else:
        slack = rounding_step(want) + BF16_F32_TOL["atol"] + BF16_F32_TOL["rtol"] * want.abs()
        assert bool(((got.float() - want).abs() <= slack).all())
    # the row with no live slot: the mean of c_kv over all S slots
    torch.testing.assert_close(want[0], c[0].float().mean(0).expand(16, -1), rtol=1e-5,
                               atol=1e-6)


def test_served_run_launches_once_a_layer_a_step(card):
    """A short served run at DeepSeek-V2-Lite's widths and depth (27 layers
    of latent attention; the experts and the vocabulary cut, which the
    kernel does not see): the kernel runs once a layer in every decode
    step, and a decode step never waits for the card."""
    from repro_torch.configs import get_config
    from repro_torch.core import make_device
    from repro_torch.models.api import build_model
    from repro_torch.serving.pipeline import Request, VhostStyleServer

    full = get_config("deepseek-v2-lite")
    cfg = dataclasses.replace(full, vocab_size=1024, moe=dataclasses.replace(
        full.moe, num_experts=8, d_ff_expert=64, d_ff_dense=256, capacity_factor=11.0))
    model = build_model(cfg, remat=False, attn_impl="flash", device=card)
    params = model.init(torch.Generator(device=card).manual_seed(0))

    class Steps:  # counts the decode steps the server ran
        n = 0

        def gauge(self, name, value):
            self.n += name == "serving.stage.decode_launch_us"

    steps = Steps()
    server = VhostStyleServer(model, params, slots=4, max_cache_len=512,
                              device=make_device(device=card), observer=steps)
    rng = np.random.default_rng(0)
    for i, (p, m) in enumerate([(300, 12), (77, 20), (200, 5)]):
        server.enqueue(Request(req_id=i, prompt=rng.integers(0, 1024, p).astype(np.int32),
                               max_new_tokens=m))
    launches = mk.mla_decode.launches
    server.run_until_drained()
    assert steps.n >= 19  # the longest request's 19 decoded tokens at least
    assert mk.mla_decode.launches - launches == 27 * steps.n
    # a decode step with the card's sync checks on
    cache = model.init_cache(2, 64)
    toks = torch.zeros((2, 1), dtype=torch.int32, device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_step(params, cache, toks)
    finally:
        torch.cuda.set_sync_debug_mode("default")
