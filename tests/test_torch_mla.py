"""DeepSeek-V2-Lite's latent attention in the port against the benchmark's
plain reference (``bench/reference/deepseek_v2_lite.py``: float32, the
expanded form), at ``reduced()`` size on the CPU in float32: prefill
logits, a prefill and decode steps through the latent cache (the absorbed
form) past YaRN's original length, the absorbed decode against the
expanded one, YaRN's ramp and the softmax scale at the published sizes,
the router's ``norm_topk_prob`` switch, the kernel's plain version, the
latent cache's splice, the server's count of live slots, and chip_smoke.py's
latent-decode check (its lengths from the longctx mix, its tolerance).

Tolerances: program and reference compute the same float32 function in
other orders and groupings (the absorbed form multiplies W_UK into q
rather than into the cache; the chunked and flash forms pad head dims with
zeros; the reference's einsums reduce in other orders), so logits of order
1 agree to 1e-4, as ``bench/test_bench_reference.py`` holds the other
configurations; the kernel's plain version against its own function
written another way to 1e-5 (sums of up to 64 terms of order 1)."""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import mla_decode as mk
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.api import build_model

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the benchmark's package, for its reference and weights
    sys.path.insert(0, str(ROOT))

from bench.harness import core, weights  # noqa: E402
from bench.harness.model import as_dict  # noqa: E402
from bench.reference import layers as R  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _ref():
    return core.load_module(core.BENCH / "reference" / "deepseek_v2_lite.py",
                            "bench_reference_deepseek_v2_lite")


def _cfg():
    """reduced() in float32, dropless, YaRN's original length 64 (so a
    test of 100 positions runs past it)."""
    c = get_config("deepseek-v2-lite").reduced()
    return dataclasses.replace(
        c, dtype="float32", moe=dataclasses.replace(c.moe, capacity_factor=11.0),
        rope_scaling=dataclasses.replace(c.rope_scaling, factor=4.0,
                                         original_max_position_embeddings=64))


def _setup(cfg, impl="flash", seed=3):
    layout = weights.Layout(cfg, build_model)
    model = build_model(cfg, remat=False, attn_impl=impl, device="cpu")
    return model, layout.program_params(seed, "cpu"), weights.Weights(layout, seed, "cpu")


def _tokens(cfg, n, seed=1):
    return torch.randint(0, cfg.vocab_size, (1, n), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("impl", ["flash", "chunked"])
def test_prefill_logits_against_the_reference(impl):
    cfg = _cfg()
    model, params, W = _setup(cfg, impl)
    toks = _tokens(cfg, 40)
    _, last, _ = model.prefill(params, {"tokens": toks}, 48)
    want = _ref().logits(as_dict(cfg), W, [toks[0]], [39])[0]
    torch.testing.assert_close(last, want, **LOGIT_TOL)


def test_prefill_then_decode_past_yarns_original_length():
    """80 prompt tokens, then 20 decode steps through the latent cache to
    position 99, past the original 64 positions: every step's logits
    against the reference's full forward pass."""
    cfg = _cfg()
    model, params, W = _setup(cfg)
    toks = _tokens(cfg, 101)
    cache, last, _ = model.prefill(params, {"tokens": toks[:, :80]}, 112)
    got = [last[0]]
    for i in range(80, 100):
        lg, cache = model.decode_step(params, cache, toks[:, i:i + 1])
        got.append(lg[0])
    want = _ref().logits(as_dict(cfg), W, [toks[0, :100]], [79])[0]
    torch.testing.assert_close(torch.stack(got), want, **LOGIT_TOL)
    assert int(cache["lengths"][0]) == 100


def test_absorbed_decode_equals_the_expanded_form():
    """The decode step's absorbed attention against the latent cache, and
    a prefill of the same tokens (the expanded form over k and v made from
    the latent), give the same logits."""
    cfg = _cfg()
    model, params, _ = _setup(cfg)
    toks = _tokens(cfg, 30, seed=4)
    cache, _, _ = model.prefill(params, {"tokens": toks[:, :21]}, 32)
    for i in range(21, 30):
        lg, cache = model.decode_step(params, cache, toks[:, i:i + 1])
        _, want, _ = model.prefill(params, {"tokens": toks[:, :i + 1]}, 32)
        torch.testing.assert_close(lg, want, rtol=1e-5, atol=1e-5)


def test_yarn_at_the_published_sizes():
    """DeepSeek-V2-Lite's rope: 64 dims, theta 10000, factor 40 over 4096
    positions, beta 32 / 1, mscale 0.707 / 0.707."""
    cfg = get_config("deepseek-v2-lite")
    sc = cfg.rope_scaling
    assert L.yarn_range(64, 10000.0, sc) == (10, 23)  # floor(10.47), ceil(22.51)
    extra = 1.0 / 10000.0 ** (torch.arange(32, dtype=torch.float32) / 32)
    inv = L.yarn_inv_freq(extra, 64, 10000.0, sc)
    r = ((torch.arange(32, dtype=torch.float32) - 10) / 13).clamp(0, 1)
    torch.testing.assert_close(inv, extra / 40 * r + extra * (1 - r), rtol=1e-6, atol=0)
    assert torch.equal(inv[:11], extra[:11]) and torch.allclose(inv[23:], extra[23:] / 40)
    m = 0.1 * 0.707 * torch.log(torch.tensor(40.0, dtype=torch.float64)).item() + 1
    assert abs(m - 1.26080) < 1e-5
    assert abs(L.mla_softmax_scale(cfg) - 0.114721) < 1e-6
    assert L.mla_softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    # mscale / mscale_all_dim = 1: the tables are plain cos and sin
    pos = torch.arange(5000)
    cos, sin = L.rope_cos_sin(pos, 64, 10000.0, scaling=sc)
    torch.testing.assert_close(cos, torch.cos(pos.float()[:, None] * inv), rtol=0, atol=2e-3)
    cos2, _ = L.rope_cos_sin(pos, 64, 10000.0,
                             scaling=dataclasses.replace(sc, mscale=1.0, mscale_all_dim=0.0))
    assert torch.allclose(cos2, cos * L.yarn_mscale(40.0, 1.0))


def test_rope_without_scaling_is_unchanged():
    pos = torch.arange(100)
    half = torch.arange(0, 32, dtype=torch.float32) / 32
    ang = pos.float()[:, None] * (1.0 / 10000.0 ** half)
    cos, sin = L.rope_cos_sin(pos, 64, 10000.0)
    assert torch.equal(cos, torch.cos(ang)) and torch.equal(sin, torch.sin(ang))


def _moe_inputs(cfg, seed=2):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(37, cfg.d_model, generator=g)
    p = moe_lib.init_moe_params(g, cfg.moe, cfg.d_model, torch.float32)
    return x, p


def test_router_switch_off_against_the_reference():
    """norm_topk_prob False: the top-k weights are the softmax's, and the
    block equals the reference's ``moe``."""
    cfg = _cfg()
    assert cfg.moe.norm_topk_prob is False
    x, p = _moe_inputs(cfg)
    w, idx, _ = moe_lib.router_topk(x, p["router"], cfg.moe)
    probs = torch.softmax(x @ p["router"], dim=-1)
    torch.testing.assert_close(w, probs.gather(1, idx), rtol=1e-6, atol=0)
    assert bool((w.sum(-1) < 1).all())
    y, _ = moe_lib.moe_block(x[None], p, cfg.moe, cfg.act)
    want = _ref().moe(x, p, dataclasses.asdict(cfg.moe), cfg.act)
    torch.testing.assert_close(y[0], want, rtol=1e-5, atol=1e-5)


def test_deepseek_moe_routing_unchanged():
    """deepseek-moe-16b keeps the switch on: renormalised weights, and its
    block equals the reference it was held to before (``layers.moe``)."""
    cfg = get_config("deepseek-moe-16b").reduced()
    assert cfg.moe.norm_topk_prob is True
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=11.0))
    x, p = _moe_inputs(cfg)
    w, idx, _ = moe_lib.router_topk(x, p["router"], cfg.moe)
    probs = torch.softmax(x @ p["router"], dim=-1).gather(1, idx)
    torch.testing.assert_close(w, probs / probs.sum(-1, keepdim=True), rtol=1e-6, atol=0)
    y, _ = moe_lib.moe_block(x[None], p, cfg.moe, cfg.act)
    torch.testing.assert_close(y[0], R.moe(x, p, dataclasses.asdict(cfg.moe), cfg.act),
                               rtol=1e-5, atol=1e-5)


def _latent(B=3, S=40, H=4, r=32, dr=16, seed=6):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, H, r + dr, generator=g), torch.randn(B, S, r, generator=g),
            torch.randn(B, S, dr, generator=g))


def test_kernel_plain_version_against_the_einsum_form():
    """``mla_decode_plain`` against the function written over the
    concatenated key [c_kv | k_pe], row by row, and against the expanded
    decode: o_lat W_UV equals attention over k = [c_kv W_UK | k_pe] and
    v = c_kv W_UV."""
    q, c, kpe = _latent()
    n_live = torch.tensor([40, 1, 23], dtype=torch.int32)
    got = mk.mla_decode_plain(q, c, kpe, n_live, scale=0.3)
    lat = torch.cat([c, kpe], dim=-1)
    for b in range(3):
        n = int(n_live[b])
        p = torch.softmax(torch.einsum("hc,sc->hs", q[b], lat[b, :n]) * 0.3, dim=-1)
        torch.testing.assert_close(got[b], p @ c[b, :n], rtol=1e-5, atol=1e-5)
    # the expanded form: per-head keys and values from the latent
    H, r, dn, dv = 4, 32, 8, 8
    g = torch.Generator().manual_seed(7)
    w_uk, w_uv = torch.randn(r, H, dn, generator=g), torch.randn(r, H, dv, generator=g)
    q_nope, q_pe = torch.randn(3, H, dn, generator=g), torch.randn(3, H, 16, generator=g)
    q_abs = torch.cat([torch.einsum("bhd,rhd->bhr", q_nope, w_uk), q_pe], dim=-1)
    o = torch.einsum("bhr,rhd->bhd", mk.mla_decode_plain(q_abs, c, kpe, n_live, scale=0.3), w_uv)
    k = torch.cat([torch.einsum("bsr,rhd->bshd", c, w_uk),
                   kpe[:, :, None].expand(3, 40, H, 16)], dim=-1)
    v = torch.einsum("bsr,rhd->bshd", c, w_uv)
    from repro_torch.kernels import decode_attention as dk

    valid = mk.live_mask(n_live, 40)
    # v padded with zero dims to the keys' width, as the plain version takes one
    want = dk.decode_attention_plain(torch.cat([q_nope, q_pe], -1), k,
                                     torch.nn.functional.pad(v, (0, 16)), valid, n_live,
                                     scale=0.3)[..., :dv]
    torch.testing.assert_close(o, want, rtol=1e-4, atol=1e-4)


def test_kernel_wrapper_refusals_and_empty_rows():
    q, c, kpe = _latent()
    n = torch.tensor([5, 0, 40], dtype=torch.int32)
    out = mk.mla_decode(q, c, kpe, n, scale=0.5)
    # a row with no live slot: the mean of the latent over all S slots
    torch.testing.assert_close(out[1], c[1].mean(0).expand(4, -1), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="int32"):
        mk.mla_decode(q, c, kpe, n.long(), scale=0.5)
    with pytest.raises(ValueError, match="do not fit"):
        mk.mla_decode(q[..., :-1], c, kpe, n, scale=0.5)
    with pytest.raises(TypeError, match="types differ"):
        mk.mla_decode(q.bfloat16(), c, kpe, n, scale=0.5)
    launches = mk.mla_decode.launches
    mk.mla_decode(q, c, kpe, n, scale=0.5)
    assert mk.mla_decode.launches == launches  # the CPU runs the plain version


def test_latent_cache_splices_into_its_slot():
    """``_splice_cache`` writes a batch-1 prefill's latent leaves into the
    batch cache's row, every layer, nothing else."""
    from repro_torch.serving.pipeline import _splice_cache

    cfg = _cfg()
    model, params, _ = _setup(cfg)
    batch = model.init_cache(4, 24)
    before = {k: v.clone() for k, v in batch["segments"][1].items()}
    one, _, _ = model.prefill(params, {"tokens": _tokens(cfg, 9)}, 24)
    _splice_cache(batch, one, 2)
    for seg_b, seg_1 in zip(batch["segments"], one["segments"]):
        pairs = (zip(seg_b, seg_1) if isinstance(seg_b, list) else [(seg_b, seg_1)])
        for lb, l1 in pairs:
            axis = 0 if isinstance(seg_b, list) else 1
            assert set(lb) == {"c_kv", "k_pe"}
            for k in lb:
                assert torch.equal(lb[k].select(axis, 2), l1[k].select(axis, 0))
    for k, t in batch["segments"][1].items():
        rest = [i for i in range(4) if i != 2]
        assert torch.equal(t[:, rest], before[k][:, rest])
    assert int(batch["lengths"][2]) == 9


def test_server_counts_live_slots_on_the_host():
    """The served model, and the server's gauge of the slots each decode
    step's attention reads: every row's length + 1 as the card holds it
    (idle rows too), with no read of the card's lengths."""
    from repro_torch.core import make_device
    from repro_torch.serving.pipeline import Request, VhostStyleServer

    class Gauges:
        def __init__(self):
            self.v = {}

        def gauge(self, name, value):
            self.v.setdefault(name, []).append(value)

    cfg = _cfg()
    model, params, _ = _setup(cfg)
    obs = Gauges()
    server = VhostStyleServer(model, params, slots=3, max_cache_len=40,
                              device=make_device(device="cpu"), observer=obs)
    reqs = [Request(req_id=i, prompt=_tokens(cfg, n, seed=i)[0].numpy(), max_new_tokens=m)
            for i, (n, m) in enumerate([(11, 5), (7, 3)])]
    for r in reqs:
        server.enqueue(r)
    server.run_until_drained()
    assert [len(r.output) for r in reqs] == [5, 3]
    live = obs.v["serving.decode.live_slots"]
    assert len(live) == len(obs.v["serving.stage.decode_launch_us"]) > 0
    lengths = server.cache["lengths"].long()
    assert torch.equal(lengths, torch.as_tensor(server._lengths))
    # the last step read each row's slots [0, length before it]
    assert live[-1] == float(lengths.sum())


@pytest.mark.parametrize("shape", [("decode_32k", 64, 2, "decode"),
                                   ("prefill_32k", 48, 2, "prefill")])
def test_dry_run_on_the_host_mesh(shape):
    """The dry run's counted step under a rules context (the latent cache
    laid out by batch, the decode's write and attention in one shard_map on
    each rank's rows) on the one-rank host mesh; a decode step writes the
    cache in place."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    cfg = get_config("deepseek-v2-lite").reduced()
    rec = dryrun.dryrun_cell("deepseek-v2-lite", shape[0], False,
                             mesh=make_host_mesh(device="cpu"), cfg=cfg,
                             shape=ShapeConfig(*shape))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["flops_per_dev"] > 0
    assert (rec["memory"]["alias_bytes"] > 0) == (shape[3] == "decode")


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smokes_latent_lengths_are_the_longctx_mix():
    """chip_smoke.py's phases 2g and 5f draw each row's live slots as the
    cell's mix draws its requests: a prompt within the mix's range plus
    part of an output within its range, plus the token fed."""
    import json

    import numpy as np

    cs = _chip_smoke()
    mix = json.loads((ROOT / "bench" / "traffic" / "longctx.json").read_text())
    p, o = mix["prompt_tokens"], mix["output_tokens"]
    n = cs.mla_lengths(np.random.default_rng(5), 4096)
    assert n.min() >= p["min"] + 1 and n.max() <= p["max"] + o["max"] + 1
    assert n.max() > p["max"]  # some rows are well into their answers
    assert cs.MLA_SHAPE == (mix["clients"], mix["max_cache_len"])
    assert cs.MLA_SCALE == pytest.approx(L.mla_softmax_scale(get_config("deepseek-v2-lite")),
                                         abs=1e-6)


def test_chip_smokes_latent_check_on_the_cpu(monkeypatch):
    """Phase 2g's check run on the CPU (where the kernel is its plain
    version) at a cut shape: it passes, and its tolerance refuses an
    output one per cent off."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "MLA_SHAPE", (2, 16500))
    errs = {}
    cs.kernels_vs_plain_6(torch.device("cpu"), torch.Generator().manual_seed(0), errs)
    assert 0 <= errs["mla_decode"] < 1e-2
    want = torch.randn(2, 16, 512, generator=torch.Generator().manual_seed(1))
    for dtype in (torch.float32, torch.bfloat16):
        assert cs.mla_close(want.to(dtype), want)
        assert not cs.mla_close((want * 1.01).to(dtype), want)
