"""DeepSeek-V2-Lite's plain reference (``bench/reference/deepseek_v2_lite.py``)
and its formulas: YaRN and the softmax scale at the published sizes, the
configuration file against the program's configuration, the reference's
pieces against the shared reference layers they stand beside, the
expanded attention's blocks, the FLOP and byte counts by hand, and the
cell run at the small size with the float8 control judged by its own
check."""
import dataclasses
import math

import torch

from bench.harness import core, serve, small, weights
from bench.harness.model import model_config
from bench.reference import layers as R

FILE = core.load_json(core.BENCH / "configs" / "deepseek-v2-lite.json")
CFG = FILE["model"]


def _ref():
    return core.load_module(core.BENCH / "reference" / "deepseek_v2_lite.py",
                            "bench_reference_deepseek_v2_lite")


def test_yarn_and_scale_at_the_published_sizes():
    ref, sc = _ref(), CFG["rope_scaling"]
    assert ref.yarn_range(64, 10000.0, sc) == (10, 23)
    inv = ref.yarn_inv_freq(64, 10000.0, sc)
    i = torch.arange(32, dtype=torch.float64)
    extra = 10000.0 ** (-2 * i / 64)
    r = ((i - 10) / 13).clamp(0, 1)
    assert torch.allclose(inv, extra / 40 * r + extra * (1 - r), rtol=1e-15, atol=0)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert abs(m - 1.26080) < 1e-5 and ref.yarn_mscale(40, 0.707) == m
    assert abs(ref.softmax_scale(CFG) - 0.114721) < 1e-6


def test_the_file_is_the_published_config_and_the_programs():
    """Every published size the file carries is the model section's, and
    the model section is the program's configuration (capacity factor
    apart, which ``assumed`` names): nothing is cut."""
    from repro_torch.configs import get_config

    assert FILE["reduced"] == [] and "capacity_factor" in FILE["assumed"]
    m = CFG
    pairs = {"num_hidden_layers": m["num_layers"], "hidden_size": m["d_model"],
             "num_attention_heads": m["num_heads"], "num_key_value_heads": m["num_kv_heads"],
             "vocab_size": m["vocab_size"], "intermediate_size": m["moe"]["d_ff_dense"],
             "moe_intermediate_size": m["moe"]["d_ff_expert"],
             "n_routed_experts": m["moe"]["num_experts"],
             "num_experts_per_tok": m["moe"]["top_k"],
             "n_shared_experts": m["moe"]["num_shared_experts"],
             "first_k_dense_replace": m["moe"]["first_moe_layer"],
             "norm_topk_prob": m["moe"]["norm_topk_prob"],
             "kv_lora_rank": m["mla"]["kv_lora_rank"],
             "qk_nope_head_dim": m["mla"]["qk_nope_head_dim"],
             "qk_rope_head_dim": m["mla"]["qk_rope_head_dim"],
             "v_head_dim": m["mla"]["v_head_dim"], "rms_norm_eps": m["norm_eps"],
             "rope_theta": m["rope_theta"], "tie_word_embeddings": m["tie_embeddings"]}
    for key, v in pairs.items():
        assert FILE[key] == v, key
    for key, v in FILE["rope_scaling"].items():
        if key != "type":
            assert m["rope_scaling"][key] == v, key
    program = get_config("deepseek-v2-lite")
    assert model_config(CFG) == dataclasses.replace(
        program, moe=dataclasses.replace(program.moe, capacity_factor=11.0))
    assert 15.6e9 < program.num_params() < 15.8e9


def test_reference_pieces_against_the_shared_layers():
    """With no rope scaling its rope is ``layers.rope``; with the switch on
    its ``moe`` is ``layers.moe``; its blocked attention, with v as wide as
    q, is ``layers.attention`` (and blocks of 5 rows give the same)."""
    ref = _ref()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 23, 3, 16, generator=g)
    pos = torch.arange(23)
    cfg = dict(rope_theta=10000.0, rope_scaling=None)
    assert torch.allclose(ref.rope(x, pos, cfg), R.rope(x, pos, 10000.0), atol=1e-6)
    mcfg = dict(num_experts=4, top_k=2, capacity_factor=11.0, num_shared_experts=1,
                norm_topk_prob=True)
    p = {"router": torch.randn(16, 4, generator=g), "w1": torch.randn(4, 16, 8, generator=g),
         "w3": torch.randn(4, 16, 8, generator=g), "w2": torch.randn(4, 8, 16, generator=g),
         "shared_w1": torch.randn(16, 8, generator=g),
         "shared_w3": torch.randn(16, 8, generator=g),
         "shared_w2": torch.randn(8, 16, generator=g)}
    xt = torch.randn(9, 16, generator=g)
    assert torch.allclose(ref.moe(xt, p, mcfg), R.moe(xt, p, mcfg), atol=1e-5)
    q, k, v = (torch.randn(1, 23, 3, 16, generator=g) for _ in range(3))
    want = R.attention(q, k, v)
    assert torch.allclose(ref.attention(q, k, v, 16 ** -0.5), want, atol=1e-6)
    assert torch.allclose(ref.attention(q, k, v, 16 ** -0.5, block=5), want, atol=1e-6)


def test_flops_and_bytes_by_hand():
    ref = _ref()
    D, H, V = 2048, 16, 102400
    attn_exp = (2 * D * H * 192 + 2 * D * 576 + 2 * 512 * H * 256 + 2 * H * 128 * D)
    attn_abs = (2 * D * H * 192 + 2 * D * 576 + 2 * H * 512 * 256 + 2 * H * 128 * D)
    dense = 3 * 2 * D * 10944
    moe = 2 * D * 64 + 3 * 2 * D * 1408 * (6 + 2)
    assert ref.matmul_flops_per_token(CFG, 0) == attn_exp + dense
    assert ref.matmul_flops_per_token(CFG, 5) == attn_exp + moe
    assert ref.matmul_flops_per_token(CFG, 26, absorbed=True) == attn_abs + moe
    per_exp = attn_exp + dense + 26 * (attn_exp + moe)
    per_abs = attn_abs + dense + 26 * (attn_abs + moe)
    assert ref.prefill_flops(CFG, 1000) == (1000 * per_exp + 2 * H * 320 * 500500 * 27
                                            + 2 * D * V)
    assert ref.decode_flops(CFG, 99) == per_abs + 2 * H * 1088 * 100 * 27 + 2 * D * V
    # about 2 x 2.4-2.7 G active parameters a token
    assert 4.5e9 < per_exp + 2 * D * V < 6.0e9
    flops, nbytes = ref.mla_decode_call(CFG, 32, 400000)
    assert flops == 2 * 16 * (512 + 64 + 512) * 400000
    assert nbytes == 2 * (400000 * 576 + 32 * 16 * 576 + 32 * 16 * 512)
    assert 25 < flops / (400000 * 1152) < 35  # about 30 FLOPs a byte of latent


def test_small_cell_and_its_control():
    """The cell at the small size on the CPU: correct, with the server's
    count of live slots; the float8 control's first choices are not all
    the reference's."""
    from repro_torch.models.api import build_model

    cell = small.small_cell("dsv2lite.longctx", dtype="float32")
    # a window long enough that requests finish on a CPU shared with other tests
    run = small.small_run(cell, seed=2**31 + 11, seconds=4.0)
    assert run.records["checked_tokens"] > 0 and run.correct, run.checks
    assert run.gauges.get("serving.decode.live_slots")
    cfg = cell.config["model"]
    layout = weights.Layout(model_config(cfg), build_model)
    W = weights.Weights(layout, 5, torch.device("cpu"))
    toks = torch.randint(0, cfg["vocab_size"], (60,), generator=torch.Generator().manual_seed(5))
    sample = [{"prompt": toks[:20].numpy(), "output": toks[20:].tolist()}]
    gap = serve.logit_gap(cell.reference(), cfg, W, sample, R.Precision("fp8"))
    assert gap["tokens"] == 40
    assert gap["control"]["mean_logit_gap"] > 0.0 and gap["control"]["off_top_share"] > 0.0
