"""The configurations' FLOP and byte formulas against counts by hand."""
import pytest

from bench.harness import core
from bench.reference import layers as R


def _ref(name):
    cfg = core.load_json(core.BENCH / "configs" / f"{name}.json")
    mod = core.load_module(core.BENCH / "reference" / f"{cfg['reference']}.py",
                           f"bench_reference_{cfg['reference']}")
    return cfg["model"], mod


@pytest.mark.parametrize("s0,s1,window,n_meta", [
    (0, 1, 0, 0), (0, 37, 0, 0), (5, 20, 0, 0), (0, 40, 8, 0), (0, 40, 8, 3), (10, 50, 16, 4)])
def test_visible_pairs_by_brute_force(s0, s1, window, n_meta):
    want = sum(1 for q in range(s0, s1) for k in range(q + 1)
               if window <= 0 or q - k < window or k < n_meta)
    assert R.visible_pairs(s0, s1, window, n_meta) == want


def test_deepseek_moe_16b_by_hand():
    cfg, ref = _ref("deepseek-moe-16b")
    attn = 2 * 2048 * (16 + 32) * 128 + 2 * 2048 * 2048  # q, k, v and o projections
    dense = attn + 3 * 2 * 2048 * 10944
    moe = attn + 2 * 2048 * 64 + 3 * 2 * 2048 * 1408 * (6 + 2)
    assert ref.matmul_flops_per_token(cfg, 0) == dense
    assert ref.matmul_flops_per_token(cfg, 1) == ref.matmul_flops_per_token(cfg, 27) == moe
    per_token = dense + 27 * moe
    assert ref.decode_flops(cfg, 99) == (per_token + 4 * 16 * 128 * 100 * 28
                                         + 2 * 2048 * 102400)
    assert ref.prefill_flops(cfg, 1000) == (1000 * per_token + 4 * 16 * 128 * 500500 * 28
                                            + 2 * 2048 * 102400)
    # about 2 x 2.8 G active parameters a token
    assert 5.0e9 < per_token + 2 * 2048 * 102400 < 6.5e9
    flops, nbytes = ref.attention_call(cfg, 2048)
    assert flops == 4 * 16 * 128 * 2048 * 2049 // 2
    assert nbytes == 2 * 2048 * 128 * (2 * 16 + 2 * 16)
    assert ref.attention_layers(cfg) == 28


def test_hymba_1_5b_by_hand():
    cfg, ref = _ref("hymba-1.5b")
    D, di, H = 1600, 3200, 50
    attn = 2 * D * (25 + 10) * 64 + 2 * 25 * 64 * D
    ssm = 2 * D * (2 * di + 32 + H) + 2 * di * D + 2 * 4 * (di + 32) + 4 * H * 64 * 16
    mlp = 6 * D * 5504
    assert ref.matmul_flops_per_token(cfg) == attn + ssm + mlp
    total = 2048 + 128
    local = sum(min(q + 1, 1024) + max(0, min(128, q + 1 - 1024)) for q in range(total))
    glob = total * (total + 1) // 2
    pairs = 29 * local + 3 * glob
    fwd = 2 * (total * 32 * (attn + ssm + mlp) + 4 * 25 * 64 * pairs) + 2 * D * 32001 * 4096
    assert ref.forward_flops(cfg, 2, 2048, 4096) == fwd
    assert ref.train_step_flops(cfg, 2, 2048) == 3 * fwd
    # about 6 x 1.6 G parameters x 4096 tokens
    assert 3.5e13 < 3 * fwd < 5.5e13
