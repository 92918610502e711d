"""The plain references against repro_torch at ``reduced()`` size on the
CPU, in float32: a prefill and then decode steps through the cache
against the reference's full forward pass, for both configurations; and
hymba's training loss, gradients and AdamW steps."""
import dataclasses

import pytest
import torch

from bench.harness import core, weights
from bench.harness.model import as_dict, model_config

CONFIGS = ["deepseek-moe-16b", "hymba-1.5b"]


def _setup(name, seed=5):
    from repro_torch.models.api import build_model

    file = core.load_json(core.BENCH / "configs" / f"{name}.json")
    mc = dataclasses.replace(model_config(file["model"]).reduced(), dtype="float32")
    ref = core.load_module(core.BENCH / "reference" / f"{file['reference']}.py",
                           f"bench_reference_{file['reference']}")
    layout = weights.Layout(mc, build_model)
    model = build_model(mc, remat=True, attn_impl="flash", device="cpu")
    W = weights.Weights(layout, seed, torch.device("cpu"))
    return mc, as_dict(mc), ref, layout, model, layout.program_params(seed, "cpu"), W


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_then_decode_against_full_forward(name):
    mc, cfg, ref, _, model, params, W = _setup(name)
    toks = torch.randint(0, mc.vocab_size, (1, 41), generator=torch.Generator().manual_seed(1))
    cache, last, _ = model.prefill(params, {"tokens": toks[:, :30]}, 64)
    got = [last[0]]
    for i in range(30, 41):  # past hymba's window of 16
        lg, cache = model.decode_step(params, cache, toks[:, i:i + 1])
        got.append(lg[0])
    want = ref.logits(cfg, W, [toks[0, :-1]], [29])[0]
    torch.testing.assert_close(torch.stack(got)[:want.shape[0]], want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_drawn_again_equal_the_programs(name):
    _, _, _, layout, _, params, W = _setup(name, seed=2**35 + 1)
    views = layout.views(params)
    for (path, layer), t in views.items():
        again = W.top(path) if layer is None else layout.leaf(W.seed, path, layer, "cpu")
        assert torch.equal(t.float(), again), (path, layer)
    assert not torch.equal(views[("embed", None)], layout.program_params(3, "cpu")["embed"])


def test_hymba_loss_and_gradients():
    from repro_torch import tree as ttree

    mc, cfg, ref, layout, model, params, W = _setup("hymba-1.5b")
    toks = torch.randint(0, mc.vocab_size, (2, 24), generator=torch.Generator().manual_seed(3))
    leaves, treedef = ttree.flatten(params)
    leaves = [p.requires_grad_(True) for p in leaves]
    loss, _ = model.loss(ttree.unflatten(treedef, leaves), {"tokens": toks})
    loss.backward()
    P = {k: v.requires_grad_(True) for k, v in W.leaves().items()}
    want = ref.loss(cfg, P, toks)
    want.backward()
    torch.testing.assert_close(loss.detach(), want.detach(), rtol=1e-5, atol=1e-5)
    grads = layout.views(ttree.unflatten(treedef, [p.grad for p in leaves]))
    for k, p in P.items():
        torch.testing.assert_close(grads[k], p.grad, rtol=1e-3, atol=1e-5, msg=str(k))


def test_hymba_adamw_steps():
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamW

    mc, cfg, ref, layout, model, params, W = _setup("hymba-1.5b")
    o = core.load_json(core.BENCH / "traffic" / "train.json")["optimizer"]
    opt = AdamW(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"])
    step = make_train_step(model, opt, clip_norm=o["clip_norm"])
    gen = torch.Generator().manual_seed(4)
    batches = [torch.randint(0, mc.vocab_size, (2, 16), generator=gen) for _ in range(2)]
    state, losses = opt.init(params), []
    for b in batches:
        params, state, m = step(params, state, {"tokens": b})
        losses.append(float(m["loss"]))
    got = ref.train(cfg, W, batches, o)
    assert losses == pytest.approx(got["losses"], rel=1e-5)
    for k, p in layout.views(params).items():
        start = layout.leaf(W.seed, k[0], k[1], "cpu")
        assert float((p - start).norm()) == pytest.approx(got["change_norms"][k], rel=1e-3,
                                                          abs=1e-6), k
