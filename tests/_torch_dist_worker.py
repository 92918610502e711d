"""The port's side of ``test_torch_distributed.py``: one function per check,
run on every rank of a gloo process group on the CPU (``run`` is what
``torch.multiprocessing`` starts).  Inputs come from ``inputs.npz`` in the
work directory; rank 0 writes its outputs to ``port_<check>.npz``.  Not a
test file itself; it imports torch and repro_torch only."""
import contextlib
import dataclasses
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.annotate import full


def _np(x):
    return full(x).detach().float().numpy()


def _mesh(shape, names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=names)


# --------------------------------------------------------------------------- collectives
def collectives(inp, rank):
    from repro_torch.distributed.collectives import compressed_psum_tree, ring_all_reduce

    mesh = _mesh((4,), ("data",))
    out = {}
    # each rank its own value: the exact sums
    x = torch.from_numpy(inp["coll_x"][rank])
    out["ring"] = ring_all_reduce(x, mesh, "data").numpy()
    g = torch.from_numpy(inp["coll_g"][rank])
    red, fb = compressed_psum_tree({"w": g}, mesh, "data",
                                   error_fb={"w": torch.from_numpy(inp["coll_e"][rank])})
    out["cmp_red"], out["cmp_fb"] = red["w"].numpy(), fb["w"].numpy()
    # the same value on every rank, as the reference's replicated input
    same = torch.from_numpy(inp["coll_g"][0])
    red, fb = compressed_psum_tree({"w": same}, mesh, "data")
    out["cmp_same_red"], out["cmp_same_fb"] = red["w"].numpy(), fb["w"].numpy()
    out["ring_same"] = ring_all_reduce(same, mesh, "data").numpy()
    return out


# --------------------------------------------------------------------------- MoE a2a
def moe(inp, rank):
    from repro_torch.configs.base import MoEConfig
    from repro_torch.distributed import rules_for_mesh, use_rules
    from repro_torch.models import moe as M

    mesh = _mesh((4, 2))
    rules = rules_for_mesh(mesh)
    p = {k[len("moe_p_"):]: torch.from_numpy(v) for k, v in inp.items() if k.startswith("moe_p_")}
    x = torch.from_numpy(inp["moe_x"])
    out = {}
    for cf in (8.0, 1.0):
        cfg = MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, num_shared_experts=1,
                        capacity_factor=cf)
        y, aux = M.moe_block(x, p, cfg, "silu", dispatch="a2a", mesh=mesh)
        out[f"a2a_{cf}"], out[f"a2a_aux_{cf}"] = _np(y), _np(aux)
        with use_rules(mesh, rules):
            y, aux = M.moe_block(x, p, cfg, "silu", dispatch="a2a", mesh=mesh)
            out[f"a2a_rules_{cf}"], out[f"a2a_rules_aux_{cf}"] = _np(y), _np(aux)
        y, _ = M.moe_block(x, p, cfg, "silu", dispatch="dense")
        out[f"dense_{cf}"] = _np(y)
    return out


# --------------------------------------------------------------------------- manual TP and sharded flash
def layers(inp, rank):
    from repro_torch.distributed import rules_for_mesh, use_rules
    from repro_torch.models import layers as L

    out = {}
    mesh = _mesh((2, 2))
    rules = rules_for_mesh(mesh)
    x = torch.from_numpy(inp["tp_x"])
    p = {k: torch.from_numpy(inp[f"tp_{k}"]) for k in ("w1", "w3", "w2")}
    o = torch.from_numpy(inp["tp_o"])
    wo = torch.from_numpy(inp["tp_wo"])
    with use_rules(mesh, rules):
        out["mlp"] = _np(L.gated_mlp(x, p, "silu", tp_comm="manual_bf16"))
        out["rpo"] = _np(L.row_parallel_out(o, wo, tp_comm="manual_bf16"))
        # gradients through the manual all-reduce
        xg = x.clone().requires_grad_()
        pg = {k: v.clone().requires_grad_() for k, v in p.items()}
        y = L.gated_mlp(xg, pg, "silu", tp_comm="manual_bf16")
        grads = torch.autograd.grad((full(y) * torch.from_numpy(inp["tp_ct"])).sum(),
                                    [xg, pg["w1"], pg["w2"]])
        out["mlp_gx"], out["mlp_gw1"], out["mlp_gw2"] = (_np(g) for g in grads)
    out["mlp_plain"] = _np(L.gated_mlp(x, p, "silu"))

    q, k, v = (torch.from_numpy(inp[f"fl_{n}"]) for n in ("q", "k", "v"))
    with use_rules(mesh, rules):  # KV heads sharded like the query heads
        out["flash_kv_sharded"] = _np(L.attention_trainable(q, k, v, impl="flash"))
    mesh14 = _mesh((1, 4))
    q2, k2, v2 = (torch.from_numpy(inp[f"fr_{n}"]) for n in ("q", "k", "v"))
    with use_rules(mesh14, rules_for_mesh(mesh14)):  # KV heads replicated, query heads sharded
        out["flash_kv_replicated"] = _np(L.attention_trainable(q2, k2, v2, impl="flash"))
        qg = q2.clone().requires_grad_()
        kg = k2.clone().requires_grad_()
        o2 = L.attention_trainable(qg, kg, v2, impl="flash")
        gq, gk = torch.autograd.grad((full(o2) * torch.from_numpy(inp["fr_ct"])).sum(), [qg, kg])
        out["flash_rep_gq"], out["flash_rep_gk"] = _np(gq), _np(gk)
    out["flash_rep_plain"] = _np(L.attention_trainable(q2, k2, v2, impl="flash"))
    return out


# --------------------------------------------------------------------------- reduced models
def models(inp, rank):
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.distributed import rules_for_mesh, use_rules
    from repro_torch.distributed.params import opt_state_shardings, tree_shardings
    from repro_torch.distributed.sharding import place
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import build_model, opt_state_from_numpy, params_from_numpy
    from repro_torch.optim.adamw import AdamW

    mesh = _mesh((2, 2))
    rules = rules_for_mesh(mesh)
    out = {}
    for arch, kw in MODELS:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        pre = f"m_{arch}_"
        flat = {k[len(pre) + 2:]: v for k, v in inp.items() if k.startswith(pre + "p/")}
        params = params_from_numpy(_unflat(flat), device="cpu")
        model = build_model(cfg, mesh=mesh, device="cpu", **kw)
        tokens = torch.from_numpy(inp[pre + "tokens"])
        with use_rules(mesh, rules):
            pp = tree.tree_map(place, params, tree_shardings(params, mesh, rules))
            cache, logits, _ = model.prefill(pp, {"tokens": tokens}, 32)
            out[pre + "prefill"] = _np(logits)
            step_tok = torch.from_numpy(inp[pre + "decode_tokens"])
            for i in range(step_tok.shape[0]):
                logits, cache = model.decode_step(pp, cache, step_tok[i])
                out[pre + f"decode{i}"] = _np(logits)
            st = _unflat({k[len(pre) + 2:]: v for k, v in inp.items()
                          if k.startswith(pre + "o/")})
            opt_state = opt_state_from_numpy((st["step"], st["m"], st["v"]), device="cpu")
            opt_state = tree.tree_map(place, opt_state,
                                      opt_state_shardings(opt_state, params, mesh, rules))
            out[pre + "zero1_m_placed"] = np.array(
                [str(t.placements) for t in tree.leaves(opt_state.m)])
            opt = AdamW(lr=1e-3)
            batch = {"tokens": torch.from_numpy(inp[pre + "train_tokens"])}
            new_p, new_o, met = make_train_step(model, opt)(pp, opt_state, batch)
            out[pre + "loss"] = _np(met["loss"])
            out[pre + "gnorm"] = _np(met["grad_norm"])
            for name, t in tree.flatten_with_names(new_p):
                out[pre + "np/" + name] = _np(t)
            for name, t in tree.flatten_with_names(new_o.m):
                out[pre + "nm/" + name] = _np(t)
        if arch == SEQ_SHARDED:
            # the KV cache's sequence dim over "model" (the dry-run's rule
            # where the KV heads do not divide): each rank holds 16 of the
            # 32 slots, the prefill fills rank 0's, the decode writes rank 1's
            seq_rules = rules_for_mesh(mesh, overrides={"seq": "model"})
            with use_rules(mesh, seq_rules):
                pp = tree.tree_map(place, params, tree_shardings(params, mesh, seq_rules))
                cache, logits, _ = model.prefill(pp, {"tokens": tokens}, 32)
                out[pre + "seq_cache_placements"] = np.array(
                    str(cache["segments"][0]["k"].placements))
                out[pre + "seq_prefill"] = _np(logits)
                for i in range(step_tok.shape[0]):
                    logits, cache = model.decode_step(pp, cache, step_tok[i])
                    out[pre + f"seq_decode{i}"] = _np(logits)
    return out


#: (arch, build_model keywords) of the reduced models held on the (2, 2) mesh
MODELS = (("tinyllama-1.1b", dict(attn_impl="flash", tp_comm="manual_bf16")),
          ("deepseek-moe-16b", dict(attn_impl="flash", tp_comm="manual_bf16",
                                    moe_dispatch="a2a")))
#: the model also served with its KV cache's sequence dim sharded
SEQ_SHARDED = "tinyllama-1.1b"


def _unflat(flat):
    """{"a/0/b": x} -> {"a": [{"b": x}]}: a name's integer parts are list
    indices (the parameter trees hold no dict with integer keys)."""
    root = {}
    for name, v in flat.items():
        parts = name.split("/")
        node = root
        for part, nxt in zip(parts[:-1], parts[1:]):
            node = node.setdefault(part, {})
        node[parts[-1]] = v

    def fix(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [fix(n[str(i)]) for i in range(len(n))]
        return {k: fix(v) for k, v in n.items()}

    return fix(root)


# --------------------------------------------------------------------------- the other families
#: reduced models held on the (2, 2) mesh against their own unsharded run
#: (the unsharded port is held against the reference elsewhere): the ring
#: caches (window cut to 8, so 12 decode steps wrap it), hymba's meta
#: tokens and SSM heads, mamba2's SSD scan and state
FAMILIES = ("gemma3-1b", "hymba-1.5b", "mamba2-370m")
FAMILY_DECODE = 12


def families(inp, rank):
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.distributed import rules_for_mesh, use_rules
    from repro_torch.distributed.params import tree_shardings
    from repro_torch.distributed.sharding import place
    from repro_torch.models.api import build_model

    mesh = _mesh((2, 2))
    rules = rules_for_mesh(mesh)
    out = {}
    for arch in FAMILIES:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        if cfg.window_size:
            cfg = dataclasses.replace(cfg, window_size=8)
        plain = build_model(cfg, device="cpu", attn_impl="flash")
        sharded = build_model(cfg, mesh=mesh, device="cpu", attn_impl="flash")
        params = plain.init(torch.Generator().manual_seed(3))
        tokens = torch.from_numpy(inp["fam_tokens"]) % cfg.vocab_size
        steps = torch.from_numpy(inp["fam_steps"]) % cfg.vocab_size
        runs = {}
        for name, model in (("plain", plain), ("mesh", sharded)):
            ctx = use_rules(mesh, rules) if name == "mesh" else contextlib.nullcontext()
            with ctx:
                p = (tree.tree_map(place, params, tree_shardings(params, mesh, rules))
                     if name == "mesh" else params)
                cache, logits, _ = model.prefill(p, {"tokens": tokens}, 32)
                got = [_np(logits)]
                for i in range(FAMILY_DECODE):
                    logits, cache = model.decode_step(p, cache, steps[i])
                    got.append(_np(logits))
            runs[name] = np.stack(got)
        out[arch + "_plain"], out[arch + "_mesh"] = runs["plain"], runs["mesh"]
    return out


# --------------------------------------------------------------------------- checkpoint / prefetch
def placement(inp, rank):
    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Prefetcher, SyntheticLMDataset
    from repro_torch.distributed import rules_for_mesh
    from repro_torch.distributed.params import tree_shardings
    from repro_torch.distributed.sharding import place

    mesh = _mesh((2, 2))
    rules = rules_for_mesh(mesh)
    t = {"w": torch.from_numpy(inp["ck_w"]), "layers": [{"wq": torch.from_numpy(inp["ck_wq"])}]}
    sh = tree_shardings(t, mesh, rules)
    d = os.path.join(inp["dir"].item(), f"ckpt_rank{rank}")
    m = CheckpointManager(CheckpointConfig(directory=d, async_save=False))
    m.save(1, tree.tree_map(place, t, sh))  # DTensors: their whole values go to disk
    step, got = m.restore(shardings=sh, treedef_like=t)
    out = {"ck_step": np.array(step),
           "ck_w": _np(got["w"]), "ck_wq": _np(got["layers"][0]["wq"]),
           "ck_wq_placements": np.array(str(got["layers"][0]["wq"].placements)),
           "ck_wq_local": got["layers"][0]["wq"].to_local().numpy()}
    cfg = get_config("tinyllama-1.1b").reduced()
    ds = SyntheticLMDataset(cfg, 4, 16, seed=3)
    bsh = tree_shardings(ds.batch_at(0), mesh, rules)
    pf = Prefetcher(ds, start_step=2, shardings=bsh, device="cpu")
    step, batch = next(pf)
    pf.stop()
    out["pf_step"] = np.array(step)
    out["pf_tokens"] = _np(batch["tokens"])
    out["pf_placements"] = np.array(str(batch["tokens"].placements))
    out["pf_local"] = batch["tokens"].to_local().numpy()
    return out


CHECKS = {"collectives": collectives, "moe": moe, "layers": layers, "models": models,
          "families": families, "placement": placement}


# --------------------------------------------------------------------------- the mesh repairs
#: decode steps after each prefill in the repairs' checks
REPAIR_DECODE = 3


def odd_ssd_hymba(cfg):
    """Reduced hymba with 3 SSD heads of 128 (d_inner 384): the head count
    divides no model axis of 2, while d_inner does."""
    ssm = dataclasses.replace(cfg.hybrid.ssm, expand=3, head_dim=128)
    return dataclasses.replace(cfg, hybrid=dataclasses.replace(cfg.hybrid, ssm=ssm))


def _f32_reduced(arch, **kw):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).reduced(), dtype="float32", **kw)


def _plain_and_mesh(cfg, mesh, seed, *, prompts=(), train=None, kw=None, overrides=None):
    """``cfg``'s model run unsharded and on ``mesh`` under its rules (with
    ``overrides``), with the same weights: each prompt's prefill logits and
    REPAIR_DECODE decode steps' logits, and with ``train`` (a batch) one
    ZeRO-1 AdamW step's loss, grad norm and new parameters.  A prompt is
    (tokens, steps) or (batch, steps), a batch a dict of its tokens and
    any other inputs.  {"<run>_<what>": array}."""
    from repro_torch import tree
    from repro_torch.distributed import rules_for_mesh, use_rules
    from repro_torch.distributed.params import opt_state_shardings, tree_shardings
    from repro_torch.distributed.sharding import place
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW

    rules = rules_for_mesh(mesh, overrides)
    plain = build_model(cfg, device="cpu", **(kw or {}))
    params = plain.init(torch.Generator().manual_seed(seed))
    out = {}
    for name in ("plain", "mesh"):
        model = plain if name == "plain" else build_model(cfg, mesh=mesh, device="cpu",
                                                          **(kw or {}))
        ctx = use_rules(mesh, rules) if name == "mesh" else contextlib.nullcontext()

        def laid(t):
            return (tree.tree_map(place, t, tree_shardings(t, mesh, rules))
                    if name == "mesh" else t)

        with ctx:
            p = laid(params)
            for i, (batch, steps) in enumerate(prompts):
                batch = batch if isinstance(batch, dict) else {"tokens": batch}
                batch = dict(batch, tokens=batch["tokens"] % cfg.vocab_size)
                S = batch["tokens"].shape[1]
                cache, logits, _ = model.prefill(p, batch,
                                                 max(32, -(-(S + REPAIR_DECODE) // 16) * 16))
                got = [_np(logits)]
                for tok in steps[:REPAIR_DECODE]:
                    logits, cache = model.decode_step(p, cache, tok % cfg.vocab_size)
                    got.append(_np(logits))
                out[f"{name}_prompt{i}"] = np.stack(got)
            if train is not None:
                opt = AdamW(lr=1e-3)
                state = _moments(opt.init(params), seed)
                if name == "mesh":
                    state = tree.tree_map(place, state,
                                          opt_state_shardings(state, params, mesh, rules))
                new_p, _, met = make_train_step(model, opt)(p, state, laid(train))
                out[f"{name}_loss"], out[f"{name}_gnorm"] = _np(met["loss"]), _np(met["grad_norm"])
                for pname, t in tree.flatten_with_names(new_p):
                    out[f"{name}_np/{pname}"] = _np(t)
    return out


def _moments(state, seed):
    """AdamW state at step 10 with small moments, as ``models`` takes the
    reference's: a first step from zero moments moves each weight by the
    learning rate times the sign of its gradient, whatever its size."""
    from repro_torch import tree

    gen = torch.Generator().manual_seed(seed)
    return type(state)(step=torch.tensor(10, dtype=state.step.dtype),
                       m=tree.tree_map(lambda t: torch.randn(t.shape, generator=gen) * 1e-3,
                                       state.m),
                       v=tree.tree_map(lambda t: torch.rand(t.shape, generator=gen) * 9e-6
                                       + 1e-6, state.v))


def _prompts(inp, *lengths):
    return [(torch.from_numpy(inp["rep_tokens"][:, :n]), torch.from_numpy(inp["rep_steps"]))
            for n in lengths]


def odd_heads(inp, rank):
    """Hymba with an SSD head count the model axis does not divide: a
    batch of 2 prefills (the rows do not divide data x model, so each rank
    keeps its rows' heads whole) and a batch of 4 trains (rows over both
    axes)."""
    cfg = odd_ssd_hymba(_f32_reduced("hymba-1.5b"))
    return _plain_and_mesh(cfg, _mesh((2, 2)), 5, prompts=_prompts(inp, 12),
                           train={"tokens": torch.from_numpy(inp["rep_train4"]) % cfg.vocab_size})


def ssm_scan(inp, rank):
    """mamba2 with its 16 SSD heads over "model": a train step of 4 rows
    of two chunks, and a prefill."""
    cfg = _f32_reduced("mamba2-370m")
    return _plain_and_mesh(cfg, _mesh((2, 2)), 6, prompts=_prompts(inp, 12),
                           train={"tokens": torch.from_numpy(inp["rep_train4"]) % cfg.vocab_size})


def short_prompts(inp, rank):
    """1- and 2-token prompts to mamba2 and hymba (shorter than the
    convolution's window of 3; hymba's 4 meta tokens come first)."""
    out = {}
    for arch in ("mamba2-370m", "hymba-1.5b"):
        got = _plain_and_mesh(_f32_reduced(arch), _mesh((2, 2)), 7, prompts=_prompts(inp, 1, 2))
        out.update({f"{arch}/{k}": v for k, v in got.items()})
    return out


def moe_dense(inp, rank):
    """deepseek-moe's dense dispatch per rank: tokens over "data", its 4
    experts over "model"."""
    cfg = _f32_reduced("deepseek-moe-16b")
    return _plain_and_mesh(cfg, _mesh((2, 2)), 8, prompts=_prompts(inp, 12),
                           train={"tokens": torch.from_numpy(inp["rep_train4"]) % cfg.vocab_size},
                           kw=dict(moe_dispatch="dense"))


def vlm_train(inp, rank):
    """qwen2-vl's ZeRO-1 train step with patch embeddings and M-RoPE
    positions, the batch laid out by the rules (the reference's weights,
    moments and inputs)."""
    from repro_torch import tree
    from repro_torch.distributed import rules_for_mesh, use_rules
    from repro_torch.distributed.params import opt_state_shardings, tree_shardings
    from repro_torch.distributed.sharding import place
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import build_model, opt_state_from_numpy, params_from_numpy
    from repro_torch.optim.adamw import AdamW

    mesh = _mesh((2, 2))
    rules = rules_for_mesh(mesh)
    cfg = _f32_reduced("qwen2-vl-2b")
    pre = "vlm_"
    params = params_from_numpy(_unflat({k[len(pre) + 2:]: v for k, v in inp.items()
                                        if k.startswith(pre + "p/")}), device="cpu")
    st = _unflat({k[len(pre) + 2:]: v for k, v in inp.items() if k.startswith(pre + "o/")})
    state = opt_state_from_numpy((st["step"], st["m"], st["v"]), device="cpu")
    batch = {k: torch.from_numpy(inp[pre + k]) for k in ("tokens", "patch_embeds",
                                                        "positions_thw")}
    model = build_model(cfg, mesh=mesh, device="cpu")
    with use_rules(mesh, rules):
        pp = tree.tree_map(place, params, tree_shardings(params, mesh, rules))
        state = tree.tree_map(place, state, opt_state_shardings(state, params, mesh, rules))
        batch = tree.tree_map(place, batch, tree_shardings(batch, mesh, rules))
        _, _, met = make_train_step(model, AdamW(lr=1e-3))(pp, state, batch)
    return {"loss": _np(met["loss"]), "gnorm": _np(met["grad_norm"])}


#: the repairs' checks (``test_torch_mesh_repairs.py``), run by ``run`` as
#: the checks above are
REPAIRS = {"odd_heads": odd_heads, "ssm_scan": ssm_scan, "short_prompts": short_prompts,
           "moe_dense": moe_dense, "vlm_train": vlm_train}


# --------------------------------------------------------------------------- seq split, FSDP, idle axes
#: the prompt lengths of ``seq_prefill``: qwen2-vl's, one under the dense
#: block's 1M scores and one whose chunks split over 2 ranks take the
#: chunked path; hymba's and gemma3's, past their reduced window of 16
SEQ_LENGTHS = (12, 2304)
SEQ_WINDOWED = ("hymba-1.5b", "gemma3-1b")
SEQ_WINDOWED_LENGTHS = (12, 60)


def seq_prefill(inp, rank):
    """qwen2-vl, hymba and gemma3 with 3 query heads over 1 KV head
    (neither divides the model axis of 2) under the rule the dry run's
    cells add there, "seq" on "model": each prompt's prefill (qwen2-vl's
    with patch embeddings and M-RoPE positions; hymba's 4 meta tokens and
    windows, gemma3's local and global layers) with its query rows split
    over "model", then 3 decode steps against the sequence-sharded
    caches."""
    out = {}
    steps = torch.from_numpy(inp["rep_steps"])
    cfg = _f32_reduced("qwen2-vl-2b", num_heads=3, num_kv_heads=1)
    prompts = [({"tokens": torch.from_numpy(inp[f"seq_tokens{S}"]),
                 "patch_embeds": torch.from_numpy(inp["seq_patch_embeds"]),
                 "positions_thw": torch.from_numpy(inp[f"seq_positions_thw{S}"])}, steps)
               for S in SEQ_LENGTHS]
    got = _plain_and_mesh(cfg, _mesh((2, 2)), 9, prompts=prompts, overrides={"seq": "model"})
    out.update({f"qwen2-vl-2b/{k}": v for k, v in got.items()})
    for arch in SEQ_WINDOWED:
        cfg = _f32_reduced(arch, num_heads=3, num_kv_heads=1)
        prompts = [(torch.from_numpy(inp[f"seq_tokens{S}"]), steps) for S in SEQ_WINDOWED_LENGTHS]
        got = _plain_and_mesh(cfg, _mesh((2, 2)), 9, prompts=prompts, overrides={"seq": "model"})
        out.update({f"{arch}/{k}": v for k, v in got.items()})
    return out


def fsdp_moe(inp, rank):
    """llama4-maverick (4 experts over "model", top-1, a shared expert)
    under the dry run's FSDP rule, "fsdp" on the data axis: the experts'
    w1 and w3 contract over their shard of d_model.  A prefill, 3 decode
    steps and a ZeRO-1 train step."""
    cfg = _f32_reduced("llama4-maverick-400b-a17b")
    return _plain_and_mesh(cfg, _mesh((2, 2)), 10, prompts=_prompts(inp, 12),
                           train={"tokens": torch.from_numpy(inp["rep_train4"]) % cfg.vocab_size},
                           kw=dict(moe_dispatch="dense"), overrides={"fsdp": ("data",)})


def idle_ssm(inp, rank):
    """mamba2 at batch 1, which leaves the data axis idle: the in- and
    out-projections contract over it as well.  A prefill, 3 decode steps
    and a train step, each of one row."""
    cfg = _f32_reduced("mamba2-370m")
    steps = torch.from_numpy(inp["rep_steps"])[:, :1]
    return _plain_and_mesh(cfg, _mesh((2, 2)), 11,
                           prompts=[(torch.from_numpy(inp["rep_tokens"][:1]), steps)],
                           train={"tokens": torch.from_numpy(inp["rep_train4"][:1])
                                  % cfg.vocab_size})


#: the checks of ``test_torch_mesh_seq_fsdp.py``
SEQ_FSDP = {"seq_prefill": seq_prefill, "fsdp_moe": fsdp_moe, "idle_ssm": idle_ssm}


def run(rank, world, port, workdir, names):
    """One rank: every check in ``names``; rank 0 saves each one's outputs."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        inp = dict(np.load(os.path.join(workdir, "inputs.npz"), allow_pickle=False))
        inp["dir"] = np.array(workdir)
        for name in names:
            out = {**CHECKS, **REPAIRS, **SEQ_FSDP}[name](inp, rank)
            if rank == 0:
                np.savez(os.path.join(workdir, f"port_{name}.npz"), **out)
            if name == "placement":  # every rank's own shard, for the layout check
                np.save(os.path.join(workdir, f"placement_local_{rank}.npy"),
                        out["ck_wq_local"])
    except Exception:
        with open(os.path.join(workdir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
