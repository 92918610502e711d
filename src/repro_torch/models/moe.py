"""Mixture-of-experts block: a top-k router, shared experts and the
capacity-based dense dispatch (the JAX package's ``repro.models.moe`` in
PyTorch).

The router follows deepseek-moe (a softmax gate over the routed experts,
top-k with renormalised weights, a load-balancing aux loss) and is top-1
for llama4-maverick.  Routing and dispatch keep the reference's order,
because which assignments a full expert drops depends on it:

* ties among the router's probabilities go to the lower expert index, as
  ``jax.lax.top_k`` orders them (a stable descending sort; ``torch.topk``
  promises no order among ties);
* an assignment's place in its expert's bucket counts the assignments
  before it in the token-major flattening (token 0's k choices, then
  token 1's); one at or past the capacity is dropped;
* a token's k expert outputs are added in order k = 0 .. k-1 in the
  model's dtype, as the reference's scatter-add does, and never through
  atomics, whose order (and so whose bf16 sum) changes from run to run on
  the card.

The expert-parallel dispatch (``dispatch="a2a"``) runs on a mesh with a
"model" axis: a ``shard_map`` (DTensor's ``local_map``) in which each model
rank buckets its own expert group, runs those experts, scatters the
partial outputs back and one all-reduce over "model" combines them.
Without a mesh "a2a" is the dense dispatch, as in the reference.  Under a
rules context the dense dispatch runs per rank in a ``shard_map`` too
(DTensor has no sharding rule for its data-dependent scatter): tokens on
their data shards, experts on their "model" shards.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.distributed.annotate import (
    _current,
    _SumGradOver,
    all_reduce_sum,
    ann,
    axis_index,
    is_dtensor,
    shard_map,
)
from repro_torch.distributed.sharding import P, _as_tuple
from repro_torch.models.layers import _act


def router_topk(x: torch.Tensor, w_router: torch.Tensor,
                cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [T, D] -> (weights [T, k] f32, idx [T, k] int64, aux loss f32 scalar).
    The k weights are renormalised to sum to 1 unless ``cfg.norm_topk_prob``
    is False (DeepSeek-V2), where they stay the softmax's."""
    logits = x.float() @ w_router.float()  # [T, E]
    # laid out by token, and so is its cotangent: the aux loss's mean over
    # tokens sends back a replicated one, and the softmax's and router's
    # backward would then run on every token on every rank
    probs = ann(torch.softmax(logits, dim=-1), "batch", None)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :cfg.top_k], idx[:, :cfg.top_k]
    if cfg.top_k > 1 and cfg.norm_topk_prob:
        weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    # switch-style load-balancing loss over the top-1 choices
    E = w_router.shape[-1]
    me = probs.mean(dim=0)  # mean router probability per expert
    ce = F.one_hot(idx[:, 0], E).float().mean(dim=0)  # share of tokens by top-1 choice
    aux = (me * ce).sum() * E * cfg.aux_loss_coef
    return weights, idx, aux


def dispatch_plan(idx: torch.Tensor, cfg: MoEConfig, T: int):
    """Where each of the T * k assignments goes: (flat expert ids [T*k],
    positions in the expert's bucket [T*k] (0 where dropped), keep mask
    [T*k], source token of each assignment [T*k], capacity)."""
    E, k = cfg.num_experts, cfg.top_k
    cap = max(int(cfg.capacity_factor * k * T / E), 1)
    flat_e = idx.reshape(-1)
    onehot = F.one_hot(flat_e, E)
    # 0-based position of each assignment among its expert's, in token-major order
    pos = torch.gather(torch.cumsum(onehot, dim=0), 1, flat_e[:, None])[:, 0] - 1
    keep = pos < cap
    pos_c = torch.where(keep, pos, torch.zeros_like(pos))
    src_tok = torch.arange(T, device=idx.device).repeat_interleave(k)
    return flat_e, pos_c, keep, src_tok, cap


def _moe_dense(xt: torch.Tensor, weights: torch.Tensor, idx: torch.Tensor, p: dict,
               cfg: MoEConfig, act: str) -> torch.Tensor:
    """Capacity-based scatter / gather dispatch (``_dispatch`` on every
    token and expert; under a rules context ``_moe_dense_per_rank``)."""
    ctx = _current()
    if ctx is not None:
        return _moe_dense_per_rank(xt, weights, idx, p, cfg, act, *ctx)
    return _dispatch(xt, weights, idx, p["w1"], p["w3"], p["w2"], cfg, act, xt.shape[0])


def _dispatch(xt, weights, idx, w1, w3, w2, cfg: MoEConfig, act: str, T: int, r: int = 0,
              n_tok: int = 1, e0: int = 0, tok_sum=None, fsdp=None) -> torch.Tensor:
    """The dispatch of this rank's share of the tokens (share ``r`` of
    ``n_tok``: ``xt`` [T / n_tok, D]) through its experts e0 ..
    e0 + w1.shape[0] - 1, with the routing of all T tokens (``idx`` [T,
    k]) and the router weights of this share's (``weights`` [T / n_tok,
    k]).  Tokens go into per-expert buckets [E, cap, D], each
    expert's FFN runs as one batched product, and the results come back
    weighted by the router, added in order k = 0 .. k-1.  A bucket row
    takes its token by a gather (a kept assignment has a row of its own;
    rows no token of this share fills are zeros), never a [T * k, D]
    copy of the tokens.  ``tok_sum`` (mesh, axes): the other shares of
    the tokens are on those axes, whose sum completes the buckets; the
    experts then run alike on each of them, and each takes its share of
    the weight gradients' rows (``_BmmRowShare``).  ``fsdp`` (mesh, axes):
    w1 and w3 hold this rank's block of d_model's rows over those axes
    (FSDP): the buckets are cut to the same columns (``_SplitLast``: a
    reduce-scatter over the token axes among them), the partial products
    summed over the axes before the activation, and w1 / w3 take their
    gradients over every bucket row.  Returns [T / n_tok, D], partial over
    the experts of other ranks."""
    t_local, D = xt.shape
    k, e_local = cfg.top_k, w1.shape[0]
    flat_e, pos_c, keep, src_tok, cap = dispatch_plan(idx, cfg, T)
    local_e = flat_e - e0
    mine = keep & (local_e >= 0) & (local_e < e_local)
    spare = e_local * cap
    row = torch.where(mine, local_e * cap + pos_c, torch.full_like(pos_c, spare))
    src = src_tok - r * t_local
    ours = mine & (src >= 0) & (src < t_local)
    src_of_row = torch.full((spare + 1,), t_local, dtype=src.dtype, device=src.device)
    src_of_row[torch.where(ours, row, torch.full_like(row, spare))] = torch.where(
        ours, src, torch.full_like(src, t_local))
    x_pad = torch.cat([xt, xt.new_zeros((1, D))])
    buckets = x_pad[src_of_row[:spare]].view(e_local, cap, D)
    share = (cap * r // n_tok, cap * (r + 1) // n_tok)
    tok_axes = tok_sum[1] if tok_sum is not None else ()
    if fsdp is not None:
        mesh, d_axes = fsdp
        rest = tuple(a for a in tok_axes if a not in d_axes)
        if rest:
            buckets = all_reduce_sum(buckets, mesh, rest)
        cols = _SplitLast.apply(buckets, mesh, d_axes, tuple(a for a in d_axes if a in tok_axes))

        # the partial products over this rank's columns, summed
        h1 = all_reduce_sum(torch.bmm(cols, w1), mesh, d_axes)
        h3 = all_reduce_sum(torch.bmm(cols, w3), mesh, d_axes)
    else:
        if tok_sum is not None:
            buckets = all_reduce_sum(buckets, *tok_sum)
        h1 = _BmmRowShare.apply(buckets, w1, *share)
        h3 = _BmmRowShare.apply(buckets, w3, *share)

    hh = _act(act)(h1) * h3
    # with FSDP the w2 product's input gradient, too, is taken over this
    # rank's share of the rows, and the shares gathered (as XLA splits it)
    shares = ((n_tok, [fsdp[0].get_group(a) for a in tok_axes])
              if fsdp is not None and n_tok > 1 else None)
    o = _BmmRowShare.apply(hh, w2, *share, shares)  # [e_local, cap, D]
    if tok_sum is not None:  # every share's cotangent of the common buckets, summed
        mesh, axes = tok_sum
        o = _SumGradOver.apply(o, [mesh.get_group(a) for a in axes])

    a = slice(r * t_local * k, (r + 1) * t_local * k)  # this share's assignments
    gathered = o.reshape(spare, D)[row[a].clamp(max=spare - 1)]
    gathered = torch.where(mine[a, None], gathered, torch.zeros_like(gathered))
    terms = (gathered * weights.reshape(-1, 1).to(gathered.dtype)).view(t_local, k, D)
    y = torch.zeros_like(xt)
    for j in range(k):  # the reference's scatter-add order, in the model's dtype
        y = y + terms[:, j]
    return y


def _moe_dense_per_rank(xt, weights, idx, p, cfg: MoEConfig, act, mesh, rules) -> torch.Tensor:
    """The dense dispatch in a ``shard_map``, laid out as the reference's
    GSPMD run lays it out: tokens over the data axes, experts over "model",
    each expert's bucket whole on every data rank.  The plan (one cumsum
    over all T * k assignments) needs the expert choices whole: ``idx``
    is gathered; the router weights and the tokens are not (a rank's
    share of the router's backward stays its own tokens').  Each rank runs
    ``_dispatch`` on its tokens and experts, and one sum over the expert
    (and expert-FF) axes completes its tokens' outputs.  The experts'
    weight gradients are left a partial sum over the data axes, as XLA
    splits them.  Where the rules give "fsdp" axes (llama4-maverick's
    cells), w1 and w3 keep their FSDP shard of d_model and contract over
    it, a 1/n share of the product a rank, as XLA contracts them; w2's
    shard is gathered at the boundary and its product runs whole, as in
    the reference."""
    names = list(mesh.mesh_dim_names)
    E, T = cfg.num_experts, xt.shape[0]
    tok_spec = rules.spec(xt.shape, ("batch", None))
    w1_spec = rules.spec(p["w1"].shape[-3:], ("expert", "fsdp", "expert_ff"))
    w2_spec = rules.spec(p["w2"].shape[-3:], ("expert", "expert_ff", "fsdp"))
    w2_spec = P(w2_spec[0], w2_spec[1], None)
    e_axes, ff_axes = _as_tuple(w1_spec[0]), _as_tuple(w1_spec[2])
    d_axes = _as_tuple(w1_spec[1])
    tok_axes = _as_tuple(tok_spec[0])
    if set(tok_axes) & (set(e_axes) | set(ff_axes)):
        tok_spec, tok_axes = P(None, None), ()

    def ways(axes) -> int:
        return math.prod(mesh.size(names.index(a)) for a in axes)

    n_tok, red = ways(tok_axes), e_axes + ff_axes
    e_local = E // ways(e_axes)

    def local_fn(xt_l, weights_l, idx_w, w1, w3, w2):
        y = _dispatch(xt_l, weights_l, idx_w, w1, w3, w2, cfg, act, T,
                      r=axis_index(mesh, tok_axes) if tok_axes else 0, n_tok=n_tok,
                      e0=axis_index(mesh, e_axes) * e_local if e_axes else 0,
                      tok_sum=(mesh, tok_axes) if n_tok > 1 else None,
                      fsdp=(mesh, d_axes) if d_axes else None)
        return all_reduce_sum(y, mesh, red) if ways(red) > 1 else y

    return shard_map(local_fn, mesh, (tok_spec, tok_spec, P(None, None), w1_spec, w1_spec,
                                      w2_spec),
                     tok_spec, reduces=red)(xt, weights, idx, p["w1"], p["w3"], p["w2"])


class _SplitLast(torch.autograd.Function):
    """This rank's block of the last dim of ``x``, cut over mesh ``axes``
    (major first, as a dim sharded over several axes is): over an axis in
    ``summed`` the ranks hold parts of a sum, which is reduce-scattered;
    over the others they hold the same tensor, which is sliced.  The
    backward gathers the blocks of the cotangent, minor axis first."""

    @staticmethod
    def forward(ctx, x, mesh, axes, summed):
        import torch.distributed as dist

        names = list(mesh.mesh_dim_names)
        ctx.groups = [mesh.get_group(a) for a in axes]
        for a, grp in zip(axes, ctx.groups):
            w = x.shape[-1] // mesh.size(names.index(a))
            if a in summed:
                t = x.movedim(-1, 0).contiguous()
                out = t.new_empty((w,) + t.shape[1:])
                dist.reduce_scatter_tensor(out, t, group=grp)
                x = out.movedim(0, -1)
            else:
                i = mesh.get_local_rank(a)
                x = x[..., i * w:(i + 1) * w]
        return x.contiguous()

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        for grp in reversed(ctx.groups):
            t = g.movedim(-1, 0).contiguous()
            out = t.new_empty((dist.get_world_size(grp) * t.shape[0],) + t.shape[1:])
            dist.all_gather_into_tensor(out, t, group=grp)
            g = out.movedim(0, -1)
        return g.contiguous(), None, None, None


class _BmmRowShare(torch.autograd.Function):
    """``torch.bmm(a, w)``; the backward takes w's gradient over rows lo:hi
    of a only (this rank's share of rows that every rank holds alike, with
    a cotangent that every rank holds alike): a partial sum, which the
    ranks' shares complete.  With ``shares`` (n, process groups, major
    first), a's gradient too is taken over rows lo:hi only (share r =
    cap * r // n .. cap * (r + 1) // n of the cap rows) and gathered from
    the n ranks of the groups.  With the whole range it is autograd's own
    backward of ``bmm``."""

    @staticmethod
    def forward(ctx, a, w, lo: int, hi: int, shares=None):
        ctx.save_for_backward(a, w)
        ctx.rows, ctx.shares = (lo, hi), shares
        return torch.bmm(a, w)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        lo, hi = ctx.rows
        ga = gw = None
        if ctx.needs_input_grad[0]:
            if ctx.shares is None:
                ga = g.bmm(w.transpose(1, 2))
            else:
                ga = _gather_shares(g[:, lo:hi].bmm(w.transpose(1, 2)), g.shape[1], *ctx.shares)
        if ctx.needs_input_grad[1]:
            gw = a[:, lo:hi].transpose(1, 2).bmm(g[:, lo:hi])
        return ga, gw, None, None, None


def _gather_shares(t: torch.Tensor, cap: int, n: int, groups) -> torch.Tensor:
    """Each rank's share of the cap rows (dim 1) of a [E, cap, F] tensor,
    share r = rows cap * r // n .. cap * (r + 1) // n on the rank whose
    index over ``groups`` (major first) is r, gathered into all cap rows
    on every rank."""
    import torch.distributed as dist

    per = -(-cap // n)
    rows = F.pad(t, (0, 0, 0, per - t.shape[1])).movedim(1, 0).contiguous()
    for grp in reversed(groups):  # minor axis first: the blocks land major first
        out = rows.new_empty((dist.get_world_size(grp) * rows.shape[0],) + rows.shape[1:])
        dist.all_gather_into_tensor(out, rows, group=grp)
        rows = out
    keep = [j * per + i for j in range(n) for i in range(cap * (j + 1) // n - cap * j // n)]
    return rows[torch.tensor(keep, device=rows.device)].movedim(0, 1)


def moe_block(x: torch.Tensor, p: dict, cfg: MoEConfig, act: str = "silu",
              dispatch: str = "dense", mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux loss).

    p = {router [D, E] f32, w1 / w3 [E, D, F], w2 [E, F, D], and with
    shared experts shared_w1 / shared_w3 [D, F * ns], shared_w2 [F * ns, D]}.
    ``dispatch="a2a"`` with a mesh that has a "model" axis is the
    expert-parallel dispatch; anything else the dense one."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    weights, idx, aux = router_topk(xt, p["router"], cfg)
    if dispatch == "a2a" and mesh is not None and "model" in mesh.mesh_dim_names:
        y = _moe_a2a(xt, weights, idx, p, cfg, act, mesh)
    else:
        y = _moe_dense(xt, weights, idx, p, cfg, act)
    if cfg.num_shared_experts > 0:
        fn = _act(act)
        sh = fn(xt @ p["shared_w1"]) * (xt @ p["shared_w3"])
        sh = ann(sh, "batch", "mlp")
        y = y + sh @ p["shared_w2"]
    if is_dtensor(y) and B % _row_shards(y):
        # tokens sharded more ways than the batch divides: DTensor cannot
        # split them back into [B, S] in place
        y = ann(y, None, None)
    return y.reshape(B, S, D), aux


def _row_shards(t) -> int:
    """How many ways a DTensor's dim 0 is split."""
    from torch.distributed.tensor import Shard

    n = 1
    for size, pl in zip(t.device_mesh.shape, t.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            n *= size
    return n


def _moe_a2a(xt, weights, idx, p, cfg: MoEConfig, act, mesh) -> torch.Tensor:
    """Expert-parallel dispatch in a ``shard_map``.

    Tokens are sharded over the data axes and REPLICATED over "model";
    experts are sharded over "model".  Each model rank therefore already
    holds every token of its data shard: it buckets them for its LOCAL
    expert group only, with the reference's capacity ``int(cf * k *
    t_local / E) + 1`` (not the dense dispatch's), runs those experts,
    scatters the partial outputs back to token positions, and one
    activation-sized all-reduce over "model" combines the groups.  Where
    the expert FF dim is sharded too (over ``ff_axes``), its partial sums
    are all-reduced first; if those axes also shard the tokens, the tokens
    are replicated instead (partial sums of different tokens must not
    mix)."""
    names = list(mesh.mesh_dim_names)
    E, k = cfg.num_experts, cfg.top_k
    e_local = E // mesh.size(names.index("model"))

    # the rules' layout of every weight dim (no hidden gathers); without
    # rules, tokens over the data axes and experts over "model"
    ctx = _current()
    if ctx is not None:
        rules = ctx[1]
        tok_spec = rules.spec(xt.shape, ("batch", None))
        w1_spec = rules.spec(p["w1"].shape[-3:], ("expert", "fsdp", "expert_ff"))
        w2_spec = rules.spec(p["w2"].shape[-3:], ("expert", "expert_ff", "fsdp"))
        # the local products contract the whole d_model: an FSDP shard on D
        # is gathered at the shard_map's boundary
        w1_spec = P(w1_spec[0], None, w1_spec[2])
        w2_spec = P(w2_spec[0], w2_spec[1], None)
    else:
        data_axes = tuple(a for a in ("pod", "data") if a in names)
        tok_spec = P(data_axes if data_axes else None, None)
        w1_spec = w2_spec = P("model", None, None)

    tok_axes = _as_tuple(tok_spec[0])
    ff_axes = _as_tuple(w1_spec[2])
    if set(ff_axes) & set(tok_axes):
        tok_spec, tok_axes = P(None, None), ()
    n_tok_shards = 1
    for a in tok_axes:
        n_tok_shards *= mesh.size(names.index(a))
    t_local = max(xt.shape[0] // n_tok_shards, 1)
    cap = max(int(cfg.capacity_factor * cfg.top_k * t_local / E) + 1, 1)
    fn = _act(act)

    def local_fn(xt_l, weights_l, idx_l, w1, w3, w2):
        # xt_l [t_local, D]; w1 / w3 [e_local, D, F_local]; w2 [e_local, F_local, D]
        m = mesh.get_local_rank("model")
        tl, D = xt_l.shape
        flat_e = idx_l.reshape(-1)  # [tl * k] global expert ids
        onehot = F.one_hot(flat_e, E)
        pos = torch.gather(torch.cumsum(onehot, dim=0), 1, flat_e[:, None])[:, 0] - 1
        local_e = flat_e - m * e_local
        mine = (local_e >= 0) & (local_e < e_local) & (pos < cap)
        row = local_e.clamp(0, e_local - 1) * cap + torch.where(mine, pos, torch.zeros_like(pos))
        spare = e_local * cap
        src_tok = torch.arange(tl, device=xt_l.device).repeat_interleave(k)
        buckets = xt_l.new_zeros((spare + 1, D))
        buckets[torch.where(mine, row, torch.full_like(row, spare))] = xt_l[src_tok]
        buckets = buckets[:spare].view(e_local, cap, D)
        hh = fn(torch.bmm(buckets, w1)) * torch.bmm(buckets, w3)
        o = torch.bmm(hh, w2)  # [e_local, cap, D] (partial if the FF dim is sharded)
        if ff_axes:
            o = all_reduce_sum(o, mesh, ff_axes)
        gathered = o.reshape(spare, D)[row]
        gathered = torch.where(mine[:, None], gathered, torch.zeros_like(gathered))
        terms = (gathered * weights_l.reshape(-1, 1).to(gathered.dtype)).view(tl, k, D)
        y = torch.zeros_like(xt_l)
        for j in range(k):  # the dense dispatch's order, in the model's dtype
            y = y + terms[:, j]
        return all_reduce_sum(y, mesh, "model")

    flat_spec = P(tok_spec[0], None)  # routing weights / indices [T, k]
    return shard_map(local_fn, mesh,
                     (tok_spec, flat_spec, flat_spec, w1_spec, w1_spec, w2_spec), tok_spec,
                     reduces=("model",) + ff_axes)(xt, weights, idx, p["w1"], p["w3"], p["w2"])


def _normal_stack(gen: torch.Generator, shape, scale: float, dtype, n: Optional[int]):
    """Normal weights times ``scale`` in ``dtype``, [n, *shape] when ``n``
    is given, drawn one layer at a time so no f32 copy of a whole expert
    stack is ever held (deepseek-moe-16b's w1 stack is 19.9 GB in f32)."""
    if n is None:
        return (torch.randn(tuple(shape), generator=gen, device=gen.device) * scale).to(dtype)
    out = torch.empty((n, *shape), dtype=dtype, device=gen.device)
    for i in range(n):
        out[i] = torch.randn(tuple(shape), generator=gen, device=gen.device) * scale
    return out


def init_moe_params(gen: torch.Generator, cfg: MoEConfig, d_model: int, dtype,
                    n: Optional[int] = None) -> dict:
    """The reference's leaves, scales and dtypes (the router in f32), drawn
    from ``gen``; ``n`` stacks that many layers."""
    E, F_ = cfg.num_experts, cfg.d_ff_expert
    s_in, s_out = d_model ** -0.5, F_ ** -0.5
    p = {
        "router": _normal_stack(gen, (d_model, E), s_in, torch.float32, n),
        "w1": _normal_stack(gen, (E, d_model, F_), s_in, dtype, n),
        "w3": _normal_stack(gen, (E, d_model, F_), s_in, dtype, n),
        "w2": _normal_stack(gen, (E, F_, d_model), s_out, dtype, n),
    }
    if cfg.num_shared_experts > 0:
        Fs = F_ * cfg.num_shared_experts
        p["shared_w1"] = _normal_stack(gen, (d_model, Fs), s_in, dtype, n)
        p["shared_w3"] = _normal_stack(gen, (d_model, Fs), s_in, dtype, n)
        p["shared_w2"] = _normal_stack(gen, (Fs, d_model), Fs ** -0.5, dtype, n)
    return p
