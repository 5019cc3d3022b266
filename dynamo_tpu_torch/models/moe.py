"""Mixture-of-experts FFN (counterpart of dynamo_tpu/models/moe.py).

GShard/Switch capacity routing with the reference's semantics: each token
picks its top-k experts (softmax + renormalised top-k for mixtral, qwen and
gpt-oss; sigmoid scores with a selection-only correction bias and
group-limited top-k for DeepSeek-V3), every (token, choice) takes the next
free slot of its expert's capacity ``C`` in flattened ``(t, j)`` order, and
a choice past ``C`` is dropped (its weight is lost, the rest are not
renormalised). The experts run as one batched product over ``[E, C, d]``,
slots that no token took included, as the reference's XLA einsums do.

Dispatch and combine are a row scatter and a row gather at slot index
``e * C + pos`` instead of the reference's one-hot einsums: the same rows
and the same weights, without the ``[T, E, C]`` (or ``[T, k, E, C]``)
tensors, which at a packed prefill of 8 x 512 rows run to a GB. Nothing
here reads a device value on the host, and every shape is fixed by ``T``,
so a CUDA graph captures it (the engine's decode and verify graphs).

Under a mesh (models/convert.MOE_SHARD_AXES, the reference's
``moe_layer_shardings``) a rank holds ``E / ep`` experts and ``f / tp`` of
each one's FFN columns. Every rank routes all T tokens itself (the same
``route``, so the same capacity, slots and dropped count on every rank,
with no collective), runs only its own experts' slots through its
columns, adds ``b_down`` on tp rank 0 only, combines over its own slots
(other experts read as zeros) and all-reduces the f32 combine over the
expert group (ep x tp ranks) before the cast to the model dtype. With
``dp`` = 1 every rank holds every token, so one all-reduce replaces the
all-to-alls XLA's partitioner inserts in the reference.
"""

from __future__ import annotations

import math

import torch

from dynamo_tpu_torch.engine.config import ModelSpec


def init_moe_layer(spec: ModelSpec, dense, dtype: torch.dtype,
                   device: torch.device, mesh=None) -> dict[str, torch.Tensor]:
    """Router + stacked expert weights for one layer, drawn by ``dense(shape,
    scale=None)`` (models/llama.init_params' seeded draw, fan-in
    ``shape[-2]``). The router and its biases are f32: a bf16 router would
    round the logits that pick the experts. With a ``mesh`` each expert
    leaf is cut to this rank's shard as soon as it is drawn (one full stack
    alive at a time)."""
    from dynamo_tpu_torch.models.convert import MOE_SHARD_AXES, shard_axes

    def cut(name, t):
        return t if mesh is None else shard_axes(t, MOE_SHARD_AXES.get(name), mesh)

    d, e, f = spec.hidden_size, spec.num_experts, spec.moe_intermediate_size
    out = {"router": dense((d, e), scale=0.02).float()}
    for name, shape in (("w_gate", (e, d, f)), ("w_up", (e, d, f)), ("w_down", (e, f, d))):
        out[name] = cut(name, dense(shape))
    if spec.moe_bias:  # gpt-oss: router + expert biases
        out["router_bias"] = torch.zeros(e, dtype=torch.float32, device=device)
        for name, shape in (("b_gate", (e, f)), ("b_up", (e, f)), ("b_down", (e, d))):
            out[name] = cut(name, torch.zeros(shape, dtype=dtype, device=device))
    if spec.moe_scoring == "sigmoid":
        # DeepSeek-V3 aux-free balancing: shifts the selection only
        out["score_bias"] = torch.zeros(e, dtype=torch.float32, device=device)
    return out


def expert_capacity(
    T: int, E: int, k: int, capacity_factor: float = 1.25
) -> int:
    """Per-expert slot budget: ``E*C ~= T*k*cf`` whatever ``E``, floored at
    ``min(T, 16)`` so a decode batch (T <= 16) can never drop."""
    cap = math.ceil(T * k / E * capacity_factor)
    return max(1, min(T, max(cap, 16)))


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: on ties the lower index comes
    first (``torch.topk``'s tie order is unspecified), through a stable
    descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(spec: ModelSpec, lp, x: torch.Tensor):
    """Each token's experts and combine weights: (weights [T, k] f32,
    experts [T, k] int64)."""
    T = x.shape[0]
    E, k = spec.num_experts, spec.num_experts_per_token
    logits = x.float() @ lp.router
    if lp.get("router_bias") is not None:
        logits = logits + lp.router_bias
    if spec.moe_scoring == "sigmoid":
        # DeepSeek-V3 noaux_tc: the biased scores pick, the unbiased ones
        # weigh (renormalised, times routed_scaling_factor)
        scores = torch.sigmoid(logits)
        choice = scores + lp.score_bias
        if spec.n_group > 1:
            gsz = E // spec.n_group
            group_scores = top_k(choice.reshape(T, spec.n_group, gsz), 2)[0].sum(-1)
            gidx = top_k(group_scores, spec.topk_group)[1]
            gmask = torch.zeros_like(group_scores).scatter_(1, gidx, 1.0)
            gmask = gmask[..., None].expand(T, spec.n_group, gsz).reshape(T, E)
            choice = torch.where(gmask > 0, choice, 0.0)
        topi = top_k(choice, k)[1]
        topv = torch.gather(scores, 1, topi)
        if spec.norm_topk_prob:
            topv = topv / (topv.sum(-1, keepdim=True) + 1e-20)
        topv = topv * spec.routed_scaling_factor
    else:
        # softmax over all + renormalised top-k == softmax over the top-k
        # logits (HF GptOssTopKRouter): the same selection and weights
        topv, topi = top_k(torch.softmax(logits, dim=-1), k)
        topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    return topv, topi


def moe_mlp(
    spec: ModelSpec, lp, x: torch.Tensor, *,
    capacity_factor: float = 1.25,
    return_dropped: bool = False,
    mesh=None,
):
    """x [T, d] -> [T, d] through the top-k routed experts; with
    ``return_dropped`` also the number of (token, choice) slots past their
    expert's capacity, an int32 device scalar. With a ``mesh`` the layer
    holds this rank's experts and columns, and the output is the expert
    group's all-reduced sum (every rank the same)."""
    T, d = x.shape
    E, k = spec.num_experts, spec.num_experts_per_token
    C = expert_capacity(T, E, k, capacity_factor)
    topv, topi = route(spec, lp, x)

    # each choice's position in its expert: the count of earlier choices of
    # the same expert in flattened (t, j) order
    flat = topi.reshape(T * k)
    oh = torch.nn.functional.one_hot(flat, num_classes=E)  # [T*k, E]
    pos = torch.gather(torch.cumsum(oh, dim=0) - oh, 1, flat[:, None])
    pos = pos.reshape(T, k)
    keep = pos < C
    # this rank's experts: [e0, e0 + El) (all of them without a mesh)
    El = lp.w_gate.shape[0]
    e0 = mesh.ep_rank * El if mesh is not None else 0
    local = keep & (topi >= e0) & (topi < e0 + El)
    # slot row (e - e0)*C + pos; a dropped choice, or another rank's, goes to
    # the spare row El*C, which the experts never read and the combine reads
    # as zeros
    slot = torch.where(local, (topi - e0) * C + pos, El * C).reshape(T * k)

    xe = x.new_zeros((El * C + 1, d))
    xe.index_copy_(0, slot, x[:, None, :].expand(T, k, d).reshape(T * k, d))
    xe = xe[: El * C].view(El, C, d)
    g = torch.bmm(xe, lp.w_gate)  # [El, C, f/tp]
    u = torch.bmm(xe, lp.w_up)
    if lp.get("b_gate") is not None:
        g = g + lp.b_gate[:, None, :]
        u = u + lp.b_up[:, None, :]
    if spec.swiglu_limit:
        # gpt-oss clamped swiglu (HF GptOssExperts.forward)
        lim = spec.swiglu_limit
        g = g.clamp(max=lim)
        u = u.clamp(-lim, lim)
        h = g * torch.sigmoid(spec.swiglu_alpha * g) * (u + 1.0)
    else:
        h = torch.nn.functional.silu(g) * u
    out_e = torch.bmm(h, lp.w_down)  # [El, C, d]: a tp rank's partial
    if lp.get("b_down") is not None and (mesh is None or mesh.tp_rank == 0):
        out_e = out_e + lp.b_down[:, None, :]

    rows = torch.cat([out_e.reshape(El * C, d).float(),
                      out_e.new_zeros((1, d), dtype=torch.float32)])
    w = topv * local
    out = (rows[slot].view(T, k, d) * w[..., None]).sum(1)
    if mesh is not None:
        out = mesh.all_reduce(out, "expert")
    out = out.to(x.dtype)
    if return_dropped:
        return out, (~keep).sum().to(torch.int32)
    return out
