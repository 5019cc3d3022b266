"""Pipeline parallelism: layer stages over the mesh's ``pp`` ranks (the
counterpart of dynamo_tpu/parallel/pipeline.py).

A library path, as in the reference: the engine stages no layers (its
config refuses ``pp`` > 1), and these functions are driven directly.

Layout (the reference's ``pp_param_shardings`` / ``pp_cache_shardings``):
``stack_params`` restacks a rank's layers into leaves with a leading layer
axis ``[L / pp, ...]``: its stage's consecutive layers, their heads and FFN
columns cut over tp (``models/convert.shard_params`` or ``init_params`` /
``load_params`` with the pp mesh cut them). The embedding and the final
norm are whole on every rank; an untied lm head's columns are cut over tp.
A rank's stage pools are ``[L / pp, pages, KH / tp, page, D]``
(``init_stage_cache``), replicated over dp.

Decode (``pp_decode_step``) runs the reference's fixed GPipe schedule: the
slot batch (this rank's ``B / dp`` rows) splits into ``pp`` microbatches,
and at tick ``t`` stage ``s`` runs microbatch ``t - s``: ``2 * pp - 1``
ticks, each stage running its layers at every tick. Bubble ticks compute
on whatever activation they hold and write their K/V rows to trash page 0,
as padded slots do. Activations hop stage to stage by ``Mesh.ppermute``
over pp (the last tick's hop, which nothing reads, is not sent: XLA drops
it from the reference's program too), and the last stage's activations are
broadcast over pp. A stage writes each layer's new rows with the
``kv_write`` kernel and then reads with ``paged_attention_v3`` (the
reference's ``write_new_kv`` then ``paged_decode_attention_auto``), never
``fused_decode``: the reference writes and then reads. Under dp the new
rows, pages and offsets are all-gathered over dp before the write, so the
replicated pools stay equal. Prefill (``pp_prefill``) is one microbatch:
fill and drain, ``pp`` ticks. The tp partials are all-reduced in f32 over
tp, as in the engine's forwards.

The pools must be plain tensors: a stage writes unquantized pages, as the
reference's (``dynamo_tpu/engine/core.py:228`` refuses fp8 under pp). MoE
layers and the attention extras (biases, sinks, sliding windows) are not
staged.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dynamo_tpu_torch.engine.config import ModelSpec
from dynamo_tpu_torch.models.llama import (
    TRASH_PAGE,
    apply_rope,
    init_cache,
    rms_norm,
    rope_tables,
)
from dynamo_tpu_torch.ops.attention import (
    causal_attention,
    page_tiles,
    paged_decode_attention_auto,
)
from dynamo_tpu_torch.ops.quant import is_quant

# the leaves of a staged layer (the reference's stacked pytree)
LAYER_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up",
                "w_down")


@dataclass
class StageParams:
    """One rank's pipeline weights: ``layers`` maps each leaf of
    ``LAYER_LEAVES`` to its stage's stack ``[L / pp, ...]`` (cut over tp);
    the embedding ``[V, d]`` and the final norm whole; an untied head ``[d,
    V / tp]``, or None when tied. ``mesh`` is the rank's mesh."""

    embed: torch.Tensor
    final_norm: torch.Tensor
    lm_head: torch.Tensor | None
    layers: dict[str, torch.Tensor]
    mesh: object

    @property
    def n_local(self) -> int:
        return self.layers["wq"].shape[0]


def stack_params(spec: ModelSpec, params) -> StageParams:
    """A rank's stage weights (``LlamaParams`` cut for a pp mesh: its
    stage's layers, tp shards) as stacked leaves. The layers' tensors move
    into the stacks, leaf by leaf (``params``' layers are left empty), so
    the stage never holds two copies of its weights. Raises on MoE specs, in
    the reference's words, and on the attention extras the stages lack."""
    if spec.num_experts:
        raise NotImplementedError(
            "pipeline parallelism currently covers dense layers only; "
            "run MoE models with ep/tp (wide-EP) instead")
    if spec.attn_bias or spec.has_attn_extras or spec.is_mla:
        raise NotImplementedError(
            "pipeline stages cover llama layers without attention biases, "
            "sinks or sliding windows")
    mesh = params.mesh
    pp = mesh.shape["pp"] if mesh is not None else 1
    if spec.num_layers % pp:
        raise ValueError(f"layers {spec.num_layers} must divide pp={pp}")
    if len(params.layers) != spec.num_layers // pp:
        raise ValueError(
            f"{len(params.layers)} layers given: a stage of pp={pp} holds "
            f"{spec.num_layers // pp} (cut the weights with the pp mesh)")
    layers = {}
    for name in LAYER_LEAVES:
        layers[name] = torch.stack([getattr(lp, name).data for lp in params.layers])
        for lp in params.layers:
            delattr(lp, name)  # the stack holds the leaf now: one copy at a time
    return StageParams(params.embed.data, params.final_norm.data,
                       None if params.lm_head is None else params.lm_head.data,
                       layers, mesh)


def init_stage_cache(spec: ModelSpec, num_pages: int, page_size: int, mesh,
                     device=None, dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """A rank's zeroed stage pools ``[L / pp, num_pages, KH / tp, page, D]``
    (page 0 is the trash page; the reference's ``pp_cache_shardings``)."""
    import dataclasses

    n_local = spec.num_layers // mesh.shape["pp"]
    return init_cache(dataclasses.replace(spec, num_layers=n_local), num_pages,
                      page_size, dtype=dtype, device=device, tp=mesh.shape["tp"])


def _check(spec: ModelSpec, k_pages, mesh) -> None:
    if is_quant(k_pages):
        raise ValueError(
            "pipeline stages write unquantized pages: fp8 pools are not "
            "supported under pp (use bf16 pools)")
    S = mesh.shape["pp"]
    if spec.num_layers % S:
        raise ValueError(f"layers {spec.num_layers} must divide pp={S}")


def _mlp(lp, i: int, h: torch.Tensor, mesh) -> torch.Tensor:
    m = (torch.nn.functional.silu(h @ lp["w_gate"][i]) * (h @ lp["w_up"][i])) @ lp[
        "w_down"][i]
    return mesh.all_reduce(m)


def _qkv(spec: ModelSpec, lp, i: int, h: torch.Tensor, rot):
    lead = h.shape[:-1]
    q = (h @ lp["wq"][i]).reshape(*lead, -1, spec.head_dim)
    k = (h @ lp["wk"][i]).reshape(*lead, -1, spec.head_dim)
    v = (h @ lp["wv"][i]).reshape(*lead, -1, spec.head_dim)
    return apply_rope(q, *rot), apply_rope(k, *rot), v


def _stage_decode(spec: ModelSpec, pp_params: StageParams, x: torch.Tensor, rot,
                  k_pages, v_pages, block_tables, seq_lens, dst_page, dst_off):
    """One stage's layers over one microbatch ``x [Bm, d]``: per layer the
    new K/V rows go into the stage pools through ``kv_write`` (all-gathered
    over dp first: every replica applies every replica's rows), then
    ``paged_attention_v3`` reads them back. Returns the activations."""
    from dynamo_tpu_torch.ops.cuda.kv_write import kv_write

    mesh, lp = pp_params.mesh, pp_params.layers
    Bm = x.shape[0]
    dp = mesh.shape["dp"] > 1
    if dp:
        dst_page = mesh.all_gather(dst_page, 0, over="dp")
        dst_off = mesh.all_gather(dst_off, 0, over="dp")
    for i in range(pp_params.n_local):
        h = rms_norm(x, lp["attn_norm"][i], spec.rms_eps)
        q, k, v = _qkv(spec, lp, i, h, rot)
        if dp:
            k = mesh.all_gather(k, 0, over="dp")
            v = mesh.all_gather(v, 0, over="dp")
        kv_write(k_pages, v_pages, k.contiguous(), v.contiguous(), dst_page, dst_off,
                 layer=i)
        attn = paged_decode_attention_auto(q.contiguous(), k_pages[i], v_pages[i],
                                           block_tables, seq_lens)
        x = x + mesh.all_reduce(attn.reshape(Bm, -1) @ lp["wo"][i])
        x = x + _mlp(lp, i, rms_norm(x, lp["mlp_norm"][i], spec.rms_eps), mesh)
    return x


def _stage_prefill(spec: ModelSpec, pp_params: StageParams, x: torch.Tensor, rot,
                   positions, k_pages, v_pages, safe_pg, num_tokens: int):
    """One stage's layers over a whole cold prompt ``x [T, d]``: page-tile
    K/V writes to ``safe_pg`` (all trash on a bubble tick), causal
    self-attention. The pp form of ``llama.prefill_forward``."""
    mesh, lp = pp_params.mesh, pp_params.layers
    T = x.shape[0]
    page_size = k_pages.shape[3]
    for i in range(pp_params.n_local):
        h = rms_norm(x, lp["attn_norm"][i], spec.rms_eps)
        q, k, v = _qkv(spec, lp, i, h, rot)
        k_pages[i, safe_pg] = page_tiles(k, page_size)
        v_pages[i, safe_pg] = page_tiles(v, page_size)
        attn = causal_attention(q, k, v, positions, num_tokens)
        x = x + mesh.all_reduce(attn.reshape(T, -1) @ lp["wo"][i])
        x = x + _mlp(lp, i, rms_norm(x, lp["mlp_norm"][i], spec.rms_eps), mesh)
    return x


def _logits_local(spec: ModelSpec, pp_params: StageParams, x: torch.Tensor) -> torch.Tensor:
    """Final norm and head in f32: a tied head is the whole embedding, an
    untied one's tp columns are all-gathered."""
    xn = rms_norm(x, pp_params.final_norm, spec.rms_eps)
    if spec.tie_embeddings:
        return (xn @ pp_params.embed.T).float()
    return pp_params.mesh.all_gather((xn @ pp_params.lm_head).float(), -1)


def pp_decode_step(
    spec: ModelSpec,
    pp_params: StageParams,
    tokens: torch.Tensor,  # [B] int
    block_tables: torch.Tensor,  # [B, P] int32
    seq_lens: torch.Tensor,  # [B] int32, INCLUDING the new token
    k_pages: torch.Tensor,  # this rank's stage pools (updated in place)
    v_pages: torch.Tensor,
    active: torch.Tensor,  # [B] bool
) -> torch.Tensor:
    """One decode step of the whole batch through the pipeline (every rank
    of the mesh calls it with the same arguments). Returns the logits [B,
    V] f32 on every rank. The batch must divide over dp, and each dp shard
    over pp; the layers over pp; the pools must be plain tensors."""
    mesh = pp_params.mesh
    _check(spec, k_pages, mesh)
    S, dp = mesh.shape["pp"], mesh.shape["dp"]
    B = tokens.shape[0]
    if B % dp or (B // dp) % S:
        raise ValueError(f"batch {B}/dp={dp} must divide pp={S}")
    dev = k_pages.device
    page_size = k_pages.shape[3]
    tokens, block_tables = tokens.to(dev), block_tables.to(dev, torch.int32)
    seq_lens, active = seq_lens.to(dev, torch.int32), active.to(dev)
    positions = seq_lens.long() - 1
    page_idx = torch.gather(block_tables.long(), 1, (positions // page_size)[:, None])[:, 0]
    dst_page = torch.where(active, page_idx, TRASH_PAGE).to(torch.int32)
    dst_off = (positions % page_size).to(torch.int32)
    Bl = B // dp
    mb = Bl // S
    rows = slice(mesh.coords["dp"] * Bl, (mesh.coords["dp"] + 1) * Bl)

    def micro(t):  # this dp shard's rows as [S, mb, ...] microbatches
        return t[rows].reshape(S, mb, *t.shape[1:])

    embs = micro(pp_params.embed[tokens.long()])
    pos_m, bt_m, len_m = micro(positions), micro(block_tables), micro(seq_lens)
    pg_m, off_m = micro(dst_page), micro(dst_off)
    rots = [rope_tables(spec, pos_m[j]) for j in range(S)]
    s = mesh.coords["pp"]
    state = torch.zeros_like(embs[0])
    outs = torch.zeros_like(embs)
    for t in range(2 * S - 1):
        j = t - s  # this stage's microbatch at tick t
        jc = min(max(j, 0), S - 1)
        valid = 0 <= j < S
        x_in = embs[t] if s == 0 and t < S else state
        page = pg_m[jc] if valid else torch.full_like(pg_m[jc], TRASH_PAGE)
        x_out = _stage_decode(spec, pp_params, x_in, rots[jc], k_pages, v_pages,
                              bt_m[jc].contiguous(), len_m[jc].contiguous(),
                              page.contiguous(), off_m[jc].contiguous())
        if s == S - 1 and valid:
            outs[jc] = x_out
        if t < 2 * S - 2:
            state = mesh.ppermute(x_out, "pp")
    # the last stage holds the finished activations
    outs = mesh.broadcast(outs, "pp", S - 1)
    logits = _logits_local(spec, pp_params, outs.reshape(Bl, -1))
    return mesh.all_gather(logits, 0, over="dp")


def pp_prefill(
    spec: ModelSpec,
    pp_params: StageParams,
    tokens: torch.Tensor,  # [T] int, a whole number of pages
    block_table: torch.Tensor,  # [max_pages_per_seq] int32
    k_pages: torch.Tensor,  # this rank's stage pools (updated in place)
    v_pages: torch.Tensor,
    num_tokens: int,  # real token count
) -> torch.Tensor:
    """A cold prompt's prefill through the pipeline: one microbatch, fill
    and drain (``pp`` ticks; a stage writes its pages on its own tick and
    the trash page on the others). Returns the last real token's logits
    [V] f32 on every rank."""
    mesh = pp_params.mesh
    _check(spec, k_pages, mesh)
    S = mesh.shape["pp"]
    dev = k_pages.device
    T = tokens.shape[0]
    page_size = k_pages.shape[3]
    n_pg = T // page_size
    page_starts = torch.arange(n_pg, device=dev) * page_size
    pg_idx = block_table.to(dev).long()[page_starts // page_size]
    base_pg = torch.where(page_starts < num_tokens, pg_idx, TRASH_PAGE)
    trash = torch.full_like(base_pg, TRASH_PAGE)
    positions = torch.arange(T, device=dev)
    rot = rope_tables(spec, positions)
    emb = pp_params.embed[tokens.to(dev).long()]
    s = mesh.coords["pp"]
    state = torch.zeros_like(emb)
    out = torch.zeros_like(emb)
    for t in range(S):
        x_in = emb if s == 0 and t == 0 else state
        x_out = _stage_prefill(spec, pp_params, x_in, rot, positions, k_pages, v_pages,
                               base_pg if t == s else trash, num_tokens)
        if s == S - 1 and t == S - 1:
            out = x_out
        if t < S - 1:
            state = mesh.ppermute(x_out, "pp")
    out = mesh.broadcast(out, "pp", S - 1)
    last = min(max(num_tokens - 1, 0), T - 1)
    return _logits_local(spec, pp_params, out[last])
