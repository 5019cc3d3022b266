"""Ring attention: causal self-attention with the sequence split over the
mesh's ``sp`` ranks (the counterpart of dynamo_tpu/parallel/ring.py).

Each of the ``sp`` ranks holds one contiguous chunk of Q, K and V along
the token axis: rank ``i`` the tokens ``[i * Tl, (i + 1) * Tl)``. It runs
``sp`` blockwise steps of its local queries against the K/V chunk it holds,
with an f32 online (flash-style) softmax, and rotates K/V one hop around
the ring between steps (``Mesh.ppermute`` over ``sp``: after ``s``
rotations a rank holds the chunk that started on rank ``i - s``). Chunks
are identified by their origin, so the causal mask uses absolute
positions, and the accumulation order of a query is fixed by origin, not
by arrival. Heads are the rank's own tp heads. At ``sp`` 1 it is
``causal_attention``, as in the reference. It runs in plain torch ops: the
reference computes it in XLA, not Pallas.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from dynamo_tpu_torch.ops.attention import NEG_INF, causal_attention, repeat_kv


def ring_attention(
    q: torch.Tensor,  # [Tl, H, D] this rank's query chunk
    k: torch.Tensor,  # [Tl, KH, D] this rank's key chunk
    v: torch.Tensor,  # [Tl, KH, D]
    mesh,
    axis: str = "sp",
    on_chunk: Callable[[int, torch.Tensor, torch.Tensor], None] | None = None,
) -> torch.Tensor:
    """This rank's chunk of causal self-attention over the whole sequence,
    ``[Tl, H, D]`` in ``q``'s dtype. ``on_chunk(src, k, v)`` sees every
    chunk as it arrives (``src`` its origin), this rank's own first: the
    whole prompt's K/V passes through every rank. Padding must sit at the
    end of the sequence: padded keys have positions past every real query,
    so causality masks them."""
    sp = mesh.shape[axis] if mesh is not None else 1
    Tl = q.shape[0]
    if sp == 1:
        if on_chunk is not None:
            on_chunk(0, k, v)
        pos = torch.arange(Tl, device=q.device)
        return causal_attention(q, k, v, pos, Tl)
    idx = mesh.coords[axis]
    H, D = q.shape[1], q.shape[2]
    n_rep = H // k.shape[1]
    q_pos = idx * Tl + torch.arange(Tl, device=q.device)  # absolute positions
    scale = 1.0 / math.sqrt(D)
    qf = q.float()
    acc = torch.zeros((Tl, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((H, Tl), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((H, Tl), dtype=torch.float32, device=q.device)
    kc, vc = k, v
    for step in range(sp):
        src = (idx - step) % sp  # the chunk's origin after `step` rotations
        if on_chunk is not None:
            on_chunk(src, kc, vc)
        k_pos = src * Tl + torch.arange(Tl, device=q.device)
        kr = repeat_kv(kc, n_rep).float()
        vr = repeat_kv(vc, n_rep).float()
        logits = torch.einsum("thd,shd->hts", qf, kr) * scale  # [H, Tl, Sl]
        mask = k_pos[None, :] <= q_pos[:, None]  # [Tl, Sl] causal
        logits = torch.where(mask[None], logits, NEG_INF)
        # online softmax update (step 0 holds the self-visible diagonal, so
        # m is finite from the first update on)
        new_m = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - new_m)  # [H, Tl]
        p = torch.exp(logits - new_m[:, :, None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr.T[:, :, None] + torch.einsum("hts,shd->thd", p, vr)
        m = new_m
        if step < sp - 1:
            kc = mesh.ppermute(kc, axis)
            vc = mesh.ppermute(vc, axis)
    out = acc / torch.clamp(l.T[:, :, None], min=1e-30)
    return out.to(q.dtype)
