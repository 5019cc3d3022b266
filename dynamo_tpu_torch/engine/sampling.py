"""On-device token sampling (counterpart of dynamo_tpu/engine/sampling.py).

Sampling runs where the logits are, so only the sampled ids [B] cross to the
host each step. The per-row parameters (temperature, top_k, top_p, seeds,
steps) are host tensors: the engine knows them on the host, so deciding
which stages a batch needs costs no device sync.

Each stage (top-k mask, top-p mask, random draw) runs only when some row
asks for it: the masks sort the whole vocabulary per row, so an all-greedy
batch pays only the argmax. Greedy is exactly ``argmax`` (first maximum).

Random draws are Gumbel-max over noise from a ``torch.Generator`` seeded by
(seed, step) per row, so a request with an explicit seed reproduces its
stream whatever else shares the batch. The bits differ from the JAX
package's threefry stream.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
_MIX = 0x9E3779B97F4A7C15  # odd 64-bit constant: (seed, step) -> one seed


def _row_seed(seed: int, step: int) -> int:
    return ((seed & 0xFFFFFFFF) * _MIX + (step & 0xFFFFFFFF)) & (2**63 - 1)


def _apply_top_k(logits: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Keep each row's top-k logits (k == 0: row unchanged)."""
    k = top_k.to(logits.device).long()
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = sorted_desc.gather(1, (k.clamp(min=1) - 1)[:, None])
    drop = (k[:, None] > 0) & (logits < kth)
    return torch.where(drop, NEG_INF, logits)


def _apply_top_p(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus mask: keep tokens whose exclusive cumulative probability
    is below p (p == 1.0: row unchanged)."""
    p = top_p.to(logits.device).float()
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff = ((cum - probs) < p[:, None]).sum(dim=-1)
    kth = sorted_desc.gather(1, (cutoff.clamp(min=1) - 1)[:, None])
    drop = (p[:, None] < 1.0) & (logits < kth)
    return torch.where(drop, NEG_INF, logits)


def _draw(logits: torch.Tensor, temperature: torch.Tensor, seeds: torch.Tensor,
          steps: torch.Tensor, rows: list[int]) -> torch.Tensor:
    """Gumbel-max draws for ``rows``; other rows return -1."""
    B, V = logits.shape
    out = torch.full((B,), -1, dtype=torch.long, device=logits.device)
    gen = torch.Generator(device=logits.device)
    for i in rows:
        gen.manual_seed(_row_seed(int(seeds[i]), int(steps[i])))
        u = torch.rand(V, generator=gen, device=logits.device)
        u = u.clamp(min=torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
        temp = max(float(temperature[i]), 1e-6)
        out[i] = torch.argmax(logits[i] / temp + gumbel)
    return out


def sample_tokens(
    logits: torch.Tensor,  # [B, V] f32 (on the device)
    temperature: torch.Tensor,  # [B] host f32
    top_k: torch.Tensor,  # [B] host int (0 = off)
    top_p: torch.Tensor,  # [B] host f32 (1.0 = off)
    seeds: torch.Tensor,  # [B] host int: per-request sampling seed
    steps: torch.Tensor,  # [B] host int: tokens generated so far
) -> torch.Tensor:
    """Returns sampled token ids [B] int32 on the logits' device."""
    greedy = torch.argmax(logits, dim=-1)
    sampled_rows = [i for i in range(logits.shape[0]) if float(temperature[i]) > 0.0]
    if not sampled_rows:
        return greedy.to(torch.int32)
    lg = logits
    if bool((top_k > 0).any()):
        lg = _apply_top_k(lg, top_k)
    if bool((top_p < 1.0).any()):
        lg = _apply_top_p(lg, top_p)
    drawn = _draw(lg, temperature, seeds, steps, sampled_rows)
    use = (temperature > 0.0).to(logits.device)
    return torch.where(use, drawn, greedy).to(torch.int32)
