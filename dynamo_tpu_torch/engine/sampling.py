"""On-device token sampling (counterpart of dynamo_tpu/engine/sampling.py).

Sampling runs where the logits are, so only the sampled ids [B] cross to the
host each step. Nothing here reads a device value on the host: every
function can be captured in a CUDA graph. The caller decides on the host
whether a batch is all greedy (``greedy_tokens``, exactly ``argmax``, first
maximum) or has sampled rows (``sample_tokens``, which computes every row
and keeps the argmax for rows with temperature <= 0).

``sample_tokens`` runs the top-k and top-p masks on every row. A row with
``k == 0`` or ``p == 1.0`` passes through its mask unchanged, so this equals
the JAX sampler, which skips a mask (``lax.cond``) when no row needs it.

The random draw is JAX's, bit for bit: per row, ``key = fold_in(
PRNGKey(seed), step)``, uniform bits from threefry-2x32 in JAX's
partitionable layout (``jax_threefry_partitionable=True``: the counter of
vocabulary entry ``i`` is the 64-bit ``i`` split into (hi, lo) words, and
the bits are the two output words xor'ed), a uniform on ``[tiny, 1)`` from
the top 23 bits, ``gumbel = -log(-log(u))`` (JAX's low-range Gumbel), and
``argmax(logits / max(t, 1e-6) + gumbel)``. The threefry rounds run on
int64 tensors holding uint32 values, masked after every add and shift, so
they run wherever torch runs. A request with an explicit seed therefore
gets the same stream from this engine as from the JAX one, whatever else
shares the batch. Only ``log`` may differ by an ulp between the two
backends, which moves a draw only on an exact near-tie.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA  # threefry key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny
_ONE_BITS = 0x3F800000  # f32 1.0


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (jax._src.prng._threefry2x32_lowering).
    Every argument is an int64 tensor (or int) holding uint32 values; the
    four broadcast together. Returns the two output words, int64 in
    [0, 2**32)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def fold_in_keys(seeds: torch.Tensor, steps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row ``fold_in(PRNGKey(seed), step)``: PRNGKey of a 32-bit seed
    is the key (0, seed); fold_in hashes the counter pair (0, step) under
    it. Seeds and steps are taken modulo 2**32 (JAX's uint32 view)."""
    seed = seeds.long() & _M32
    step = steps.long() & _M32
    return threefry2x32(torch.zeros_like(seed), seed, torch.zeros_like(step), step)


def random_bits(keys: tuple[torch.Tensor, torch.Tensor], n: int) -> torch.Tensor:
    """32-bit random words [B, n] per key, as ``jax.random.bits(key, (n,))``
    with partitionable threefry: counter i = (0, i), bits = y1 ^ y2."""
    k1, k2 = keys
    idx = torch.arange(n, device=k1.device, dtype=torch.int64)[None, :]
    y1, y2 = threefry2x32(k1[:, None], k2[:, None], torch.zeros_like(idx), idx)
    return y1 ^ y2


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """JAX's ``_uniform`` on [tiny, 1): the top 23 bits as the mantissa of
    a float in [1, 2), minus 1, then ``max(tiny, f * (1 - tiny) + tiny)``
    (1 - tiny rounds to 1 in f32)."""
    f = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f + _TINY, _TINY)


def gumbel_noise(seeds: torch.Tensor, steps: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] f32 Gumbel draws of ``jax.random.gumbel(fold_in(PRNGKey(
    seed), step), (n,))`` (mode "low")."""
    u = uniform_from_bits(random_bits(fold_in_keys(seeds, steps), n))
    return -torch.log(-torch.log(u))


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


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy ids [B] int32: argmax, first maximum."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_tokens(
    logits: torch.Tensor,  # [B, V] f32
    temperature: torch.Tensor,  # [B] f32
    top_k: torch.Tensor,  # [B] int (0 = off)
    top_p: torch.Tensor,  # [B] f32 (1.0 = off)
    seeds: torch.Tensor,  # [B] int: per-request sampling seed (uint32 view)
    steps: torch.Tensor,  # [B] int: tokens generated so far (fold-in)
) -> torch.Tensor:
    """Sampled ids [B] int32 on the logits' device; rows with temperature
    <= 0 take the argmax. The parameters move to the logits' device (a
    no-op when they are there already, as in a captured graph)."""
    dev = logits.device
    temperature = temperature.to(dev).float()
    greedy = torch.argmax(logits, dim=-1)
    lg = _apply_top_p(_apply_top_k(logits, top_k), top_p)
    temp = torch.clamp_min(temperature, 1e-6)[:, None]
    noise = gumbel_noise(seeds.to(dev), steps.to(dev), logits.shape[-1])
    drawn = torch.argmax(noise + lg / temp, dim=-1)
    return torch.where(temperature <= 0.0, greedy, drawn).to(torch.int32)


def sample_tokens_masked(
    logits: torch.Tensor,  # [B, V] f32
    allowed: torch.Tensor,  # [B, V] bool: per-slot grammar-allowed tokens
    temperature: torch.Tensor,  # [B] f32
    top_k: torch.Tensor,  # [B] int
    top_p: torch.Tensor,  # [B] f32
    seeds: torch.Tensor,  # [B] int
    steps: torch.Tensor,  # [B] int
) -> torch.Tensor:
    """``sample_tokens`` under a guided-decoding mask: disallowed tokens
    drop to NEG_INF before the greedy argmax and before the temperature /
    top-k / top-p pipeline, so every draw lands on a grammar-legal token
    (guided/runtime.py keeps at least one True per constrained row). Free
    slots ride the same batch with all-True rows, for which the mask is
    the identity. NEG_INF, not -inf: an all-False row stays finite in the
    sampler's softmax."""
    return sample_tokens(mask_logits(logits, allowed), temperature, top_k,
                         top_p, seeds, steps)


def mask_logits(logits: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """``logits`` with every position ``allowed`` leaves False at NEG_INF."""
    return torch.where(allowed.to(logits.device), logits, NEG_INF)


def token_logprobs(
    logits: torch.Tensor,  # [B, V] f32
    sampled: torch.Tensor,  # [B] int
    n_top: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Log-probabilities of the sampled tokens plus the top-n alternatives,
    on the device: (sampled_logprob [B] f32, top_ids [B, n] int32,
    top_logprobs [B, n] f32), n = max(n_top, 1) (callers slice). Equal
    values keep the lower id first, as ``jax.lax.top_k`` does (a stable
    sort: a guided mask leaves most of a row tied at NEG_INF, where
    ``torch.topk``'s order is unspecified)."""
    logprobs = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    picked = logprobs.gather(1, sampled.long()[:, None])[:, 0]
    top_v, top_i = torch.sort(logprobs, dim=-1, descending=True, stable=True)
    n = max(n_top, 1)
    return picked, top_i[:, :n].to(torch.int32), top_v[:, :n]
