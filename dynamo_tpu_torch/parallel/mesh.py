"""The mesh of one engine: its tensor- and expert-parallel groups (the
counterpart of dynamo_tpu/parallel/mesh.py).

The reference folds local devices into a ``jax.sharding.Mesh`` with axes
``("dp", "pp", "sp", "ep", "tp")`` and lets GSPMD insert the collectives.
PyTorch runs one process per card: a mesh here is this rank's place in a
``torch.distributed`` world of ``dp * pp * sp * ep * tp`` ranks, its
device and its process groups, and the model calls the collectives itself
(models/llama.py, models/mla.py, models/moe.py). The axis order stays the
reference's, ``tp`` innermost. ``tp`` and ``ep`` are ported: every other
axis above 1 raises, naming the ROADMAP item that ports it.

Groups. ``tp``: the ``tp`` ranks of this rank's ep slice (attention
heads, dense FFN columns, the embedding's d and an untied head's
vocabulary); the whole world when ep is 1. ``expert``: the ``ep * tp``
ranks that hold one copy of every expert (experts over ep, their FFN
columns over tp); the whole world while dp, pp and sp are 1. Every rank
creates every group, in the same order (``dist.new_group``).

Collectives: the partial sums of the row-parallel matmuls (``wo``,
``w_down``, a tied lm head, the experts' combine) are all-reduced in f32,
on NCCL and on gloo alike, and rounded to the model dtype once after the
sum; gathers move the values as they are. gloo has no all-gather of CUDA
tensors, and its CUDA all-reduce differs by build, so a gloo group over
CUDA tensors (several ranks on one card, where NCCL refuses) stages every
collective through pinned host memory: a host round trip per collective,
and no CUDA graph can capture it (engine/graphs.py refuses the capture).
A tp group of one rank inside a wider world (tp=1 under ep) runs no
collective.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

AXES = ("dp", "pp", "sp", "ep", "tp")
# the ROADMAP items that port the other axes
AXIS_ITEMS = {
    "pp": "ROADMAP Queue A item 11c (pipeline parallelism)",
    "sp": "ROADMAP Queue A item 11d (sequence-parallel ring prefill)",
    "dp": "ROADMAP Queue A item 11d (data parallelism)",
}


def _zero_stats() -> dict:
    return dict(calls=0, captured=0, bytes=0, secs=0.0)


@dataclass
class Mesh:
    """This rank's view of the mesh: axis sizes (``shape``, in ``AXES``
    order), its coordinates, its device, its ``tp`` process group
    (``group``) and ``expert`` group with their backend. ``stats`` counts
    the collectives issued over all groups (``calls``, those issued under
    CUDA-graph capture as ``captured``, the ``bytes`` each rank
    contributed) and the host seconds spent in them (``secs``: the whole
    collective when it is staged, the launch alone on NCCL);
    ``group_stats`` the same per group name."""

    shape: dict[str, int]
    coords: dict[str, int]
    device: torch.device
    group: object = None
    backend: str = "gloo"
    rank: int = 0  # global rank
    expert_group: object = None
    stats: dict = field(default_factory=_zero_stats)
    group_stats: dict = field(default_factory=lambda: {"tp": _zero_stats(),
                                                       "expert": _zero_stats()})
    _pinned: dict = field(default_factory=dict, repr=False)

    def _note(self, over: str, t: torch.Tensor, t0: float) -> None:
        secs = time.perf_counter() - t0
        captured = t.is_cuda and torch.cuda.is_current_stream_capturing()
        for st in (self.stats, self.group_stats[over]):
            st["calls"] += 1
            st["bytes"] += t.nbytes
            st["secs"] += secs
            st["captured"] += int(captured)

    @property
    def tp(self) -> int:
        return self.shape["tp"]

    @property
    def tp_rank(self) -> int:
        return self.coords["tp"]

    @property
    def ep(self) -> int:
        return self.shape["ep"]

    @property
    def ep_rank(self) -> int:
        return self.coords["ep"]

    @property
    def distributed(self) -> bool:
        """True when the forwards run collectives: a process group exists
        (a group of one rank in a world of one still runs them, as NCCL
        kernels a graph can capture)."""
        return self.group is not None or self.expert_group is not None

    @property
    def staged(self) -> bool:
        """True when the collectives round-trip through host memory (gloo
        over CUDA tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def capturable(self) -> bool:
        """True when a CUDA graph can capture this mesh's collectives
        (NCCL's can; gloo's cannot)."""
        return self.backend == "nccl"

    def shard(self, n: int, what: str = "axis", axis: str = "tp") -> slice:
        """This rank's contiguous slice of an axis of ``n`` along mesh axis
        ``axis`` (``tp`` or ``ep``)."""
        size = self.shape[axis]
        if n % size:
            raise ValueError(f"{what} of {n} does not divide over {axis}={size}")
        k = n // size
        return slice(self.coords[axis] * k, (self.coords[axis] + 1) * k)

    # -- collectives -------------------------------------------------------

    def _group(self, over: str):
        if over not in ("tp", "expert"):
            raise ValueError(f"group {over!r}: tp or expert")
        return self.group if over == "tp" else self.expert_group

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer holding ``x`` (gloo staging)."""
        key = (x.shape, x.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._pinned[key] = buf
        buf.copy_(x)
        return buf

    def all_reduce(self, x: torch.Tensor, over: str = "tp") -> torch.Tensor:
        """The sum of ``x`` over the ranks of group ``over`` (``tp`` or
        ``expert``), reduced in f32 and returned in ``x``'s dtype.
        Identical on every rank of the group."""
        import torch.distributed as dist

        group = self._group(over)
        if group is None:
            return x
        t0 = time.perf_counter()
        acc = x.float().contiguous()
        if self.staged:
            h = self._host(acc)
            dist.all_reduce(h, group=group)
            acc = h.to(x.device)
        else:
            dist.all_reduce(acc, group=group)
        self._note(over, acc, t0)
        return acc.to(x.dtype)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The tp ranks' ``x`` concatenated along ``dim`` in rank order."""
        import torch.distributed as dist

        if self.group is None:
            return x
        t0 = time.perf_counter()
        dim = dim % x.dim()
        # gather along a leading axis (contiguous chunks), then move it
        src = x.movedim(dim, 0).contiguous()
        shape = (self.tp * src.shape[0],) + tuple(src.shape[1:])
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        if self.staged:
            h = self._host(src)
            ho = torch.empty(shape, dtype=x.dtype)
            dist.all_gather_into_tensor(ho, h, group=self.group)
            out.copy_(ho)
        else:
            dist.all_gather_into_tensor(out, src, group=self.group)
        self._note("tp", src, t0)
        return out.movedim(0, dim)


def make_mesh(
    tp: int = 1,
    dp: int = 1,
    sp: int = 1,
    ep: int = 1,
    pp: int = 1,
    devices: list | None = None,
) -> Mesh:
    """This rank's mesh over the initialised ``torch.distributed`` world
    (parallel/multihost.py ``initialize_multihost``). ``devices`` lists
    the device of each local rank (default ``cuda:<local rank>`` on a GPU
    host; the CPU under gloo). Raises when dp, pp or sp exceeds 1, or when
    the world is not ``tp * dp * sp * ep * pp`` ranks. Every rank must call
    it, in the same order as its other group creations: it makes the tp
    group of each ep slice."""
    import torch.distributed as dist

    sizes = {"dp": dp, "pp": pp, "sp": sp, "ep": ep, "tp": tp}
    for name, n in sizes.items():
        if n < 1:
            raise ValueError(f"mesh axis {name}={n} must be >= 1")
        if name not in ("tp", "ep") and n > 1:
            raise NotImplementedError(
                f"mesh axis {name}={n}: the port shards only tp and ep; {name} is "
                f"{AXIS_ITEMS[name]}")
    need = tp * dp * sp * ep * pp
    if not dist.is_initialized():
        if need == 1:
            dev = torch.device(devices[0]) if devices else torch.device("cpu")
            return Mesh(sizes, dict.fromkeys(AXES, 0), dev)
        raise RuntimeError(
            f"a mesh of {need} ranks needs torch.distributed initialised "
            "(parallel/multihost.initialize_multihost) with that world size")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(
            f"mesh needs {need} ranks (dp={dp} pp={pp} sp={sp} ep={ep} "
            f"tp={tp}), the torch.distributed world has {world}")
    rank = dist.get_rank()
    coords = {}
    rem = rank
    for name in reversed(AXES):  # tp innermost, as the reference's reshape
        coords[name] = rem % sizes[name]
        rem //= sizes[name]
    from dynamo_tpu_torch.parallel.multihost import local_device

    dev = (torch.device(devices[rank % len(devices)]) if devices
           else local_device())
    # dp, pp and sp are 1: the world is one expert group of ep x tp ranks
    tp_group = expert_group = dist.group.WORLD
    if ep > 1:
        tp_group = None
        for e in range(ep if tp > 1 else 0):  # every rank makes every group, in order
            g = dist.new_group(list(range(e * tp, (e + 1) * tp)))
            if e == coords["ep"]:
                tp_group = g
    return Mesh(sizes, coords, dev, group=tp_group, backend=dist.get_backend(),
                rank=rank, expert_group=expert_group)
