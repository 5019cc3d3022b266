"""The mesh of one engine: its tensor-, expert-, pipeline-, sequence- and
data-parallel groups (the counterpart of dynamo_tpu/parallel/mesh.py).

The reference folds local devices into a ``jax.sharding.Mesh`` with axes
``("dp", "pp", "sp", "ep", "tp")`` and lets GSPMD insert the collectives.
PyTorch runs one process per card: a mesh here is this rank's place in a
``torch.distributed`` world of ``dp * pp * sp * ep * tp`` ranks, its
device and its process groups, and the model calls the collectives itself
(models/llama.py, models/mla.py, models/moe.py, parallel/ring.py,
parallel/pipeline.py). Ranks take their coordinates in the reference's
reshape order, ``np.arange(world).reshape(dp, pp, sp, ep, tp)``: ``tp``
innermost.

Groups, one per coordinate of the other axes. ``tp``: the ``tp`` ranks of
this rank's ``(dp, pp, sp, ep)`` coordinate (attention heads, dense FFN
columns, the embedding's d and an untied head's vocabulary). ``expert``:
the ``ep * tp`` ranks of its ``(dp, pp, sp)`` coordinate, which hold one
copy of every expert (experts over ep, their FFN columns over tp); never
wider, or a replica's combine would be summed into another's. ``pp``,
``sp`` and ``dp``: the ranks along that axis (pipeline stages, the ring's
sequence chunks, the replicas of a batch shard). A group that is the
whole world is ``WORLD``; a group of one rank inside a wider world is
None and runs no collective. Every rank creates every group, in the same
order (``dist.new_group``).

Collectives: the partial sums of the row-parallel matmuls (``wo``,
``w_down``, a tied lm head, the experts' combine) are all-reduced in f32,
on NCCL and on gloo alike, and rounded to the model dtype once after the
sum; gathers, broadcasts and the ring's point-to-point sends
(``ppermute``, the reference's cyclic ``lax.ppermute``) move the values as
they are. gloo has no CUDA send, receive or all-gather, and its CUDA
all-reduce differs by build, so a gloo group over CUDA tensors (several
ranks on one card, where NCCL refuses) stages every collective through
pinned host memory: a host round trip per collective, and no CUDA graph
can capture it (engine/graphs.py refuses the capture).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

AXES = ("dp", "pp", "sp", "ep", "tp")
# the process groups of a mesh: one per axis, and the experts' ep x tp group
GROUPS = ("tp", "expert", "pp", "sp", "dp")


def _zero_stats() -> dict:
    return dict(calls=0, captured=0, bytes=0, secs=0.0)


def rank_grid(shape: dict[str, int]) -> np.ndarray:
    """Global ranks laid out over the axes, ``[dp, pp, sp, ep, tp]``: the
    reference's reshape of the device list."""
    return np.arange(int(np.prod([shape[a] for a in AXES]))).reshape(
        [shape[a] for a in AXES])


def group_members(shape: dict[str, int], over: str) -> list[list[int]]:
    """Every group of kind ``over`` as lists of global ranks, in creation
    order (the other axes' coordinates in row-major order): ``tp``, ``pp``,
    ``sp`` and ``dp`` along their axis, ``expert`` along ep and tp."""
    grid = rank_grid(shape)
    axes = ("ep", "tp") if over == "expert" else (over,)
    keep = [AXES.index(a) for a in axes]
    rest = [i for i in range(len(AXES)) if i not in keep]
    moved = np.transpose(grid, rest + keep)
    return moved.reshape(-1, int(np.prod([shape[a] for a in axes]))).tolist()


@dataclass
class Mesh:
    """This rank's view of the mesh: axis sizes (``shape``, in ``AXES``
    order), its coordinates, its device, its ``tp`` process group
    (``group``), its ``expert`` group and its ``pp`` / ``sp`` / ``dp``
    groups (``groups``) with their backend. ``stats`` counts the
    collectives issued over all groups (``calls``, those issued under
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
    groups: dict = field(default_factory=dict)  # "pp" / "sp" / "dp" -> group
    stats: dict = field(default_factory=_zero_stats)
    group_stats: dict = field(default_factory=lambda: {g: _zero_stats() for g in GROUPS})
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
        return (self.group is not None or self.expert_group is not None
                or any(g is not None for g in self.groups.values()))

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
        ``axis`` (``tp``, ``ep``, or ``pp``: a stage's layers)."""
        size = self.shape[axis]
        if n % size:
            raise ValueError(f"{what} of {n} does not divide over {axis}={size}")
        k = n // size
        return slice(self.coords[axis] * k, (self.coords[axis] + 1) * k)

    def size(self, over: str) -> int:
        """Ranks in this rank's group ``over``."""
        return self.shape["ep"] * self.shape["tp"] if over == "expert" else self.shape[over]

    def peer(self, axis: str, coord: int) -> int:
        """The global rank at ``coord`` along ``axis``, this rank's other
        coordinates kept."""
        return int(rank_grid(self.shape)[tuple(
            coord % self.shape[a] if a == axis else self.coords[a] for a in AXES)])

    # -- collectives -------------------------------------------------------

    def _group(self, over: str):
        if over == "tp":
            return self.group
        if over == "expert":
            return self.expert_group
        if over in ("pp", "sp", "dp"):
            return self.groups.get(over)
        raise ValueError(f"group {over!r}: one of {GROUPS}")

    def _pinned_buf(self, shape, dtype, tag: str) -> torch.Tensor:
        """A reused pinned host buffer per (shape, dtype, tag)."""
        key = (tuple(shape), dtype, tag)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _host(self, x: torch.Tensor, tag: str = "") -> torch.Tensor:
        """A pinned host buffer holding ``x`` (gloo staging); ``tag`` keeps
        buffers of one shape apart (a send's and a receive's)."""
        return self._pinned_buf(x.shape, x.dtype, tag).copy_(x)

    def all_reduce(self, x: torch.Tensor, over: str = "tp") -> torch.Tensor:
        """The sum of ``x`` over the ranks of group ``over``, reduced in f32
        and returned in ``x``'s dtype. Identical on every rank of the
        group."""
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

    def all_gather(self, x: torch.Tensor, dim: int = -1, over: str = "tp") -> torch.Tensor:
        """The ranks' ``x`` of group ``over`` concatenated along ``dim`` in
        their order along the axis."""
        import torch.distributed as dist

        group = self._group(over)
        if group is None:
            return x
        t0 = time.perf_counter()
        dim = dim % x.dim()
        # gather along a leading axis (contiguous chunks), then move it
        src = x.movedim(dim, 0).contiguous()
        shape = (self.size(over) * src.shape[0],) + tuple(src.shape[1:])
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        if self.staged:
            h = self._host(src)
            ho = torch.empty(shape, dtype=x.dtype)
            dist.all_gather_into_tensor(ho, h, group=group)
            out.copy_(ho)
        else:
            dist.all_gather_into_tensor(out, src, group=group)
        self._note(over, src, t0)
        return out.movedim(0, dim)

    def broadcast(self, x: torch.Tensor, over: str, src: int) -> torch.Tensor:
        """``x`` of the rank at coordinate ``src`` along ``over`` (``pp``,
        ``sp`` or ``dp``), on every rank of the group; the others' ``x``
        gives only the shape and dtype."""
        import torch.distributed as dist

        group = self._group(over)
        if group is None:
            return x
        t0 = time.perf_counter()
        root = self.peer(over, src)
        buf = x.contiguous().clone()
        if self.staged:
            h = self._host(buf, "bcast")
            dist.broadcast(h, src=root, group=group)
            buf.copy_(h)
        else:
            dist.broadcast(buf, src=root, group=group)
        self._note(over, buf, t0)
        return buf

    def ppermute(self, x: torch.Tensor, over: str, shift: int = 1) -> torch.Tensor:
        """The reference's cyclic ``lax.ppermute`` along ``over``: this
        rank sends ``x`` to coordinate ``c + shift`` and returns what
        coordinate ``c - shift`` sent it (``dist.batch_isend_irecv``)."""
        import torch.distributed as dist

        group = self._group(over)
        n = self.size(over)
        if group is None or shift % n == 0:
            return x
        t0 = time.perf_counter()
        c = self.coords[over]
        dst, src = self.peer(over, c + shift), self.peer(over, c - shift)
        send = x.contiguous()
        if self.staged:
            send = self._host(send, "send")
            recv = self._pinned_buf(send.shape, x.dtype, "recv")
        else:
            recv = torch.empty_like(send)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, group=group),
            dist.P2POp(dist.irecv, recv, src, group=group)])
        for r in reqs:
            r.wait()
        self._note(over, send, t0)
        return recv.to(x.device) if self.staged else recv


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
    host; the CPU under gloo). Raises when the world is not ``tp * dp * sp
    * ep * pp`` ranks. Every rank must call it, in the same order as its
    other group creations: it makes every group of every kind
    (``group_members``), in ``GROUPS`` order."""
    import torch.distributed as dist

    sizes = {"dp": dp, "pp": pp, "sp": sp, "ep": ep, "tp": tp}
    for name, n in sizes.items():
        if n < 1:
            raise ValueError(f"mesh axis {name}={n} must be >= 1")
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
    coords = dict(zip(AXES, (int(c) for c in np.argwhere(rank_grid(sizes) == rank)[0])))
    from dynamo_tpu_torch.parallel.multihost import local_device

    dev = (torch.device(devices[rank % len(devices)]) if devices
           else local_device())
    mine = {}
    for over in GROUPS:  # every rank makes every group, in this order
        members = group_members(sizes, over)
        if len(members[0]) == world:
            mine[over] = dist.group.WORLD
            continue
        mine[over] = None
        if len(members[0]) == 1:
            continue  # a group of one rank runs no collective
        for ranks in members:
            g = dist.new_group(ranks)
            if rank in ranks:
                mine[over] = g
    return Mesh(sizes, coords, dev, group=mine["tp"], backend=dist.get_backend(),
                rank=rank, expert_group=mine["expert"],
                groups={a: mine[a] for a in ("pp", "sp", "dp")})
