"""The tensor-parallel mesh of one engine (the counterpart of
dynamo_tpu/parallel/mesh.py).

The reference folds local devices into a ``jax.sharding.Mesh`` with axes
``("dp", "pp", "sp", "ep", "tp")`` and lets GSPMD insert the collectives.
PyTorch runs one process per card: a mesh here is this rank's place in a
``torch.distributed`` world of ``dp * pp * sp * ep * tp`` ranks, its
device and the ``tp`` process group, and the model calls the collectives
itself (models/llama.py). The axis order stays the reference's, ``tp``
innermost. Only ``tp`` is ported: every other axis above 1 raises, naming
the ROADMAP item that ports it.

Collectives: the partial sums of the row-parallel matmuls (``wo``,
``w_down``, a tied lm head) are all-reduced in f32, on NCCL and on gloo
alike, and rounded to the model dtype once after the sum; gathers move the
values as they are. gloo has no all-gather of CUDA tensors, and its CUDA
all-reduce differs by build, so a gloo group over CUDA tensors (two ranks
on one card, where NCCL refuses) stages every collective through pinned
host memory: a host round trip per collective, and no CUDA graph can
capture it (engine/graphs.py refuses the capture).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

AXES = ("dp", "pp", "sp", "ep", "tp")
# the ROADMAP items that port the other axes
AXIS_ITEMS = {
    "ep": "ROADMAP Queue A item 11b (expert parallelism)",
    "pp": "ROADMAP Queue A item 11c (pipeline parallelism)",
    "sp": "ROADMAP Queue A item 11d (sequence-parallel ring prefill)",
    "dp": "ROADMAP Queue A item 11d (data parallelism)",
}


@dataclass
class Mesh:
    """This rank's view of the mesh: axis sizes (``shape``, in ``AXES``
    order), its coordinates, its device and the ``tp`` process group with
    its backend. ``stats`` counts the collectives issued (``calls``, those
    issued under CUDA-graph capture as ``captured``, the ``bytes`` each
    rank contributed) and the host seconds spent in them (``secs``: the
    whole collective when it is staged, the launch alone on NCCL)."""

    shape: dict[str, int]
    coords: dict[str, int]
    device: torch.device
    group: object = None
    backend: str = "gloo"
    rank: int = 0  # global rank
    stats: dict = field(default_factory=lambda: dict(calls=0, captured=0, bytes=0,
                                                     secs=0.0))
    _pinned: dict = field(default_factory=dict, repr=False)

    def _note(self, t: torch.Tensor, t0: float) -> None:
        st = self.stats
        st["calls"] += 1
        st["bytes"] += t.nbytes
        st["secs"] += time.perf_counter() - t0
        if t.is_cuda and torch.cuda.is_current_stream_capturing():
            st["captured"] += 1

    @property
    def tp(self) -> int:
        return self.shape["tp"]

    @property
    def tp_rank(self) -> int:
        return self.coords["tp"]

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

    def shard(self, n: int, what: str = "axis") -> slice:
        """This rank's contiguous slice of an axis of ``n`` along ``tp``."""
        if n % self.tp:
            raise ValueError(f"{what} of {n} does not divide over tp={self.tp}")
        k = n // self.tp
        return slice(self.tp_rank * k, (self.tp_rank + 1) * k)

    # -- collectives -------------------------------------------------------

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer holding ``x`` (gloo staging)."""
        key = (x.shape, x.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._pinned[key] = buf
        buf.copy_(x)
        return buf

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the tp ranks, reduced in f32 and returned
        in ``x``'s dtype. Identical on every rank."""
        import torch.distributed as dist

        if self.group is None:
            return x
        t0 = time.perf_counter()
        acc = x.float().contiguous()
        if self.staged:
            h = self._host(acc)
            dist.all_reduce(h, group=self.group)
            acc = h.to(x.device)
        else:
            dist.all_reduce(acc, group=self.group)
        self._note(acc, t0)
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
        self._note(src, t0)
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
    host; the CPU under gloo). Raises when an axis other than ``tp``
    exceeds 1, or when the world is not ``tp * dp * sp * ep * pp`` ranks."""
    import torch.distributed as dist

    sizes = {"dp": dp, "pp": pp, "sp": sp, "ep": ep, "tp": tp}
    for name, n in sizes.items():
        if n < 1:
            raise ValueError(f"mesh axis {name}={n} must be >= 1")
        if name != "tp" and n > 1:
            raise NotImplementedError(
                f"mesh axis {name}={n}: the port shards only tp; {name} is "
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
    return Mesh(sizes, coords, dev, group=dist.group.WORLD,
                backend=dist.get_backend(), rank=rank)
