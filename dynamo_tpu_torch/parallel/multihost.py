"""Bootstrap of a mesh's group (tensor, expert, sequence and data
parallel): one logical worker over several processes, one per card (the counterpart of
dynamo_tpu/parallel/multihost.py).

The reference joins ``jax.distributed`` so that ``jax.devices()`` spans
every host. Here every rank calls ``initialize_multihost`` before it
builds its engine, and ``torch.distributed`` joins the ranks through a
``tcp://`` rendezvous at the coordinator address. The flags and their
environment fallbacks are the reference's: ``--coordinator-address`` /
``DYN_COORDINATOR``, ``--num-processes`` / ``DYN_NUM_PROCESSES``,
``--process-id`` / ``DYN_PROCESS_ID``. Rank 0 is the leader: it alone
registers, serves and samples; the others replay its dispatches
(parallel/spmd.py).

The backend is NCCL when the rank's device is a card and gloo when it is
the CPU. ``backend=`` or ``DYN_TP_BACKEND`` names it instead (gloo over
CUDA tensors stages its collectives through host memory: two ranks on one
card, where NCCL refuses). An NCCL failure raises; nothing switches to
gloo unasked.

``spawn_local_followers`` starts ranks 1..N-1 of a group on this host as
worker processes (``python -m dynamo_tpu_torch.engine.worker ...
--process-id r``): ``--tp T --ep E --sp S`` and the EngineConfig's ``dp``
(N = dp * S * E * T) with no coordinator do that, and the calling process
becomes rank 0.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import subprocess
import sys

import torch

log = logging.getLogger("dynamo_tpu_torch.multihost")

_STATE: dict = {"device": None}
DEFAULT_TIMEOUT_S = 600.0  # a rank's limit on any collective wait
_LOOPBACK = ("127.", "localhost", "::1")


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def rank_device(device, local_rank: int) -> torch.device:
    """The device of a rank: ``device`` as given when it names an index or
    the CPU, else ``cuda:<local_rank>``. No card and no ``device='cpu'``
    raises."""
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda" or dev.index is not None:
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("no CUDA device available; pass device='cpu'")
            return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", local_rank)


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device=None,
    backend: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    store=None,
) -> bool:
    """Join the group as rank ``process_id`` of ``num_processes``; a no-op
    (False) with one process or no coordinator. ``device`` is the rank's
    device (default ``cuda:<local rank>``; the local rank is
    ``DYN_LOCAL_RANK``, else the process id modulo the host's cards).
    ``timeout_s`` bounds every collective wait: a rank that waits on a peer
    that is gone raises instead of hanging. ``store`` (a
    ``torch.distributed.Store`` every rank reaches, such as a client of a
    ``TCPStore`` its spawner holds) replaces the ``tcp://`` rendezvous, in
    which rank 0 binds the coordinator's port: a port chosen free and
    bound later can be taken in between. The coordinator address still
    names rank 0's host."""
    coordinator_address = coordinator_address or os.environ.get("DYN_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("DYN_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("DYN_PROCESS_ID")
    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    import torch.distributed as dist

    if process_id is None:
        raise ValueError("a multi-process group needs --process-id / DYN_PROCESS_ID")
    local_rank = _env_int("DYN_LOCAL_RANK")
    if local_rank is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
        local_rank = process_id % max(1, n)
    dev = rank_device(device, local_rank)
    backend = backend or os.environ.get("DYN_TP_BACKEND") or (
        "nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    addr = coordinator_address
    if "://" not in addr:
        addr = f"tcp://{addr}"
    rendezvous = {"store": store} if store is not None else {"init_method": addr}
    dist.init_process_group(
        backend, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s), **rendezvous)
    _STATE["device"] = dev
    log.info("joined group: rank %d/%d via %s (%s on %s)", process_id,
             num_processes, coordinator_address, backend, dev)
    return True


def local_device() -> torch.device:
    """This rank's device as ``initialize_multihost`` chose it."""
    dev = _STATE["device"]
    if dev is None:
        raise RuntimeError("initialize_multihost has not run in this process")
    return dev


def is_leader() -> bool:
    """Rank 0 owns registration, serving and sampling; the others only
    replay its dispatches."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Leave the group (idempotent)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE["device"] = None


def leader_host(coordinator_address: str, host: str = "127.0.0.1") -> str:
    """The address rank 0 binds its descriptor plane on and publishes to
    the followers: ``host`` (the runtime config's) when it is not
    loopback, else the coordinator's host. Under the ``tcp://`` rendezvous
    rank 0 serves the group's store at the coordinator address, so every
    follower already reaches rank 0 there; loopback only when the
    coordinator is."""
    if not host.startswith(_LOOPBACK):
        return host
    chost = coordinator_address.split("://", 1)[-1].rsplit(":", 1)[0].strip("[]")
    return chost if chost and not chost.startswith(_LOOPBACK) else host


def free_coordinator(host: str = "127.0.0.1") -> str:
    """``host:port`` of a free local port for a group's rendezvous."""
    with socket.socket() as s:
        s.bind((host, 0))
        return f"{host}:{s.getsockname()[1]}"


def spawn_local_followers(
    n: int, worker_argv: list[str], coordinator: str, env: dict | None = None,
) -> list[subprocess.Popen]:
    """Ranks 1..n-1 of a group of ``n`` (dp x sp x ep x tp) on this host:
    worker processes given ``worker_argv`` (the leader's model and engine
    flags, its EngineConfig with its axes) plus the group's coordinator, size and
    their rank; ``DYN_LOCAL_RANK`` picks each one's card. Each prints
    ``MULTIHOST_FOLLOWER_READY`` once its shell is built. The caller
    becomes rank 0 and stops them at the end."""
    procs = []
    for r in range(1, n):
        penv = dict(os.environ if env is None else env, DYN_LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.engine.worker", *worker_argv,
             "--coordinator-address", coordinator,
             "--num-processes", str(n), "--process-id", str(r)],
            env=penv))
    return procs
