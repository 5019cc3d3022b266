"""Hub-replica cluster drivers + the jepsen-style WAL invariant checker (the
counterpart of dynamo_tpu/sim/cluster.py).

The cluster sim (sim/scenarios.py), the replication tests and the card
smoke run hold the same raft-lite safety contract: spawn ``python -m
dynamo_tpu_torch.runtime.hub_replica`` subprocesses, poll their
``repl.status`` over the framed transport, build ``transport.partition``
fault specs, and replay replica WALs through ``check_cluster_invariants``.
The WAL and snapshot bytes are the reference's, so the checker reads a
JAX replica's data dir as well as a port replica's."""

from __future__ import annotations

import asyncio
import socket
import struct
import subprocess
import sys
import time
from pathlib import Path

from dynamo_tpu_torch.runtime import framing
from dynamo_tpu_torch.runtime.codec import unpackb

__all__ = [
    "free_port",
    "spawn_replica",
    "repl_status",
    "find_leader",
    "partition_spec",
    "isolate_spec",
    "read_wal",
    "check_cluster_invariants",
]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_replica(
    addr: str, peers: str, data_dir: str, lease_s: float = 1.0
) -> subprocess.Popen:
    """Start one replica process and block until it prints DYNAMO_HUB=
    (listening); callers SIGKILL it freely."""
    host, port = addr.rsplit(":", 1)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.runtime.hub_replica",
         "--host", host, "--port", port, "--peers", peers,
         "--data-dir", data_dir, "--lease-s", str(lease_s)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
    )
    line = proc.stdout.readline().decode()
    assert "DYNAMO_HUB=" in line, line
    return proc


async def repl_status(addr: str) -> dict | None:
    """One ``repl.status`` probe; None when unreachable/unresponsive."""
    host, port = addr.rsplit(":", 1)
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, int(port)), 1.0
        )
    except (OSError, asyncio.TimeoutError):
        return None
    try:
        await framing.write_frame(writer, {"id": 1, "op": "repl.status"})
        msg = await asyncio.wait_for(framing.read_frame(reader), 1.0)
        return msg.get("result") if msg and msg.get("ok") else None
    except (OSError, asyncio.TimeoutError):
        return None
    finally:
        writer.close()


async def find_leader(addrs: list[str], timeout: float = 15.0) -> str:
    """Poll until exactly ONE replica claims leadership; its address."""
    statuses: list = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        statuses = [await repl_status(a) for a in addrs]
        leaders = [
            s["addr"] for s in statuses if s and s.get("role") == "leader"
        ]
        if len(leaders) == 1:
            return leaders[0]
        await asyncio.sleep(0.1)
    raise AssertionError(f"no unique leader among {addrs}: {statuses}")


# -- partition fault specs ---------------------------------------------------


def partition_spec(*pairs: tuple[str, str], one_way: bool = False) -> str:
    """``transport.partition`` DYN_FAULTS entries for the given address
    pairs (``one_way=True``: traffic a -> b is cut, b -> a still flows)."""
    sep = ">" if one_way else "|"
    return ",".join(
        f"transport.partition:drop={a}{sep}{b}" for a, b in pairs
    )


def isolate_spec(addr: str, others: list[str]) -> str:
    """Symmetric partition cutting ``addr`` off from every other replica."""
    return partition_spec(*[(addr, o) for o in others if o != addr])


# -- jepsen-style WAL invariant checker --------------------------------------

_LEN = struct.Struct(">I")


def read_wal(data_dir: str | Path) -> tuple[dict | None, list[dict]]:
    """Read-only WAL load: (snapshot state or None, records of the
    snapshot's generation). Unlike HubStore.load this never truncates a
    torn tail — safe on a live replica's dir once writes are quiesced."""
    d = Path(data_dir)
    state = None
    gen = 0
    snap = d / "hub.snap"
    if snap.exists():
        try:
            state = unpackb(snap.read_bytes())
            gen = int(state.get("gen", 0))
        except ValueError:
            state = None
    records: list[dict] = []
    wal = d / f"hub.wal.{gen}"
    if wal.exists():
        data = wal.read_bytes()
        off = 0
        while off + _LEN.size <= len(data):
            (n,) = _LEN.unpack_from(data, off)
            if off + _LEN.size + n > len(data):
                break  # torn tail
            try:
                records.append(unpackb(data[off + _LEN.size: off + _LEN.size + n]))
            except ValueError:
                break
            off += _LEN.size + n
    return state, records


def _canonical(rec: dict) -> dict:
    """Replication-stream identity of a record: the leader's stamp minus
    the follower-local replay tag."""
    return {k: v for k, v in rec.items() if k != "rsq"}


def check_cluster_invariants(
    data_dirs: list, *, quorum: int | None = None
) -> dict:
    """Replay every replica's WAL and assert the raft-lite safety
    contract:

    - UNIQUE LEADER PER TERM: promote records across all WALs never name
      two different leaders for the same fencing epoch;
    - NO SEQ GAPS: each replica's record stream is contiguous from its
      snapshot base (``sq``/``rsq`` stamps strictly +1);
    - NO COMMITTED FORKS: any seq held by a majority of replicas (the
      committed prefix) is byte-identical everywhere it appears, and the
      committed seq set is itself contiguous.

    Returns {"promotes": {...}, "committed": [...]} for further checks.
    """
    n = len(data_dirs)
    quorum = quorum or (n // 2 + 1)
    promotes: dict[int, set] = {}
    seq_maps: list[dict[int, dict]] = []
    for d in data_dirs:
        state, records = read_wal(d)
        base = int(state.get("wal_seq", 0)) if state else 0
        seqs: dict[int, dict] = {}
        prev = None
        for rec in records:
            seq = rec.get("rsq", rec.get("sq"))
            assert seq is not None, f"{d}: unstamped WAL record {rec}"
            seq = int(seq)
            assert seq > base, (
                f"{d}: record seq {seq} at or below snapshot base {base}"
            )
            if prev is not None:
                assert seq == prev + 1, (
                    f"{d}: WAL seq gap {prev} -> {seq}"
                )
            prev = seq
            seqs[seq] = _canonical(rec)
            if rec.get("op") == "promote":
                promotes.setdefault(int(rec["epoch"]), set()).add(
                    rec.get("addr")
                )
        seq_maps.append(seqs)
    for epoch, addrs in sorted(promotes.items()):
        named = {a for a in addrs if a is not None}
        assert len(named) <= 1, (
            f"DUAL-LEAD: term {epoch} has promote records from {named}"
        )
    committed = sorted(
        seq
        for seq in {s for m in seq_maps for s in m}
        if sum(1 for m in seq_maps if seq in m) >= quorum
    )
    for seq in committed:
        copies = [m[seq] for m in seq_maps if seq in m]
        assert all(c == copies[0] for c in copies[1:]), (
            f"FORK at committed seq {seq}: {copies}"
        )
    for a, b in zip(committed, committed[1:]):
        assert b == a + 1, f"committed-seq gap {a} -> {b}"
    return {"promotes": promotes, "committed": committed}
