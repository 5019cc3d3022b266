"""TCP server exposing an InMemoryHub to many processes (the counterpart of
dynamo_tpu/runtime/hub_server.py).

Run as ``python -m dynamo_tpu_torch.runtime.hub_server [--port N]`` (or
``python -m dynamo_tpu_torch.cli hub``): the deployment's single
coordination process. It prints ``DYNAMO_HUB=host:port`` once listening.
Without ``--data-dir`` state lives in memory; with it the hub is durable
(hub_store.py): every mutation is WAL-logged and periodically snapshotted,
and a restarted hub recovers its model cards, instance keys, leases,
retained event streams with their seqs, objects and ``boot_id``. The
replicated hub (hub_replica.py) plugs in through the ``_route`` /
``_dispatch_repl`` / ``_commit_barrier`` hooks.

Protocol: framing.py frames, the same bytes as the JAX package's hub, so a
JAX client can use this server and the port's client a JAX server. Request:
``{"id": n, "op": str, ...}`` -> response ``{"id": n, "ok": bool,
"result"/"error": ...}``. Streaming ops (``watch``, ``subscribe``) emit
``{"id": n, "stream": item}`` frames until the client sends ``{"op":
"cancel", "target": n}``.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
from typing import Any

from dynamo_tpu_torch.runtime import framing
from dynamo_tpu_torch.runtime.context import spawn
from dynamo_tpu_torch.runtime.hub import InMemoryHub, KeyExists, NoQuorum
from dynamo_tpu_torch.runtime.hub_store import HubFenced

log = logging.getLogger("dynamo_tpu_torch.hub")


class HubServer:
    # ops that mutate hub state: a replicated follower bounces these with a
    # ``not_leader`` error naming the current leader (hub_replica.py)
    WRITE_OPS = frozenset({
        "put", "create", "delete", "grant_lease", "keepalive",
        "revoke_lease", "publish", "purge_subject", "put_object",
        "delete_object",
    })

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 data_dir: str | None = None, *,
                 hub: InMemoryHub | None = None, fsync: bool | None = None):
        if hub is not None:
            self.hub: InMemoryHub = hub
        elif data_dir:
            from dynamo_tpu_torch.runtime.hub_store import DurableHub

            self.hub = DurableHub(data_dir, fsync=fsync)
        else:
            self.hub = InMemoryHub()
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[asyncio.StreamWriter] = set()

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        sock = self._server.sockets[0]
        self.host, self.port = sock.getsockname()[:2]
        # recovered leases must be reaped when their owners stay gone; the
        # reaper otherwise starts on the first grant_lease, which may never
        # come on a restarted hub serving only old leases
        self.hub._ensure_reaper()
        log.info("hub listening on %s:%d", self.host, self.port)
        return self.host, self.port

    async def serve_forever(self) -> None:
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        # close peer connections: on 3.12+ wait_closed() blocks until every
        # client connection handler has finished.
        for w in list(self._conns):
            w.close()
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=5)
            except asyncio.TimeoutError:  # pragma: no cover
                pass
        await self.hub.close()

    def kick_clients(self) -> None:
        """Close every client connection (clients reconnect and re-sync).
        A replication follower does this after adopting a snapshot: its
        subscribers would otherwise miss the events inside the snapshot."""
        for w in list(self._conns):
            w.close()

    # -- per-connection ----------------------------------------------------

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        streams: dict[int, asyncio.Task] = {}
        # the leases granted on this connection, as the reference's server
        # tracks them; a disconnect revokes none (expiry follows the TTL)
        conn_leases: set[int] = set()
        write_lock = asyncio.Lock()
        self._conns.add(writer)

        async def send(msg: dict[str, Any]) -> None:
            # frames to ONE client serialize (interleaving corrupts the
            # framing); one slow client stalls only its own dispatches
            async with write_lock:
                await framing.write_frame(writer, msg)

        try:
            while True:
                msg = await framing.read_frame(reader)
                if msg is None:
                    break
                # spawn: strong ref + crash logging — a GC'd dispatch task
                # would silently drop the RPC (client hangs to timeout)
                spawn(self._dispatch(msg, send, streams, conn_leases), name="hub-dispatch")
        except (ConnectionResetError, BrokenPipeError):
            pass
        except (ValueError, TypeError) as e:
            # oversize frame or bytes the codec cannot read: framing cannot
            # resync, so drop this connection and keep serving the rest
            log.warning("dropping hub connection with bad framing: %r", e)
        finally:
            for t in streams.values():
                t.cancel()
            # leases are NOT revoked on disconnect: clients may reconnect and
            # keepalive; expiry is governed solely by TTL (like etcd).
            self._conns.discard(writer)
            writer.close()

    async def _dispatch(
        self, msg: dict[str, Any], send, streams: dict[int, asyncio.Task],
        conn_leases: set[int],
    ) -> None:
        op = msg.get("op")
        mid = msg.get("id")
        hub = self.hub
        try:
            bounce = self._route(op)
            if bounce is not None:
                await send({"id": mid, "ok": False, **bounce})
                return
            if await self._dispatch_repl(op, mid, msg, send, streams):
                return
            # WAL position before the op: a replicated leader acks a write
            # only once the records it logged past here are on a majority
            # (_commit_barrier); ops that logged nothing skip the barrier
            pre_seq = getattr(hub, "wal_seq", 0)
            if op == "put":
                await hub.put(msg["key"], msg["value"], msg.get("lease"))
                result: Any = True
            elif op == "create":
                await hub.create(msg["key"], msg["value"], msg.get("lease"))
                result = True
            elif op == "get":
                result = await hub.get(msg["key"])
            elif op == "delete":
                result = await hub.delete(msg["key"])
            elif op == "get_prefix":
                result = await hub.get_prefix(msg["prefix"])
            elif op == "grant_lease":
                result = await hub.grant_lease(msg["ttl"])
                conn_leases.add(result)
            elif op == "keepalive":
                result = await hub.keepalive(msg["lease"])
            elif op == "revoke_lease":
                await hub.revoke_lease(msg["lease"])
                result = True
            elif op == "publish":
                # pub_id: client idempotency id — a retried publish whose
                # ack was lost dedups instead of minting a duplicate seq
                result = await hub.publish(
                    msg["subject"], msg["payload"], pub_id=msg.get("pub_id"),
                )
            elif op == "purge_subject":
                result = await hub.purge_subject(
                    msg["subject"], msg.get("keep_last", 0),
                    up_to_seq=msg.get("up_to_seq"),
                )
            elif op == "put_object":
                await hub.put_object(msg["bucket"], msg["name"], msg["data"])
                result = True
            elif op == "get_object":
                result = await hub.get_object(msg["bucket"], msg["name"])
            elif op == "delete_object":
                await hub.delete_object(msg["bucket"], msg["name"])
                result = True
            elif op == "watch":
                streams[mid] = asyncio.ensure_future(
                    self._stream_watch(
                        mid, msg["prefix"], msg.get("initial", True),
                        msg.get("sync", False), send,
                    )
                )
                return  # stream frames only; no immediate ack
            elif op == "boot_id":
                result = await hub.get_boot_id()
            elif op == "subscribe":
                streams[mid] = asyncio.ensure_future(
                    self._stream_subscribe(
                        mid, msg["subject"], msg.get("replay", False), send
                    )
                )
                return
            elif op == "cancel":
                t = streams.pop(msg["target"], None)
                if t:
                    t.cancel()
                result = True
            elif op == "ping":
                result = "pong"
            else:
                raise ValueError(f"unknown op {op!r}")
            if op in self.WRITE_OPS:
                # the post-op position, taken before any await: waiting on a
                # later one would tie this ack to its neighbours' replication
                post_seq = getattr(hub, "wal_seq", 0)
                if post_seq > pre_seq:
                    await self._commit_barrier(post_seq)
            await send({"id": mid, "ok": True, "result": result})
        except KeyExists as e:
            await send({"id": mid, "ok": False, "error": "key_exists", "key": str(e)})
        except NoQuorum as e:
            # logged locally but not on a majority: the client must treat
            # the write as not committed and retry; retry_after is the
            # server's estimate of when a quorum can be back
            log.warning("hub write %r failed commit quorum: %s", op, e)
            bounce = {"id": mid, "ok": False, "error": "no_quorum"}
            hint = self._retry_after_hint()
            if hint is not None:
                bounce["retry_after"] = hint
            await send(bounce)
        except HubFenced:
            # deposed while the write was in flight: bounce like a follower
            await send({"id": mid, "ok": False, "error": "not_leader",
                        "leader": self._leader_hint()})
        except asyncio.CancelledError:
            raise
        except (ConnectionResetError, BrokenPipeError):
            pass  # the client went away before its answer
        except Exception as e:  # noqa: BLE001 - serve errors to the client
            await send({"id": mid, "ok": False, "error": repr(e)})

    def _route(self, op: str) -> dict[str, Any] | None:
        """Hook: an error payload to bounce ``op`` with instead of serving
        it (a replicated follower bounces WRITE_OPS); None serves it."""
        return None

    def _leader_hint(self) -> str | None:
        """Hook: the current leader's address for ``not_leader`` bounces."""
        return None

    def _retry_after_hint(self) -> float | None:
        """Hook: seconds until a ``no_quorum`` bounce is worth retrying;
        None sends no hint (clients back off on their own)."""
        return None

    async def _commit_barrier(self, seq: int) -> None:
        """Hook: called after a WRITE_OPS op logged records up to WAL
        position ``seq``, before its ack. The base server commits locally;
        the replicated leader waits for a majority or raises NoQuorum."""

    async def _dispatch_repl(
        self, op: str, mid: int, msg: dict[str, Any], send, streams
    ) -> bool:
        """Hook: serve a replication op (``repl.*``); True when handled."""
        return False

    async def _stream_watch(
        self, mid: int, prefix: str, initial: bool, sync: bool, send
    ) -> None:
        try:
            async for ev in self.hub.watch_prefix(
                prefix, initial=initial, sync_marker=sync
            ):
                await send(
                    {"id": mid, "stream": {"kind": ev.kind, "key": ev.key, "value": ev.value}}
                )
        except asyncio.CancelledError:
            pass
        except (ConnectionResetError, BrokenPipeError):
            pass

    async def _stream_subscribe(self, mid: int, subject: str, replay: bool, send) -> None:
        try:
            async for subj, payload, seq in self.hub.subscribe(
                subject, replay=replay, with_seq=True
            ):
                await send({"id": mid, "stream": {
                    "subject": subj, "payload": payload, "seq": seq}})
        except asyncio.CancelledError:
            pass
        except (ConnectionResetError, BrokenPipeError):
            pass


async def _amain(args: argparse.Namespace) -> None:
    server = HubServer(args.host, args.port, args.data_dir,
                       fsync=True if args.fsync else None)
    await server.start()
    print(f"DYNAMO_HUB={server.host}:{server.port}", flush=True)
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    try:
        import signal

        loop.add_signal_handler(signal.SIGTERM, stop.set)
    except (NotImplementedError, RuntimeError):  # pragma: no cover
        pass  # non-unix event loop
    serving = asyncio.ensure_future(server.serve_forever())
    try:
        await stop.wait()
    finally:
        serving.cancel()
        await server.stop()


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="dynamo-tpu hub (coordination service)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6650)
    parser.add_argument("--data-dir", default=None,
                        help="durable hub: WAL and snapshots in this directory")
    parser.add_argument("--fsync", action="store_true",
                        help="fsync every WAL append (survive power loss, not just "
                             "process death); default follows DYNAMO_HUB_FSYNC=1")
    args = parser.parse_args(argv)
    from dynamo_tpu_torch.runtime.logging_util import setup_logging

    setup_logging()
    try:
        asyncio.run(_amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
