"""The port's durable hub (dynamo_tpu_torch/runtime/hub_store.py) against the
reference's (dynamo_tpu/runtime/hub_store.py), and the port's client
reconnecting across a kill -9 of a ``cli hub --data-dir`` process.

- every test of tests/test_hub_durability.py, run on the port: WAL and
  snapshot recovery of the full hub state, compaction (background, the
  inline hard bound, a counted failure), torn tails, generations, leases
  across a restart, publish dedup by ``pub_id``;
- the disk format: one op sequence (from a numpy seed) through both
  packages' DurableHubs writes byte-equal ``hub.wal.<g>`` and ``hub.term``
  files and a ``hub.snap`` that decodes equal (``boot_id`` masked), and each
  package recovers the other's data dir to equal state.
"""

import asyncio
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import msgpack
import numpy as np
import pytest

from dynamo_tpu.runtime import hub_replica as jax_replica
from dynamo_tpu.runtime import hub_store as jax_store
from dynamo_tpu_torch.runtime import hub_replica, hub_store
from dynamo_tpu_torch.runtime.hub_client import RemoteHub
from dynamo_tpu_torch.runtime.hub_store import DurableHub, HubStore

pytestmark = pytest.mark.integration

ROOT = Path(__file__).resolve().parents[1]


# -- DurableHub unit tests --------------------------------------------------


async def test_durable_hub_full_state_roundtrip(tmp_path):
    hub = DurableHub(tmp_path)
    boot = hub.boot_id
    await hub.put("models/llama", {"name": "llama", "ctx": 8192})
    await hub.create("config/router", {"temp": 0.5})
    lease = await hub.grant_lease(30.0)
    await hub.put("instances/w0", {"port": 1234}, lease_id=lease)
    for i in range(5):
        await hub.publish("kv.events.w0", {"seq_payload": i})
    await hub.publish("metrics.w0", {"load": 0.5})
    await hub.put_object("cards", "llama.json", b"{}")
    await hub.delete("config/router")
    await hub.close()

    hub2 = DurableHub(tmp_path)
    assert hub2.boot_id == boot  # identity survives: seq baselines stay valid
    assert await hub2.get("models/llama") == {"name": "llama", "ctx": 8192}
    assert await hub2.get("config/router") is None
    assert await hub2.get("instances/w0") == {"port": 1234}
    assert await hub2.get_object("cards", "llama.json") == b"{}"
    # retained events replay with their original seqs, and new publishes
    # CONTINUE the seq space instead of restarting it
    seen = []
    async for _subj, payload, seq in hub2.subscribe(
        "kv.events.*", replay=True, with_seq=True
    ):
        seen.append((seq, payload["seq_payload"]))
        if len(seen) == 5:
            break
    assert seen == [(i + 1, i) for i in range(5)]
    await hub2.publish("kv.events.w0", {"seq_payload": 5})
    assert hub2._subject_seq["kv.events.w0"] == 6
    await hub2.close()


async def test_durable_lease_reexpires_after_recovery(tmp_path):
    hub = DurableHub(tmp_path)
    lease = await hub.grant_lease(0.5)
    await hub.put("instances/dead-worker", {"x": 1}, lease_id=lease)
    await hub.close()

    hub2 = DurableHub(tmp_path)
    # restored with a fresh full TTL: still present right after recovery
    assert await hub2.get("instances/dead-worker") == {"x": 1}
    # the owner never keepalives -> one TTL later the key is gone
    hub2.reap_expired(now=time.monotonic() + 1.0)
    assert await hub2.get("instances/dead-worker") is None
    await hub2.close()


async def test_durable_lease_keepalive_spans_restart(tmp_path):
    hub = DurableHub(tmp_path)
    lease = await hub.grant_lease(30.0)
    await hub.put("instances/live", {"x": 1}, lease_id=lease)
    await hub.close()

    hub2 = DurableHub(tmp_path)
    assert await hub2.keepalive(lease) is True  # same lease id still valid
    await hub2.revoke_lease(lease)
    assert await hub2.get("instances/live") is None
    await hub2.close()


async def test_snapshot_compaction_bounds_wal(tmp_path):
    hub = DurableHub(tmp_path, compact_every=8)
    for i in range(30):
        await hub.put(f"k/{i % 4}", i)
    # compaction is a threshold-triggered BACKGROUND task (it must never
    # block the mutation path — replication bootstrap rides snapshots);
    # drain it before asserting on-disk state
    deadline = time.monotonic() + 5
    while (
        hub._compacting or hub.store.records_since_snapshot >= 8
    ) and time.monotonic() < deadline:
        await asyncio.sleep(0.01)
    store_gen = hub.store.gen
    assert store_gen >= 1  # at least one snapshot landed
    # WAL is bounded: fewer than one threshold of records awaits replay
    assert hub.store.records_since_snapshot < 8
    # only the CURRENT generation's WAL remains on disk
    wals = sorted(p.name for p in tmp_path.glob("hub.wal.*"))
    assert wals == [f"hub.wal.{store_gen}"]
    await hub.close()

    hub2 = DurableHub(tmp_path)
    # last write per key wins
    assert await hub2.get("k/0") == 28
    assert await hub2.get("k/1") == 29
    assert await hub2.get("k/2") == 26
    assert await hub2.get("k/3") == 27
    await hub2.close()


async def test_compaction_hard_bound_without_yield(tmp_path):
    """A mutation loop that never yields to the event loop (so the
    background compaction task never runs) still gets its WAL rotated:
    the 4x-threshold hard bound snapshots inline."""
    hub = DurableHub(tmp_path, compact_every=4)
    for i in range(40):  # no awaits that yield: puts run back-to-back
        await hub.put("k", i)
    assert hub.store.gen >= 1  # inline hard bound fired mid-loop
    # now let the scheduled background task wake: it must notice its
    # capture is stale (gen moved) and not clobber the newer snapshot
    gen = hub.store.gen
    deadline = time.monotonic() + 5
    while hub._compacting and time.monotonic() < deadline:
        await asyncio.sleep(0.01)
    assert hub.store.gen >= gen
    await hub.close()
    hub2 = DurableHub(tmp_path)
    assert await hub2.get("k") == 39
    await hub2.close()


async def test_compaction_failure_counted_and_survived(tmp_path):
    """A background compaction failure (injected fsync fault at the
    snapshot's durability point, ``hub.snap_fsync``) must increment
    ``dynamo_hub_compaction_failures_total`` and leave the hub serving on
    the uncompacted WAL; once the disk recovers, the next threshold
    crossing compacts normally."""
    from dynamo_tpu_torch.runtime.faults import FAULTS
    from dynamo_tpu_torch.runtime.hub_store import COMPACTION_FAILURES

    hub = DurableHub(tmp_path, compact_every=8)
    try:
        before = COMPACTION_FAILURES._only().value
        gen0 = hub.store.gen
        # cross the threshold WITHOUT yielding: the background compaction
        # task is spawned but has not run when we arm the fault
        for i in range(8):
            await hub.put(f"k/{i}", i)
        FAULTS.configure("hub.snap_fsync:error@1x1", seed=0)
        deadline = time.monotonic() + 5
        while (
            COMPACTION_FAILURES._only().value == before
            and time.monotonic() < deadline
        ):
            await asyncio.sleep(0.01)
        assert COMPACTION_FAILURES._only().value == before + 1
        assert hub.store.gen == gen0  # snapshot did NOT land
        # serving survived: reads and writes still work on the
        # uncompacted WAL
        assert await hub.get("k/3") == 3
        FAULTS.clear()
        await hub.put("after/failure", 1)
        # the retry (spawned by the post-heal write) compacts cleanly
        deadline = time.monotonic() + 5
        while (
            hub.store.records_since_snapshot >= 8
            and time.monotonic() < deadline
        ):
            await asyncio.sleep(0.01)
        assert hub.store.gen > gen0
    finally:
        FAULTS.clear()
        await hub.close()
    # everything — including the write taken during the failure window —
    # survives a restart
    hub2 = DurableHub(tmp_path)
    assert await hub2.get("after/failure") == 1
    assert await hub2.get("k/7") == 7
    await hub2.close()


def test_wal_append_throughput(tmp_path, capsys):
    """Time raw WAL appends and PRINT the ops/s so every tier-1 log
    carries the number (regressions show up in CI diffs; the README
    durability table records the reference value)."""
    store = HubStore(tmp_path, fsync=False)
    rec = {"op": "put", "k": "bench/key", "v": {"port": 9000}, "l": None}
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        store.append(rec)
    dt = time.perf_counter() - t0
    store.close()
    ops = n / dt
    with capsys.disabled():
        print(f"\nHUB_WAL_APPEND_OPS_S={ops:.0f} (n={n}, fsync=off)")
    assert ops > 1000  # sanity floor, not a perf bar


async def test_torn_wal_tail_is_discarded(tmp_path):
    hub = DurableHub(tmp_path)
    await hub.put("a", 1)
    await hub.put("b", 2)
    await hub.close()
    # simulate a crash mid-append: garbage half-record at the WAL tail
    wal = tmp_path / f"hub.wal.{hub.store.gen}"
    with open(wal, "ab") as f:
        f.write(b"\x00\x00\x10\x00partial-record")

    hub2 = DurableHub(tmp_path)
    assert await hub2.get("a") == 1
    assert await hub2.get("b") == 2
    await hub2.put("c", 3)  # appends cleanly after the truncated tail
    await hub2.close()
    hub3 = DurableHub(tmp_path)
    assert await hub3.get("c") == 3
    await hub3.close()


async def test_purge_survives_restart(tmp_path):
    hub = DurableHub(tmp_path)
    for i in range(10):
        await hub.publish("ev.x", i)
    await hub.purge_subject("ev.x", up_to_seq=7)
    await hub.close()
    hub2 = DurableHub(tmp_path)
    seen = []
    async for _s, payload, seq in hub2.subscribe(
        "ev.x", replay=True, with_seq=True
    ):
        seen.append((seq, payload))
        if len(seen) == 3:
            break
    assert seen == [(8, 7), (9, 8), (10, 9)]
    await hub2.close()


def test_store_load_ignores_older_generation_wal(tmp_path):
    """Crash between snapshot replace and old-WAL unlink must not
    double-apply: only the WAL matching the snapshot's gen is read."""
    store = HubStore(tmp_path)
    store.append({"op": "put", "k": "a", "v": 1, "l": None})
    store.snapshot({"boot_id": "x", "kv": {"a": 1}, "key_lease": {},
                    "leases": [], "next_lease": 1, "subject_seq": {},
                    "retained": {}, "objects": []})
    # resurrect a stale gen-0 WAL as if unlink never happened
    (tmp_path / "hub.wal.0").write_bytes(b"")
    store.close()
    store2 = HubStore(tmp_path)
    state, records = store2.load()
    assert state["gen"] == 1
    assert records == []  # gen-0 WAL ignored
    store2.close()


# -- kill -9 + restart through real processes -------------------------------


def _spawn_hub(port: int, data_dir: str) -> tuple[subprocess.Popen, int]:
    """A ``cli hub`` process on ``port`` (0: a port of its own choosing,
    never one found free here and bound later); (process, its port)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli", "hub",
         "--port", str(port), "--data-dir", data_dir],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, cwd=ROOT,
    )
    line = proc.stdout.readline().decode()
    assert "DYNAMO_HUB=" in line, line
    return proc, int(line.strip().rsplit(":", 1)[1])


async def test_hub_kill9_restart_clients_reconverge(tmp_path):
    """Kill -9 the hub mid-flight, restart it on the same port + data dir, and clients reconverge WITHOUT being
    restarted — state intact, watches live, event seqs continuous."""
    proc, port = _spawn_hub(0, str(tmp_path))
    hub = None
    try:
        hub = await RemoteHub.connect(
            f"127.0.0.1:{port}", reconnect_window_s=20.0
        )
        boot = await hub.get_boot_id()
        await hub.put("mdc/llama", {"card": 1})
        lease = await hub.grant_lease(30.0)
        await hub.put("v1/instances/w0", {"port": 9}, lease_id=lease)
        await hub.publish("kv.ev", {"n": 1})
        await hub.put_object("snap", "radix", b"tree-bytes")

        # live watch + live subscription across the crash
        watch_events: list = []
        sub_events: list = []

        async def watcher():
            async for ev in hub.watch_prefix("mdc/"):
                watch_events.append(ev)

        async def subscriber():
            async for _s, payload, seq in hub.subscribe(
                "kv.ev", replay=True, with_seq=True
            ):
                sub_events.append((seq, payload))

        wt = asyncio.create_task(watcher())
        st = asyncio.create_task(subscriber())
        await asyncio.sleep(0.3)
        assert [ev.key for ev in watch_events] == ["mdc/llama"]
        assert sub_events == [(1, {"n": 1})]

        # SIGKILL: no graceful close, no flush beyond the per-op WAL append
        proc.kill()
        proc.wait()
        proc, _ = _spawn_hub(port, str(tmp_path))

        # calls reconverge through auto-reconnect
        assert await hub.get("mdc/llama") == {"card": 1}
        assert await hub.get_boot_id() == boot
        assert await hub.get_object("snap", "radix") == b"tree-bytes"
        # the worker's lease survived and its instance key is intact
        assert await hub.keepalive(lease) is True
        assert await hub.get("v1/instances/w0") == {"port": 9}

        # watch re-synced (snapshot re-delivery) and sees NEW mutations
        await hub.put("mdc/qwen", {"card": 2})
        await hub.publish("kv.ev", {"n": 2})
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if any(ev.key == "mdc/qwen" for ev in watch_events) and any(
                s == 2 for s, _ in sub_events
            ):
                break
            await asyncio.sleep(0.05)
        assert any(
            ev.key == "mdc/qwen" and ev.kind == "put" for ev in watch_events
        )
        # seq space CONTINUED across the restart (durable counters) and
        # the replayed event was deduped, not delivered twice
        assert (2, {"n": 2}) in sub_events
        assert sub_events.count((1, {"n": 1})) == 1

        wt.cancel()
        st.cancel()
    finally:
        if hub is not None:
            await hub.close()
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
            proc.wait()


async def test_watch_resync_synthesizes_missed_deletes(tmp_path):
    """A key deleted while the client was disconnected surfaces as a
    synthetic delete on re-sync (etcd watch re-establishment semantics)."""
    proc, port = _spawn_hub(0, str(tmp_path))
    hub = None
    try:
        hub = await RemoteHub.connect(
            f"127.0.0.1:{port}", reconnect_window_s=20.0
        )
        await hub.put("reg/a", 1)
        await hub.put("reg/b", 2)
        events: list = []

        async def watcher():
            async for ev in hub.watch_prefix("reg/"):
                events.append((ev.kind, ev.key))

        wt = asyncio.create_task(watcher())
        await asyncio.sleep(0.3)
        assert ("put", "reg/a") in events and ("put", "reg/b") in events

        proc.kill()
        proc.wait()
        proc, _ = _spawn_hub(port, str(tmp_path))
        # delete happens BEFORE the watcher re-syncs: a second client
        # (fresh connection) mutates immediately after restart
        hub2 = await RemoteHub.connect(f"127.0.0.1:{port}")
        await hub2.delete("reg/b")
        await hub2.close()

        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if ("delete", "reg/b") in events:
                break
            await asyncio.sleep(0.05)
        assert ("delete", "reg/b") in events
        wt.cancel()
    finally:
        if hub is not None:
            await hub.close()
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
            proc.wait()


async def test_nondurable_hub_still_works(tmp_path):
    """No --data-dir: in-memory hub, no files written (NATS-core mode),
    not even in the process's working directory."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli", "hub",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    try:
        line = proc.stdout.readline().decode()
        assert "DYNAMO_HUB=" in line
        port = int(line.strip().rsplit(":", 1)[1])
        hub = await RemoteHub.connect(f"127.0.0.1:{port}")
        await hub.put("k", 1)
        assert await hub.get("k") == 1
        await hub.close()
        assert list(tmp_path.glob("hub.*")) == []
    finally:
        proc.terminate()
        proc.wait()


# -- reconnect-race + publish-idempotency regressions -----------------------


async def test_stale_rx_loop_only_fails_own_epoch():
    """A reconnect can replace _rx_task while the OLD
    rx task is still blocked on its dead reader (the write side of a
    broken connection fails first). When the old task finally unblocks,
    its cleanup must fail only ITS generation's pending entries/streams —
    not futures created on the healthy new connection (which would
    spuriously retry calls, duplicating non-idempotent ops)."""
    from dynamo_tpu_torch.runtime.hub_server import HubServer

    server = HubServer(port=0)
    await server.start()
    hub = await RemoteHub.connect(f"127.0.0.1:{server.port}")
    try:
        old_rx, old_writer = hub._rx_task, hub._writer
        old_epoch = hub._epoch
        # the write side broke: _ensure_connected dials a NEW connection
        # and replaces reader/writer/rx task while old_rx is still
        # parked in read_frame on the old reader
        await hub._connect()
        assert hub._epoch == old_epoch + 1
        assert hub._rx_task is not old_rx and not old_rx.done()

        loop = asyncio.get_running_loop()
        old_fut, new_fut = loop.create_future(), loop.create_future()
        old_q: asyncio.Queue = asyncio.Queue()
        new_q: asyncio.Queue = asyncio.Queue()
        hub._pending[9001] = (old_epoch, old_fut)
        hub._pending[9002] = (hub._epoch, new_fut)
        hub._streams[9003] = (old_epoch, old_q)
        hub._streams[9004] = (hub._epoch, new_q)

        # now the old connection actually dies and old_rx unblocks
        old_writer.close()
        await asyncio.wait_for(old_rx, 5)

        # own-generation entries failed...
        assert isinstance(old_fut.exception(), ConnectionError)
        assert old_q.get_nowait() is None  # closed-stream sentinel
        # ...new-generation entries untouched
        assert not new_fut.done()
        assert new_q.empty()

        hub._pending.pop(9002, None)
        hub._streams.pop(9003, None)
        hub._streams.pop(9004, None)
        new_fut.cancel()
        # and the new connection still serves calls end-to-end
        await hub.put("alive", 1)
        assert await hub.get("alive") == 1
    finally:
        await hub.close()
        await server.stop()


async def test_publish_pub_id_dedups_across_retry_and_restart(tmp_path):
    """A publish retried after a lost ack must not mint a
    duplicate event under a fresh seq. The pub_id dedup window also
    survives a hub restart (WAL carries the id), so a retry landing on
    the recovered hub still dedups."""
    hub = DurableHub(tmp_path)
    assert await hub.publish("ev", {"n": 1}, pub_id="cli:1") is True
    # the at-least-once retry: same id, must be dropped
    assert await hub.publish("ev", {"n": 1}, pub_id="cli:1") is False
    assert await hub.publish("ev", {"n": 2}, pub_id="cli:2") is True
    # ids are deduped, not subjects: no-id publishes keep old semantics
    assert await hub.publish("ev", {"n": 3}) is True
    assert hub._subject_seq["ev"] == 3
    await hub.close()

    hub2 = DurableHub(tmp_path)
    assert hub2._subject_seq["ev"] == 3  # replay applied each event once
    assert await hub2.publish("ev", {"n": 1}, pub_id="cli:1") is False
    assert hub2._subject_seq["ev"] == 3
    await hub2.close()


async def test_remote_publish_retry_dedups_on_server():
    """The RemoteHub wire path: a re-sent publish frame with the same
    pub_id (what _call's reconnect retry produces) applies once."""
    from dynamo_tpu_torch.runtime.hub_server import HubServer

    server = HubServer(port=0)
    await server.start()
    hub = await RemoteHub.connect(f"127.0.0.1:{server.port}")
    try:
        assert await hub.publish("s", {"a": 1}) is True  # id auto-attached
        # simulate the retransmit after a lost ack: same id twice — the
        # dedup verdict propagates over the wire
        assert await hub.publish("s", {"a": 2}, pub_id="me:1") is True
        assert await hub.publish("s", {"a": 2}, pub_id="me:1") is False
        assert server.hub._subject_seq["s"] == 2
    finally:
        await hub.close()
        await server.stop()


# -- the disk format: one op sequence through both packages -----------------

PKG = {"port": (hub_store, hub_replica), "ref": (jax_store, jax_replica)}


def _value(rng, i: int):
    """A hub value of one of the wire's types, from ``rng``."""
    kind = int(rng.integers(0, 7))
    if kind == 0:
        return int(rng.integers(-2**40, 2**40))
    if kind == 1:
        return float(rng.standard_normal())
    if kind == 2:
        return f"v{i}-" + "x" * int(rng.integers(0, 40))
    if kind == 3:
        return bytes(rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8))
    if kind == 4:
        return {"port": int(rng.integers(1, 65536)), "tags": ["a", None, True],
                "nested": {"f": float(rng.uniform()), "n": -int(rng.integers(1, 200))}}
    if kind == 5:
        return [int(x) for x in rng.integers(0, 1000, int(rng.integers(0, 20)))]
    return None


async def _story(hub, seed: int, snapshot_at: int | None = None) -> None:
    """A fixed op sequence from ``seed``: puts (leased and not), creates,
    deletes, leases granted and revoked, publishes (some retried under their
    pub_id), purges, objects put and deleted. ``snapshot_at``: an inline
    snapshot after that many steps (the WAL rotates)."""
    rng = np.random.default_rng(seed)
    leases = [await hub.grant_lease(float(rng.uniform(30.0, 90.0))) for _ in range(3)]
    keys: list[str] = []
    for i in range(120):
        if i == snapshot_at:
            hub._snapshot_inline()
        op = int(rng.integers(0, 9))
        if op <= 2 or not keys:
            key = f"k/{int(rng.integers(0, 40))}"
            lease = leases[int(rng.integers(0, len(leases)))] if op == 1 and leases else None
            await hub.put(key, _value(rng, i), lease)
            keys.append(key)
        elif op == 3:
            try:
                await hub.create(f"c/{int(rng.integers(0, 10))}", _value(rng, i))
            except Exception as e:  # noqa: BLE001 - KeyExists of either package
                assert type(e).__name__ == "KeyExists"
        elif op == 4:
            await hub.delete(keys[int(rng.integers(0, len(keys)))])
        elif op == 5:
            pid = f"p:{int(rng.integers(0, 30))}" if rng.uniform() < 0.6 else None
            await hub.publish(f"ev.{int(rng.integers(0, 3))}", _value(rng, i), pub_id=pid)
        elif op == 6:
            subj = f"ev.{int(rng.integers(0, 3))}"
            if rng.uniform() < 0.5:
                await hub.purge_subject(subj, up_to_seq=int(rng.integers(0, 8)))
            else:
                await hub.purge_subject(subj, keep_last=int(rng.integers(0, 4)))
        elif op == 7:
            name = f"blob{int(rng.integers(0, 6))}"
            if rng.uniform() < 0.7:
                await hub.put_object("cards", name, bytes(rng.integers(
                    0, 256, int(rng.integers(0, 500)), dtype=np.uint8)))
            else:
                await hub.delete_object("cards", name)
        elif leases and rng.uniform() < 0.3:
            await hub.revoke_lease(leases.pop(int(rng.integers(0, len(leases)))))
        else:
            leases.append(await hub.grant_lease(float(rng.uniform(30.0, 90.0))))


def _state(hub) -> dict:
    """Everything a recovery restores, in comparable form."""
    return {
        "boot_id": hub.boot_id,
        "kv": dict(hub._kv),
        "key_lease": dict(hub._key_lease),
        "leases": {lid: (le.ttl, sorted(le.keys)) for lid, le in hub._leases.items()},
        "next_lease": hub._next_lease,
        "subject_seq": dict(hub._subject_seq),
        "retained": {s: [list(x) for x in dq] for s, dq in hub._retained.items()},
        "objects": dict(hub._objects),
        "pub_ids": list(hub._seen_pub_ids),
        "wal_seq": hub.wal_seq,
        "repl": (hub.repl_epoch, hub.repl_cursor, hub.last_rec_epoch),
    }


def _files(d: Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir()) if p.is_file()}


@pytest.mark.parametrize("snapshot_at", [None, 60])
@pytest.mark.parametrize("seed", [0, 1])
async def test_disk_format_equals_the_reference(tmp_path, seed, snapshot_at):
    """The same op sequence through both DurableHubs: every WAL file
    byte-equal, the snapshot equal once decoded with boot_id masked."""
    files = {}
    for pkg, (store, _rep) in PKG.items():
        hub = store.DurableHub(tmp_path / pkg)
        await _story(hub, seed, snapshot_at)
        await hub.close()
        files[pkg] = _files(tmp_path / pkg)
    assert sorted(files["port"]) == sorted(files["ref"])
    wals = [n for n in files["port"] if n.startswith("hub.wal.")]
    assert wals == [f"hub.wal.{1 if snapshot_at is None else 2}"]
    for name in wals:
        assert files["port"][name] == files["ref"][name], name
    snaps = {pkg: msgpack.unpackb(f["hub.snap"], raw=False) for pkg, f in files.items()}
    assert snaps["port"].pop("boot_id") != snaps["ref"].pop("boot_id")
    assert snaps["port"] == snaps["ref"]


async def test_replicated_wal_and_term_files_equal_the_reference(tmp_path):
    """ReplicatedHub: the same replicated records (leader-stamped), a vote,
    a promotion and writes as leader give byte-equal WALs and hub.term."""
    rng = np.random.default_rng(7)
    recs = [{"op": "lease", "id": 1, "ttl": 30.0, "e": 2}] + [
        {"op": "put", "k": f"k/{i}", "v": _value(rng, i), "l": 1 if i % 3 == 0 else None,
         "e": 2} for i in range(12)] + [
        {"op": "pub", "s": "ev", "p": _value(rng, 99), "pid": "x:1", "e": 2}]
    files = {}
    for pkg, (_store, rep) in PKG.items():
        hub = rep.ReplicatedHub(tmp_path / pkg)
        for seq, rec in enumerate(recs, 1):
            await hub.apply_replicated(rec, seq, epoch=2)
        hub.record_vote(3, "127.0.0.1:7001")
        term_voted = (tmp_path / pkg / "hub.term").read_bytes()
        hub.promote(4, addr="127.0.0.1:7001")
        await hub.put("after/promote", {"n": 1})
        await hub.publish("ev", {"n": 2})
        await hub.close()
        files[pkg] = dict(_files(tmp_path / pkg), voted=term_voted)
    for name in ("hub.wal.1", "hub.term", "voted"):
        assert files["port"][name] == files["ref"][name], name


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("snapshot_at", [None, 45])
async def test_each_package_recovers_the_others_data_dir(tmp_path, writer, snapshot_at):
    """A data dir one package wrote (WAL only, or snapshot + WAL, then a
    torn tail) recovers in the other to the writer's state: keys and lease
    bindings, leases, subjects with seqs, objects, dedup window, boot_id."""
    reader = "ref" if writer == "port" else "port"
    hub = PKG[writer][0].DurableHub(tmp_path)
    await _story(hub, 11, snapshot_at)
    want = _state(hub)
    await hub.close()
    with open(tmp_path / f"hub.wal.{hub.store.gen}", "ab") as f:
        f.write(b"\x00\x00\x08\x00torn")
    got = PKG[reader][0].DurableHub(tmp_path)
    try:
        assert _state(got) == want
        # and it goes on: a retried publish dedups, a new one continues the seqs
        assert await got.publish("ev.0", 1, pub_id=want["pub_ids"][-1]) is False
        await got.publish("ev.0", 2)
        assert got._subject_seq["ev.0"] == want["subject_seq"].get("ev.0", 0) + 1
    finally:
        await got.close()


@pytest.mark.parametrize("writer", ["port", "ref"])
async def test_replica_term_state_crosses_packages(tmp_path, writer):
    """A replica's durable election state written by one package (the term
    file's vote, the records' epochs, the replication cursor) is what the
    other package's ReplicatedHub recovers."""
    reader = "ref" if writer == "port" else "port"
    hub = PKG[writer][1].ReplicatedHub(tmp_path)
    for seq in range(1, 6):
        await hub.apply_replicated({"op": "put", "k": f"k{seq}", "v": seq, "l": None,
                                    "e": 3}, seq, epoch=3)
    hub.record_vote(5, "10.0.0.1:7701")
    want = (_state(hub), hub.voted_for)
    await hub.close()
    got = PKG[reader][1].ReplicatedHub(tmp_path)
    try:
        assert (_state(got), got.voted_for) == want
        assert want[0]["repl"] == (5, 5, 3)
    finally:
        await got.close()
