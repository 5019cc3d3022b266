"""The port's RemoteHub against the JAX package's replicated hub
(dynamo_tpu/runtime/hub_replica.py): the client-side multi-address
failover held against the JAX RemoteHub on the same scenarios.

Each scenario starts an in-process three-replica cluster (as
tests/test_hub_replication.py does), connects one client with the full
address list, stops the leader, and records what the client saw. The
port's client and the JAX client must see the same things:

- a write sent to a follower first is redirected to the leader;
- a prefix watch re-syncs across the failover (a key deleted while the
  client re-dialled arrives as one delete, a new put arrives once, and the
  events build the leader's state);
- a replay subscription crossing the failover delivers every event once,
  with its seq rising;
- a publish retried under the same ``pub_id`` after the failover is
  deduplicated by the elected leader (exactly once);
- two stale replicas naming each other as leader end the redirect chase
  with "redirect loop" after the hop limit, well inside the reconnect
  window.
"""

import asyncio
import time

import pytest

from dynamo_tpu.runtime.hub_client import RemoteHub as JaxRemoteHub
from dynamo_tpu.runtime.hub_replica import HubReplica
from dynamo_tpu_torch.runtime.hub_client import RemoteHub
from hub_cluster import free_port
from test_hub_replication import (
    _start_cluster,
    _stop_all,
    _wait_caught_up,
    _wait_single_leader,
)

pytestmark = pytest.mark.integration


async def _until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not pred():
        await asyncio.sleep(0.02)


async def _redirect_then_watch(cls, tmp_path):
    reps, addrs = await _start_cluster(tmp_path)
    client = wt = None
    try:
        leader = await _wait_single_leader(reps)
        followers = [r for r in reps if r is not leader]
        # a follower's address first: the first write bounces off it
        order = [f.advertise for f in followers] + [leader.advertise]
        client = await cls.connect(",".join(order), reconnect_window_s=15.0)
        await client.put("reg/a", 1)
        await client.put("reg/b", 2)
        on_leader = sorted((await leader.hub.get_prefix("reg/")).items())
        await _wait_caught_up(leader, followers)
        events = []

        async def watcher():
            async for ev in client.watch_prefix("reg/"):
                events.append((ev.kind, ev.key, ev.value))

        wt = asyncio.create_task(watcher())
        await _until(lambda: len(events) >= 2, 5)
        await leader.stop()
        new_leader = await _wait_single_leader(followers)
        await new_leader.hub.delete("reg/b")
        await client.put("reg/c", 3)
        await _until(lambda: ("put", "reg/c", 3) in events)
        await asyncio.sleep(0.2)  # a duplicate would land here
        # a re-sync re-yields the snapshot's puts, and whether reg/b's
        # delete lands before or after it is a race: compare what a
        # consumer builds from the events, and the deletes and new puts
        state = {}
        for kind, key, value in events:
            if kind == "put":
                state[key] = value
            else:
                state.pop(key, None)
        return (on_leader, events[:2], sorted(state.items()),
                events.count(("delete", "reg/b", None)),
                events.count(("put", "reg/c", 3)), await client.get("reg/c"))
    finally:
        if wt is not None:
            wt.cancel()
        if client is not None:
            await client.close()
        await _stop_all(reps)


async def _subscribe_and_pub_id(cls, tmp_path):
    reps, addrs = await _start_cluster(tmp_path)
    client = st = None
    try:
        leader = await _wait_single_leader(reps)
        followers = [r for r in reps if r is not leader]
        client = await cls.connect(",".join(addrs), reconnect_window_s=15.0)
        applied = [await client.publish("kv.ev", {"n": i}) for i in range(3)]
        applied.append(await client.publish("kv.ev", {"n": 3}, pub_id="op-7"))
        await _wait_caught_up(leader, followers)
        seen = []

        async def subscriber():
            async for _s, payload, seq in client.subscribe(
                "kv.ev", replay=True, with_seq=True
            ):
                seen.append((seq, payload["n"]))

        st = asyncio.create_task(subscriber())
        await _until(lambda: len(seen) >= 4, 5)
        await leader.stop()
        await _wait_single_leader(followers)
        # the retry of a publish whose ack was lost: the same pub_id
        applied.append(await client.publish("kv.ev", {"n": 3}, pub_id="op-7"))
        applied.append(await client.publish("kv.ev", {"n": 4}))
        await _until(lambda: any(n == 4 for _s, n in seen))
        await asyncio.sleep(0.2)  # a duplicate would land here
        seqs = [s for s, _n in seen]
        return applied, [n for _s, n in seen], seqs == sorted(set(seqs))
    finally:
        if st is not None:
            st.cancel()
        if client is not None:
            await client.close()
        await _stop_all(reps)


async def _redirect_loop(cls, tmp_path):
    # the chase ends after MAX_REDIRECT_HOPS bounces (32: ~15 s of
    # backoff); the same code path ends after 6 at a tenth of the wait
    cls = type(cls.__name__, (cls,), {"MAX_REDIRECT_HOPS": 6})
    ports = sorted(free_port() for _ in range(2))
    addrs = [f"127.0.0.1:{p}" for p in ports]
    reps = [HubReplica("127.0.0.1", p, ",".join(addrs), tmp_path / f"r{i}",
                       lease_s=30.0) for i, p in enumerate(ports)]
    client = None
    try:
        # servers only: both stay followers, each naming the other leader
        for r, other in zip(reps, reversed(reps)):
            await r.server.start()
            r.leader_addr = other.advertise
        client = await cls.connect(",".join(addrs), reconnect_window_s=60.0)
        t0 = time.monotonic()
        with pytest.raises(ConnectionError) as e:
            await client.put("spin", 1)
        return "redirect loop" in str(e.value), time.monotonic() - t0 < 10.0
    finally:
        if client is not None:
            await client.close()
        for r in reps:
            await r.server.stop()


_SCENARIOS = {
    "redirect_then_watch_resync": _redirect_then_watch,
    "subscribe_seq_and_pub_id_dedup": _subscribe_and_pub_id,
    "bounded_redirect_loop": _redirect_loop,
}

_EXPECTED = {
    "redirect_then_watch_resync": (
        [("reg/a", 1), ("reg/b", 2)], [("put", "reg/a", 1), ("put", "reg/b", 2)],
        [("reg/a", 1), ("reg/c", 3)], 1, 1, 3),
    "subscribe_seq_and_pub_id_dedup": (
        [True, True, True, True, False, True], [0, 1, 2, 3, 4], True),
    "bounded_redirect_loop": (True, True),
}


@pytest.mark.parametrize("scenario", list(_SCENARIOS))
async def test_port_client_fails_over_like_the_reference(scenario, tmp_path):
    """The same failover scenario through the JAX RemoteHub and the port's,
    each against its own JAX replica cluster: the same observations, and
    those the replicated hub promises."""
    run = _SCENARIOS[scenario]
    want = await run(JaxRemoteHub, tmp_path / "jax")
    got = await run(RemoteHub, tmp_path / "port")
    assert want == _EXPECTED[scenario], want
    assert got == want
