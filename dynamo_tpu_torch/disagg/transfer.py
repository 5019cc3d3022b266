"""KV-block transfer plane (the port's counterpart of
dynamo_tpu/disagg/transfer.py).

The prefill worker exports a finished prompt's KV blocks (what the
family's ``extract_pages`` gathers: ``[L, n, KH, page, D]`` x2, the packed
``uint8 [L, n, X]`` x2 of fp8 pools, or MLA's latent blocks and its inert
int8 v slot); the decode worker pulls them by ``transfer_id`` and installs
them into its own pool. The ``kv_transfer_params`` ride the request and
response path; the payload moves worker to worker.

Three routes, chosen by locality:

- in-process (``_LOCAL_SOURCES``): the puller takes the exported blocks
  themselves. A device export's tensors are read only after the CUDA event
  recorded behind their gather (the puller waits on it in its pull
  thread): two engines in one process on one card share no stream order
  anyone enforces across their threads.
- device (CUDA IPC, one card): the source answers an ``ipc`` control op
  with ``torch.multiprocessing.reductions`` handles of the exported
  tensors' storage, as JSON; the puller opens them, copies the blocks into
  its own memory, waits for the copy, then releases the export (the
  reference's PJRT pull, ``block_until_ready`` before ``release``). On by
  default for CUDA exports; ``DYNAMO_DEVICE_TRANSFER=0/1`` overrides it on
  either side. Params name it ``cuda_ipc``, a key the JAX reader does not
  read, so a JAX puller goes straight to TCP. A failed device pull logs and
  takes TCP (``PULLS.route_fallbacks``).
- TCP host staging: a JSON control line, then ``>Q``-length-prefixed raw
  bytes of k and v, the reference's wire. A host export is stamped with
  ``kv_checksum`` at export; a device export's device-to-host copy and
  stamp run at serve time, in a thread. bf16 crosses as its ``uint16``
  bits named ``"bfloat16"`` (so a JAX puller reads a port export, and the
  CRC is the reference's over the same bytes), and the pulled numpy block
  carries bf16 as ``uint16`` bits (kvbm/offload.py ``block_tensor`` views
  them back). The header adds ``v_dtype``, which the JAX reader ignores;
  the port's reader takes it when present and the single ``dtype``
  otherwise, so MLA's latent blocks (f32, bf16 or packed) cross with their
  int8 v slot.

Per-shard exports (a prefill group under tensor parallelism, the
reference's ``shard_layout`` / ``_dest_tp_devices``): rank r of a tp group
holds KV heads ``[r KH/N, (r+1) KH/N)`` and exports them from its own
source under the leader's ``transfer_id``. The leader's params carry the
reference's ``shard_axis`` (2, the KV-head axis) and ``shards``, a list of
``{start, k_shape, v_shape}``, each with the port's own ``addr``,
``transfer_id``, ``source_uid`` and ``cuda_ipc``. A decode group of the
same width pulls shard r on rank r (``pull_kv_blocks(params, shard=r)``);
any other puller (the JAX package's TCP ``pull``, a decode group of
another width) pulls the whole export from the leader, whose server
joins the shards on the heads axis (``join_heads``; a packed fp8 shard is
unpacked, joined and repacked, so the whole block is the one a one-rank
pool packs) under one checksum over the whole, as the reference's
``np.asarray`` of a sharded array does. A shard's pull or release names
only its own (``"shard": true`` on the control line). ``release_kv_blocks``
of a sharded export's params releases every shard at its own source: the
leader's entry is gone once shard 0 was pulled, so its cascade (a plain
``release`` at the leader's server, what a JAX client sends) cannot be
relied on.
"""

from __future__ import annotations

import asyncio
import collections
import importlib
import json
import logging
import os
import socket
import struct
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from dynamo_tpu_torch.kvbm.offload import block_numpy
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.runtime.integrity import kv_checksum, verify_checksum

log = logging.getLogger("dynamo_tpu_torch.disagg.transfer")

_LEN = struct.Struct(">Q")
ROUTES = ("local", "device", "tcp")


def device_transfer_enabled() -> bool:
    """The CUDA IPC route's switch: on unless ``DYNAMO_DEVICE_TRANSFER`` is
    0/false/off (it applies only to CUDA exports)."""
    env = (os.environ.get("DYNAMO_DEVICE_TRANSFER") or "").strip().lower()
    return env not in ("0", "false", "off")


def _dtype_name(x) -> str:
    """The wire name of a block's element type (``bfloat16`` for bf16)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.dtype(x.dtype).name


def _np_dtype(name: str) -> np.dtype:
    """Numpy type of a wire name: bf16 arrives as its ``uint16`` bits."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _host_array(x) -> np.ndarray:
    """A host block as a contiguous numpy array (bf16 as ``uint16`` bits)."""
    if isinstance(x, torch.Tensor):
        x = block_numpy(x.detach().cpu())
    return np.ascontiguousarray(x)


def _device_to_host(xs, ready) -> list[np.ndarray]:
    """Device blocks to host numpy: on a stream of their own, from the
    export's event, into pinned memory. The default stream would put the
    copy behind whatever the engine queued since the gather."""
    stream = torch.cuda.Stream(xs[0].device)
    stream.wait_event(ready)
    with torch.cuda.stream(stream):
        out = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in xs]
        for o, x in zip(out, xs):
            o.copy_(x, non_blocking=True)
    stream.synchronize()
    return [block_numpy(o) for o in out]


def _byte_view(a: np.ndarray) -> memoryview:
    return memoryview(a).cast("B") if a.size else memoryview(b"")


def _cat(parts, axis: int):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=axis)
    return np.concatenate(parts, axis=axis)


def _unpack_heads(block, heads: int):
    """A packed fp8 block ``[L, n, X]`` of ``heads`` KV heads as (values
    ``[L, n, heads, E]``, scale bytes ``[L, n, heads, 2]``):
    ``quant.pack_pages``' byte order, values then bf16 scales."""
    L, n, X = block.shape
    e = (X - 2 * heads) // heads
    return (block[:, :, : heads * e].reshape(L, n, heads, e),
            block[:, :, heads * e:].reshape(L, n, heads, 2))


def join_heads(parts, heads: list[int], packed: bool):
    """Blocks of consecutive KV-head shards (``heads[i]`` heads each, in
    head order) as one block of all the heads: ``[L, n, KH, page, D]``
    joined on axis 2, or packed fp8 blocks unpacked, joined and repacked
    (the bytes a one-rank pool packs). numpy or torch alike."""
    if len(parts) == 1:
        return parts[0]
    if not packed:
        return _cat(list(parts), 2)
    vals, scales = zip(*(_unpack_heads(p, h) for p, h in zip(parts, heads)))
    v, s = _cat(list(vals), 2), _cat(list(scales), 2)
    L, n = v.shape[:2]
    return _cat([v.reshape(L, n, -1), s.reshape(L, n, -1)], 2)


def split_heads(block, kv_heads: int, n: int, r: int, packed: bool):
    """Shard ``r`` of ``n`` of a block of ``kv_heads`` KV heads: heads
    ``[r kv_heads/n, (r+1) kv_heads/n)`` (``join_heads``' inverse)."""
    if n == 1:
        return block
    h = kv_heads // n
    if not packed:
        return block[:, :, r * h:(r + 1) * h]
    v, s = _unpack_heads(block, kv_heads)
    L, nb = v.shape[:2]
    return _cat([v[:, :, r * h:(r + 1) * h].reshape(L, nb, -1),
                 s[:, :, r * h:(r + 1) * h].reshape(L, nb, -1)], 2)


def shard_params(params: dict, r: int) -> dict:
    """The pull params of shard ``r`` of a sharded export: its own source
    and transfer id, the export's token count, page size and pool type."""
    s = params["shards"][r]
    out = {k: params[k] for k in ("num_tokens", "page_size", "kv_dtype") if k in params}
    out.update(transfer_id=s["transfer_id"], addr=s["addr"],
               source_uid=s["source_uid"], shard=True)
    if s.get("cuda_ipc"):
        out["cuda_ipc"] = True
    return out


class PullStats:
    """Pulls by route, the device route's fallbacks to TCP, and each pull's
    bytes, start and end (host clock, s) and times (ms): ``control`` (the
    control round trip and, on TCP, the header), ``open`` (IPC handle
    opens), ``copy`` (the device copy, or the TCP body reads),
    ``checksum`` and ``total``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.pulls = {r: 0 for r in ROUTES}
            self.route_fallbacks = 0
            self.records: collections.deque = collections.deque(maxlen=4096)

    def note(self, route: str, nbytes: int, start: float, **ms: float) -> None:
        """One pull that began at ``start`` (host clock, s) and ends now."""
        with self._lock:
            self.pulls[route] += 1
            self.records.append({"route": route, "bytes": int(nbytes), "start": start,
                                 "end": time.perf_counter(), **ms})

    def fallback(self) -> None:
        with self._lock:
            self.route_fallbacks += 1

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {"pulls": dict(self.pulls),
                    "route_fallbacks": self.route_fallbacks,
                    "records": list(self.records)}


PULLS = PullStats()
# how long a shard pull waits for its rank to export the shard (under the
# pull's own 30 s socket timeout)
SHARD_WAIT_S = 10.0


@dataclass
class _Export:
    # torch tensors on the card (a device export) or numpy (a host export)
    k: Any
    v: Any
    meta: dict
    dtypes: tuple[str, str]
    ready: Any = None  # CUDA event recorded behind a device export's gather
    created: float = field(default_factory=time.monotonic)
    on_done: Callable[[], None] | None = None
    # a sharded export's leader: every shard's entry (this source's own
    # among them) and whether the blocks are packed fp8
    shards: list | None = None
    packed: bool = False

    @property
    def on_device(self) -> bool:
        return isinstance(self.k, torch.Tensor) and self.k.is_cuda

    def wait_ready(self) -> None:
        if self.ready is not None:
            self.ready.synchronize()

    def host_blocks(self) -> tuple[np.ndarray, np.ndarray, int]:
        """(k, v, checksum) on the host: a device export copies and stamps
        here (blocking: call in a thread)."""
        if not self.on_device:
            return self.k, self.v, self.meta["checksum"]
        k, v = _device_to_host((self.k, self.v), self.ready)
        return k, v, kv_checksum(k, v)

    def whole_blocks(self, own_uid: str) -> tuple[np.ndarray, np.ndarray, int]:
        """(k, v, checksum) of every shard joined on the heads axis: this
        source's own blocks, the others pulled over TCP from their sources
        (blocking: call in a thread). The checksum is over the whole."""
        if not self.shards:
            return self.host_blocks()
        ks, vs = [], []
        for s in self.shards:
            if s["source_uid"] == own_uid:
                k, v, _crc = self.host_blocks()
            else:
                k, v, _meta = _pull_tcp({**s, "shard": True}, 30.0, note=False)
            ks.append(k)
            vs.append(v)
        # shards are equal: each holds the heads between two starts
        heads = [self.shards[1]["start"] - self.shards[0]["start"]] * len(ks)
        k, v = join_heads(ks, heads, self.packed), join_heads(vs, heads, self.packed)
        k, v = np.ascontiguousarray(k), np.ascontiguousarray(v)
        return k, v, kv_checksum(k, v)

    @property
    def nbytes(self) -> int:
        return int(self.k.nbytes + self.v.nbytes)


# in-process registry: source uid -> KvTransferSource (the zero-copy route)
_LOCAL_SOURCES: dict[str, "KvTransferSource"] = {}
_LOCAL_LOCK = threading.Lock()


# -- CUDA IPC handles as JSON -------------------------------------------------

_IPC_CLASSES = {"torch.Tensor", "torch.nn.parameter.Parameter",
                "torch.storage.TypedStorage", "torch.storage.UntypedStorage"}


def _ipc_encode(x):
    if isinstance(x, bytes):
        return {"b": x.hex()}
    if isinstance(x, torch.dtype):
        return {"dtype": str(x).removeprefix("torch.")}
    if isinstance(x, torch.device):
        return {"device": str(x)}
    if isinstance(x, type):
        return {"cls": f"{x.__module__}.{x.__qualname__}"}
    if isinstance(x, (tuple, list)):
        return {"t": [_ipc_encode(i) for i in x]}
    return x


def _ipc_decode(x):
    if not isinstance(x, dict):
        return x
    if "b" in x:
        return bytes.fromhex(x["b"])
    if "dtype" in x:
        return getattr(torch, x["dtype"])
    if "device" in x:
        return torch.device(x["device"])
    if "cls" in x:
        name = x["cls"]
        if name not in _IPC_CLASSES:
            raise ValueError(f"unexpected class {name!r} in a CUDA IPC handle")
        mod, attr = name.rsplit(".", 1)
        return getattr(importlib.import_module(mod), attr)
    return tuple(_ipc_decode(i) for i in x["t"])


def _ipc_handle(t: torch.Tensor) -> dict:
    from torch.multiprocessing.reductions import reduce_tensor

    _fn, args = reduce_tensor(t)
    return _ipc_encode(args)


def _ipc_open(handle: dict) -> torch.Tensor:
    from torch.multiprocessing.reductions import rebuild_cuda_tensor

    return rebuild_cuda_tensor(*_ipc_decode(handle))


class KvTransferSource:
    """Export table + TCP server on the prefill side, one per engine.
    ``export()`` registers blocks and returns the ``kv_transfer_params`` the
    decode worker pulls them with; unclaimed exports are dropped after
    ``ttl_s`` (their device tensors freed)."""

    def __init__(self, *, host: str = "127.0.0.1", port: int = 0,
                 ttl_s: float = 120.0):
        self.host = host
        self.port = port
        self.ttl_s = ttl_s
        self.uid = uuid.uuid4().hex
        self._exports: dict[str, _Export] = {}
        self._lock = threading.Lock()
        self._server: asyncio.AbstractServer | None = None
        self._gc_task: asyncio.Task | None = None
        self.exported = 0  # exports made
        # a tp prefill group's leader: the other ranks' sources ({addr,
        # uid}, ranks 1..tp-1), which its sharded exports name
        self.peers: list[dict] = []
        # host ms of the serve-time device-to-host copy + stamp per TCP pull
        # of a device export
        self.stage_ms: collections.deque = collections.deque(maxlen=4096)

    async def start(self) -> "KvTransferSource":
        if self._server is None:
            self._server = await asyncio.start_server(self._handle, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]
            self._gc_task = asyncio.get_running_loop().create_task(self._gc_loop())
            with _LOCAL_LOCK:
                _LOCAL_SOURCES[self.uid] = self
        return self

    async def close(self) -> None:
        with _LOCAL_LOCK:
            _LOCAL_SOURCES.pop(self.uid, None)
        if self._gc_task is not None:
            self._gc_task.cancel()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        with self._lock:
            pending = list(self._exports.values())
            self._exports.clear()
        for e in pending:
            if e.on_done:
                e.on_done()

    # -- export (prefill side) --------------------------------------------

    def export(self, k_blocks, v_blocks, *, num_tokens: int, page_size: int,
               on_done: Callable[[], None] | None = None,
               transfer_id: str | None = None) -> dict:
        """Register blocks (torch tensors or numpy arrays); returns the
        kv_transfer_params. CUDA tensors stay on the card, behind an event
        recorded on the current stream (the caller's gather); anything else
        is staged to host numpy and stamped now. ``transfer_id``: a tp
        follower's shard registers under its leader's id."""
        tid = transfer_id or uuid.uuid4().hex
        params = {
            "transfer_id": tid,
            "source_uid": self.uid,
            "addr": f"{self.host}:{self.port}",
            "num_tokens": num_tokens,
            "page_size": page_size,
        }
        meta = {"num_tokens": num_tokens, "page_size": page_size}
        dtypes = (_dtype_name(k_blocks), _dtype_name(v_blocks))
        ready = None
        if isinstance(k_blocks, torch.Tensor) and k_blocks.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(k_blocks.device))
            if device_transfer_enabled():
                params["cuda_ipc"] = True
        else:
            k_blocks, v_blocks = _host_array(k_blocks), _host_array(v_blocks)
            # stamped at export: corruption while the blocks sit in the
            # table is caught too, not only on the wire
            meta["checksum"] = kv_checksum(k_blocks, v_blocks)
        with self._lock:
            self._exports[tid] = _Export(k_blocks, v_blocks, meta, dtypes, ready,
                                         on_done=on_done)
            self.exported += 1
        return params

    def shard(self, tid: str, shards: list[dict], packed: bool) -> None:
        """Make export ``tid`` the leader of a sharded export: ``shards``
        is every shard's entry (``shard_params``' source), this source's
        among them. A whole pull joins them; a plain release releases them."""
        with self._lock:
            e = self._exports.get(tid)
            if e is not None:
                e.shards, e.packed = list(shards), packed

    def _take(self, tid: str) -> _Export | None:
        with self._lock:
            return self._exports.pop(tid, None)

    def release(self, tid: str, cascade: bool = True) -> None:
        """Drop export ``tid``; a sharded export's leader also releases the
        other shards (``cascade``), in the background."""
        e = self._take(tid)
        if e is None:
            return
        if e.on_done:
            e.on_done()
        peers = [sh for sh in e.shards or () if sh["source_uid"] != self.uid]
        if cascade and peers:
            def _release_peers() -> None:
                for sh in peers:
                    release_kv_blocks({**sh, "shard": True})

            threading.Thread(target=_release_peers, name="kv-release-shards",
                             daemon=True).start()

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._exports)

    # -- TCP server --------------------------------------------------------

    @staticmethod
    async def _reply(writer: asyncio.StreamWriter, obj: dict) -> None:
        writer.write(json.dumps(obj).encode() + b"\n")
        await writer.drain()

    def _ipc_reply(self, tid: str) -> dict:
        """The device route's answer: IPC handles of a device export, which
        stays in the table until the puller releases it. The handles carry
        an event the puller's stream waits on; it is recorded on a stream
        that waits only for the export's gather, not for what the engine
        queued since on its own."""
        with self._lock:
            e = self._exports.get(tid)
        if e is None:
            return {"ok": False, "error": "unknown transfer_id"}
        if not e.on_device:
            return {"ok": False, "error": "not a device export"}
        stream = torch.cuda.Stream(e.k.device)
        stream.wait_event(e.ready)
        with torch.cuda.stream(stream):
            return {"ok": True, "k": _ipc_handle(e.k), "v": _ipc_handle(e.v), **e.meta}

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            req = json.loads(await reader.readline())
            op, tid = req.get("op"), req.get("transfer_id", "")
            own = bool(req.get("shard"))  # this source's shard only
            if op == "release":
                self.release(tid, cascade=not own)
                await self._reply(writer, {"ok": True})
                return
            if op == "ipc":
                await self._reply(writer, await asyncio.to_thread(self._ipc_reply, tid))
                return
            if op != "pull":
                await self._reply(writer, {"ok": False, "error": "bad op"})
                return
            e = self._take(tid)
            if e is None and own:
                e = await self._await_shard(tid)
            if e is None:
                await self._reply(writer, {"ok": False, "error": "unknown transfer_id"})
                return
            # a device export's copy to the host and its stamp must not
            # block the event loop of the serving process; a whole pull of
            # a sharded export gathers the other shards too
            t0 = time.perf_counter()
            try:
                if own or not e.shards:
                    k, v, crc = await asyncio.to_thread(e.host_blocks)
                else:
                    k, v, crc = await asyncio.to_thread(e.whole_blocks, self.uid)
            except (OSError, KeyError, ValueError) as err:
                # a shard's source is gone: the puller falls back
                await self._reply(writer, {"ok": False, "error": f"shard pull failed: {err}"})
                return
            if e.on_device:
                self.stage_ms.append(1e3 * (time.perf_counter() - t0))
            header = {"ok": True, "dtype": e.dtypes[0], "v_dtype": e.dtypes[1],
                      "k_shape": list(k.shape), "v_shape": list(v.shape),
                      **e.meta, "checksum": crc}
            writer.write(json.dumps(header).encode() + b"\n")
            for a in (k, v):
                writer.write(_LEN.pack(a.nbytes))
                writer.write(_byte_view(a))
            await writer.drain()
            if e.on_done:
                e.on_done()
        except (ConnectionError, json.JSONDecodeError, asyncio.IncompleteReadError):
            log.warning("kv transfer connection error", exc_info=True)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass

    async def _await_shard(self, tid: str) -> _Export | None:
        """A shard export not made yet, taken once it is (at most
        SHARD_WAIT_S). Rank r of a tp group exports its shard when it
        replays the leader's ``kv_export``; a puller that already holds the
        leader's params (the leader joining a whole pull, or a decode rank's
        prefetch) can ask before a lagging rank has replayed it."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + SHARD_WAIT_S
        while loop.time() < deadline:
            await asyncio.sleep(0.005)
            e = self._take(tid)
            if e is not None:
                return e
        return None

    async def _gc_loop(self) -> None:
        try:
            while True:
                await asyncio.sleep(self.ttl_s / 4)
                cutoff = time.monotonic() - self.ttl_s
                with self._lock:
                    stale = [t for t, e in self._exports.items() if e.created < cutoff]
                for t in stale:
                    log.warning("kv transfer %s expired unclaimed", t)
                    self.release(t)
        except asyncio.CancelledError:
            pass


# -- pull client (decode side) ---------------------------------------------


def _connect(addr: str, timeout: float) -> socket.socket:
    host, port = addr.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)), timeout=timeout)
    sock.settimeout(timeout)
    return sock


def _tcp_request(addr: str, obj: dict, timeout: float = 10.0) -> dict:
    """One-line JSON request/response over the source's control socket."""
    with _connect(addr, timeout) as sock:
        f = sock.makefile("rwb")
        f.write(json.dumps(obj).encode() + b"\n")
        f.flush()
        return json.loads(f.readline())


def _pull_device(params: dict, timeout: float) -> tuple:
    """The CUDA IPC pull: open the source's handles and copy the blocks into
    this process's memory on a stream of their own (the opens make it wait
    on the source's event; the engine's stream, busy with decode, stays out
    of it), wait for the copy, drop the opened tensors, then release the
    export. The copies are the caller's; a consumer on another stream
    records it on them."""
    t0 = time.perf_counter()
    resp = _tcp_request(params["addr"], {"op": "ipc", "transfer_id": params["transfer_id"]},
                        timeout)
    if not resp.get("ok"):
        raise RuntimeError(f"device pull refused: {resp.get('error')}")
    t1 = time.perf_counter()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        k_ipc, v_ipc = _ipc_open(resp["k"]), _ipc_open(resp["v"])
        t2 = time.perf_counter()
        k, v = k_ipc.clone(), v_ipc.clone()
    stream.synchronize()
    t3 = time.perf_counter()
    del k_ipc, v_ipc
    # the copies are in: the release (a round trip to a busy source) need
    # not hold up the resume
    threading.Thread(target=release_kv_blocks, args=(params,), name="kv-release",
                     daemon=True).start()
    meta = {n: resp[n] for n in ("num_tokens", "page_size") if n in resp}
    PULLS.note("device", k.nbytes + v.nbytes, t0, control=1e3 * (t1 - t0),
               open=1e3 * (t2 - t1), copy=1e3 * (t3 - t2),
               total=1e3 * (time.perf_counter() - t0))
    return k, v, meta


def _read_exact(f, n: int) -> bytearray:
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        r = f.readinto(view[got:])
        if not r:
            raise ConnectionError("short read in kv transfer")
        got += r
    return buf


def _pull_tcp(params: dict, timeout: float, note: bool = True) -> tuple:
    """The TCP pull: a control line, the header, then k and v as raw bytes;
    the checksum is verified before the bytes become KV. ``params`` with
    ``shard`` set asks for that source's own shard only."""
    t0 = time.perf_counter()
    with _connect(params["addr"], timeout) as sock:
        f = sock.makefile("rwb")
        req = {"op": "pull", "transfer_id": params["transfer_id"]}
        if params.get("shard"):
            req["shard"] = True
        f.write(json.dumps(req).encode() + b"\n")
        f.flush()
        header = json.loads(f.readline())
        if not header.get("ok"):
            raise KeyError(f"kv transfer pull failed: {header.get('error')}")
        t1 = time.perf_counter()
        bufs = []
        for _ in range(2):
            (n,) = _LEN.unpack(bytes(_read_exact(f, _LEN.size)))
            # corrupt fault = bits flipped on the wire; the checksum below
            # must catch it before the bytes become KV
            bufs.append(FAULTS.corrupt_bytes("disagg.pull", _read_exact(f, n)))
    t2 = time.perf_counter()
    verify_checksum(header.get("checksum"), *bufs, path="disagg.pull")
    t3 = time.perf_counter()
    k_dt = header["dtype"]
    v_dt = header.get("v_dtype", k_dt)  # the JAX wire names one type
    k, v = (np.frombuffer(b, dtype=_np_dtype(dt)).reshape(header[shape])
            for b, dt, shape in zip(bufs, (k_dt, v_dt), ("k_shape", "v_shape")))
    meta = {n: header[n] for n in ("num_tokens", "page_size") if n in header}
    if note:
        PULLS.note("tcp", k.nbytes + v.nbytes, t0, control=1e3 * (t1 - t0),
                   copy=1e3 * (t2 - t1), checksum=1e3 * (t3 - t2),
                   total=1e3 * (time.perf_counter() - t0))
    return k, v, meta


def pull_kv_blocks(params: dict, timeout: float = 30.0,
                   shard: int | None = None) -> tuple[Any, Any, dict]:
    """Pull exported KV blocks. Blocking: call from a worker thread.

    Returns (k, v, meta): the exported tensors themselves in process (CUDA
    tensors once their gather has finished, else numpy), fresh CUDA tensors
    on the device route, numpy on TCP (bf16 as ``uint16`` bits). Exports
    are one-shot: a second pull raises KeyError. ``shard`` pulls shard r of
    a sharded export from its own source; without it a sharded export is
    pulled whole (the leader joins the shards; no device route)."""
    if FAULTS.enabled:
        # the transfer plane failing mid-handoff (the prefill worker died
        # between export and pull): the engine falls back to a full local
        # prefill, so disagg stays strictly an optimization
        FAULTS.fire_sync("disagg.pull")
    if shard is not None:
        params = shard_params(params, shard)
    tid = params["transfer_id"]
    t0 = time.perf_counter()
    src = _LOCAL_SOURCES.get(params.get("source_uid", ""))
    if src is not None:
        e = src._take(tid)
        if e is None:
            raise KeyError(f"unknown transfer_id {tid}")
        e.wait_ready()
        if e.on_done:
            e.on_done()
        if e.shards and not params.get("shard"):
            k, v, _crc = e.whole_blocks(src.uid)
            PULLS.note("local", k.nbytes + v.nbytes, t0,
                       total=1e3 * (time.perf_counter() - t0))
            return k, v, e.meta
        PULLS.note("local", e.nbytes, t0, total=1e3 * (time.perf_counter() - t0))
        return e.k, e.v, e.meta

    whole_of_shards = params.get("shards") and not params.get("shard")
    if params.get("cuda_ipc") and device_transfer_enabled() and not whole_of_shards:
        try:
            return _pull_device(params, timeout)
        except Exception:  # noqa: BLE001 - any device failure takes TCP
            log.warning("device KV pull failed; falling back to host staging",
                        exc_info=True)
            PULLS.fallback()
    return _pull_tcp(params, timeout)


def release_kv_blocks(params: dict, timeout: float = 5.0) -> None:
    """Tell the source an export will not be pulled (or was pulled over
    the device route). A sharded export's params release every shard at
    its own source (a shard already pulled is a no-op there)."""
    own = bool(params.get("shard"))
    if params.get("shards") and not own:
        for r in range(len(params["shards"])):
            release_kv_blocks(shard_params(params, r), timeout)
        return
    src = _LOCAL_SOURCES.get(params.get("source_uid", ""))
    if src is not None:
        src.release(params["transfer_id"], cascade=not own)
        return
    req = {"op": "release", "transfer_id": params["transfer_id"]}
    if own:
        req["shard"] = True
    try:
        _tcp_request(params["addr"], req, timeout)
    except OSError:
        log.warning("kv transfer release failed (source will GC)", exc_info=True)
