"""Host-DRAM, disk and hub-object-store block pools (tiers G2, G3, G4).

The port's copy of dynamo_tpu/kvbm/pool.py. Each pool maps ``sequence_hash
-> (k_block, v_block)``, a block being one page's KV across all layers as a
numpy array: ``[L, KH, page, D]`` in the pool's dtype, a packed ``uint8 [L,
X]`` on an fp8 pool, the latent ``[L, page, dc + dr]`` of an MLA pool (whose
v part is the reference's inert int8 slot). Numpy has no bf16 without
``ml_dtypes``, so a bf16 block travels as its ``uint16`` bits: the same
bytes, the same checksums.

G2 and G3 are byte-bounded LRUs (G3 keeps one ``.npy`` per block and a
``kvbm_index.json`` that survives a restart; its files are this worker's
own). G4 stores each block as one object of the hub's object store, shared
across workers: a JSON header (shape, dtype, checksum), then the k and v
bytes. A ``uint16`` block's header names ``bfloat16``, so the objects are
byte for byte the JAX package's and a worker of either package onboards
the other's. Every tier verifies a block's checksum on the way out; a
mismatch is a miss (and the block is evicted), never a decoded page.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
from collections import OrderedDict
from typing import Callable

import numpy as np

from dynamo_tpu_torch.runtime.integrity import (
    IntegrityError,
    kv_checksum,
    verify_checksum,
)

log = logging.getLogger("dynamo_tpu_torch.kvbm.pool")

# a bf16 block is carried as uint16 bits; the G4 header names the real dtype
_WIRE_DTYPE = {"uint16": "bfloat16"}
_HOST_DTYPE = {"bfloat16": np.dtype(np.uint16)}


def _corrupt_block(site: str, k: np.ndarray, v: np.ndarray):
    """Chaos hook: run the k-block bytes through the ``corrupt`` fault at
    ``site`` (a no-op unless a corrupt rule is armed). Returns a fresh pair
    when bits flipped, the originals otherwise."""
    from dynamo_tpu_torch.runtime.faults import FAULTS

    if not FAULTS.enabled:
        return k, v
    kb = np.ascontiguousarray(k).tobytes()
    flipped = FAULTS.corrupt_bytes(site, kb)
    if flipped is kb:
        return k, v
    return np.frombuffer(flipped, dtype=k.dtype).reshape(k.shape), v


class HostBlockPool:
    """Byte-bounded LRU of KV blocks in host DRAM. Thread-safe."""

    def __init__(
        self,
        capacity_bytes: int,
        *,
        on_evict: Callable[[int, np.ndarray, np.ndarray], None] | None = None,
    ):
        self.capacity_bytes = capacity_bytes
        self.used_bytes = 0
        self._blocks: OrderedDict[int, tuple[np.ndarray, np.ndarray]] = OrderedDict()
        self._lock = threading.Lock()
        # demotion hook: evicted blocks cascade to the next tier (G3)
        self._on_evict = on_evict

    def __len__(self) -> int:
        return len(self._blocks)

    def __contains__(self, sh: int) -> bool:
        with self._lock:
            return sh in self._blocks

    def put(self, sh: int, k: np.ndarray, v: np.ndarray) -> bool:
        nbytes = k.nbytes + v.nbytes
        if nbytes > self.capacity_bytes:
            return False
        evicted: list[tuple[int, np.ndarray, np.ndarray]] = []
        with self._lock:
            if sh in self._blocks:
                self._blocks.move_to_end(sh)
                return True
            while self.used_bytes + nbytes > self.capacity_bytes and self._blocks:
                esh, (ek, ev) = self._blocks.popitem(last=False)
                self.used_bytes -= ek.nbytes + ev.nbytes
                evicted.append((esh, ek, ev))
            self._blocks[sh] = (k, v)
            self.used_bytes += nbytes
        for esh, ek, ev in evicted:
            if self._on_evict is not None:
                self._on_evict(esh, ek, ev)
        return True

    def get(self, sh: int) -> tuple[np.ndarray, np.ndarray] | None:
        with self._lock:
            blk = self._blocks.get(sh)
            if blk is not None:
                self._blocks.move_to_end(sh)
            return blk

    def remove(self, sh: int) -> bool:
        with self._lock:
            blk = self._blocks.pop(sh, None)
            if blk is None:
                return False
            self.used_bytes -= blk[0].nbytes + blk[1].nbytes
            return True

    def clear(self) -> None:
        with self._lock:
            self._blocks.clear()
            self.used_bytes = 0


class DiskBlockPool:
    """Byte-bounded LRU of KV blocks on local disk; the index survives a
    restart. One ``.npy`` per block (k and v stacked: ``[2, ...]``) and a
    ``kvbm_index.json`` of ``[hash, nbytes, checksum]`` in LRU order.
    Thread-safe."""

    INDEX = "kvbm_index.json"

    def __init__(self, directory: str, capacity_bytes: int):
        self.dir = directory
        self.capacity_bytes = capacity_bytes
        self.used_bytes = 0
        self._order: OrderedDict[int, int] = OrderedDict()  # sh -> nbytes
        # sh -> checksum of the stacked file; None for an index entry that
        # carries none (verifies trivially until rewritten)
        self._crc: dict[int, int | None] = {}
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)
        self._load_index()

    def __len__(self) -> int:
        return len(self._order)

    def __contains__(self, sh: int) -> bool:
        with self._lock:
            return sh in self._order

    def _path(self, sh: int) -> str:
        return os.path.join(self.dir, f"{sh & 0xFFFFFFFFFFFFFFFF:016x}.npy")

    def _load_index(self) -> None:
        path = os.path.join(self.dir, self.INDEX)
        try:
            with open(path) as f:
                entries = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        for entry in entries:
            sh, nbytes = entry[0], entry[1]
            if os.path.exists(self._path(sh)):
                self._order[sh] = nbytes
                self._crc[sh] = entry[2] if len(entry) > 2 else None
                self.used_bytes += nbytes
        # the budget may have shrunk since the index was written
        shrunk = False
        while self.used_bytes > self.capacity_bytes and self._order:
            esh, en = self._order.popitem(last=False)
            self._crc.pop(esh, None)
            self.used_bytes -= en
            shrunk = True
            try:
                os.unlink(self._path(esh))
            except OSError:
                pass
        if shrunk:
            self._save_index()

    def _save_index(self) -> None:
        path = os.path.join(self.dir, self.INDEX)
        try:
            with open(path, "w") as f:
                json.dump([[sh, n, self._crc.get(sh)] for sh, n in self._order.items()], f)
        except OSError:
            log.warning("could not persist kvbm disk index", exc_info=True)

    def put(self, sh: int, k: np.ndarray, v: np.ndarray) -> bool:
        nbytes = k.nbytes + v.nbytes
        if nbytes > self.capacity_bytes:
            return False
        with self._lock:
            if sh in self._order:
                self._order.move_to_end(sh)
                return True
            while self.used_bytes + nbytes > self.capacity_bytes and self._order:
                esh, en = self._order.popitem(last=False)
                self._crc.pop(esh, None)
                self.used_bytes -= en
                try:
                    os.unlink(self._path(esh))
                except OSError:
                    pass
            stacked = np.stack([k, v])
            try:
                np.save(self._path(sh), stacked)
            except OSError:
                log.warning("kvbm disk write failed", exc_info=True)
                return False
            self._order[sh] = nbytes
            # the checksum of the exact bytes get() reads back, so a torn
            # write or a flip at rest fails verification
            self._crc[sh] = kv_checksum(stacked)
            self.used_bytes += nbytes
            self._save_index()
        return True

    def get(self, sh: int) -> tuple[np.ndarray, np.ndarray] | None:
        with self._lock:
            if sh not in self._order:
                return None
            self._order.move_to_end(sh)
        try:
            stacked = np.load(self._path(sh))
        except OSError:
            with self._lock:
                nbytes = self._order.pop(sh, 0)
                self._crc.pop(sh, None)
                self.used_bytes -= nbytes
            return None
        k, v = _corrupt_block("kvbm.onboard", stacked[0], stacked[1])
        try:
            verify_checksum(self._crc.get(sh), k, v, path="kvbm.disk")
        except IntegrityError:
            log.warning("kvbm disk block %016x failed checksum; evicting", sh)
            self.remove(sh)
            return None
        return k, v

    def remove(self, sh: int) -> bool:
        """Drop one block (a corrupt quantized onboard evicts it)."""
        with self._lock:
            nbytes = self._order.pop(sh, None)
            self._crc.pop(sh, None)
            if nbytes is None:
                return False
            self.used_bytes -= nbytes
            try:
                os.unlink(self._path(sh))
            except OSError:
                pass
            self._save_index()
            return True

    def clear(self) -> None:
        with self._lock:
            for sh in list(self._order):
                try:
                    os.unlink(self._path(sh))
                except OSError:
                    pass
            self._order.clear()
            self._crc.clear()
            self.used_bytes = 0
            self._save_index()


class RemoteBlockPool:
    """G4: KV blocks in the hub's object store, shared across workers (and
    across packages: the payloads are the JAX package's). Writes are capped
    per process (``max_blocks``); the store does no eviction. All hub I/O
    hops through the event loop with a timeout (callers sit on engine
    threads)."""

    BUCKET = "kvbm-g4"

    def __init__(self, hub, loop, *, max_blocks: int = 4096,
                 timeout_s: float = 5.0, namespace: str = "dynamo"):
        self.hub = hub
        self.loop = loop
        self.max_blocks = max_blocks
        self.timeout_s = timeout_s
        self.bucket = f"{self.BUCKET}-{namespace}"
        self._written: set[int] = set()  # hashes this process has stored
        self.stored_bytes = 0  # payload bytes behind _written
        self._lock = threading.Lock()

    def _call(self, coro):
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        try:
            return fut.result(self.timeout_s)
        except TimeoutError:
            # nothing left in flight: a hung hub must not pile up
            # coroutines that each pin a multi-MB payload
            fut.cancel()
            raise

    @staticmethod
    def _name(sh: int) -> str:
        return f"{sh:016x}"

    @staticmethod
    def encode(k: np.ndarray, v: np.ndarray) -> bytes:
        """One object: 4-byte header length, JSON header, k bytes, v bytes."""
        kb, vb = k.tobytes(), v.tobytes()
        header = json.dumps({
            "shape": list(k.shape), "dtype": _WIRE_DTYPE.get(k.dtype.name, k.dtype.name),
            "checksum": kv_checksum(kb, vb),
        }).encode()
        return len(header).to_bytes(4, "big") + header + kb + vb

    def put(self, sh: int, k: np.ndarray, v: np.ndarray) -> bool:
        with self._lock:
            if sh in self._written:
                return True  # a re-sealed hot prefix: already stored
            if len(self._written) >= self.max_blocks:
                return False
            self._written.add(sh)
        payload = self.encode(k, v)
        try:
            self._call(self.hub.put_object(self.bucket, self._name(sh), payload))
            with self._lock:
                self.stored_bytes += len(payload)
            return True
        except Exception:  # noqa: BLE001 - the remote tier is best-effort
            log.warning("g4 put failed for %x", sh, exc_info=True)
            with self._lock:
                self._written.discard(sh)
            return False

    @staticmethod
    def _decode(data: bytes) -> tuple[np.ndarray, np.ndarray] | None:
        if not data:
            return None
        hlen = int.from_bytes(data[:4], "big")
        header = json.loads(data[4: 4 + hlen])
        shape = tuple(header["shape"])
        name = header["dtype"]
        dtype = _HOST_DTYPE.get(name) or np.dtype(name)
        n = int(np.prod(shape)) * dtype.itemsize
        body = data[4 + hlen:]
        if len(body) < 2 * n:
            raise ValueError("g4 payload shorter than header claims")
        from dynamo_tpu_torch.runtime.faults import FAULTS

        if FAULTS.enabled:
            # the corrupt fault on the KV body only (a flipped header byte
            # would be a JSON error, another failure)
            body = FAULTS.corrupt_bytes("kvbm.onboard", body)
        # verify the exact slice about to be read as KV; the IntegrityError
        # reaches get()/get_many(), which count any decode failure a miss
        verify_checksum(header.get("checksum"), body[: 2 * n], path="kvbm.remote")
        k = np.frombuffer(body[:n], dtype=dtype).reshape(shape)
        v = np.frombuffer(body[n: 2 * n], dtype=dtype).reshape(shape)
        return k, v

    def get(self, sh: int) -> tuple[np.ndarray, np.ndarray] | None:
        # best-effort: a malformed or foreign object is a miss, never a
        # failed admission
        try:
            data = self._call(self.hub.get_object(self.bucket, self._name(sh)))
            return self._decode(data)
        except Exception:  # noqa: BLE001
            log.warning("g4 get failed for %x", sh, exc_info=True)
            return None

    def get_many(self, shs: list[int]) -> dict[int, tuple[np.ndarray, np.ndarray]]:
        """Several blocks in ONE round of hub I/O (the admission thread
        waits for it)."""
        if not shs:
            return {}

        async def _gather():
            return await asyncio.gather(
                *(self.hub.get_object(self.bucket, self._name(sh)) for sh in shs),
                return_exceptions=True,
            )

        try:
            results = self._call(_gather())
        except Exception:  # noqa: BLE001
            log.warning("g4 batch get failed", exc_info=True)
            return {}
        out: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        for sh, data in zip(shs, results):
            if isinstance(data, BaseException):
                continue
            try:
                blk = self._decode(data)
            except Exception:  # noqa: BLE001
                log.warning("g4 block %x decode failed; treating as miss", sh,
                            exc_info=True)
                continue
            if blk is not None:
                out[sh] = blk
        return out
