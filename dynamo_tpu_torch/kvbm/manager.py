"""KvBlockManager: the tier orchestrator (the port's copy of
dynamo_tpu/kvbm/manager.py).

Two calls serve the engine:

  offer(sh, k, v)  write-through from a G1 seal (the offload thread calls
                   it, never the step thread)
  get(sh) /        the onboard probe at prefill admission, G2 then G3 then
  get_consecutive  G4, each hit promoted into G2

G2 evictions cascade to G3. G4 writes go through a writer thread of their
own, so a slow hub never backs up the offload thread. Every G2 block's
checksum is stamped at offer or promotion and verified on each hit (G3 and
G4 carry theirs in the disk index and the object header). ``stats`` counts
offloads, hits per tier and misses.
"""

from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass

import numpy as np

from dynamo_tpu_torch.kvbm.pool import (
    DiskBlockPool,
    HostBlockPool,
    RemoteBlockPool,
    _corrupt_block,
)
from dynamo_tpu_torch.runtime.integrity import (
    IntegrityError,
    kv_checksum,
    verify_checksum,
)

log = logging.getLogger("dynamo_tpu_torch.kvbm")


@dataclass
class KvbmConfig:
    host_bytes: int = 256 * 1024 * 1024  # G2 budget
    disk_bytes: int = 0  # G3 budget; 0 disables the disk tier
    disk_dir: str | None = None
    # offload filter: only blocks shallower than this many blocks into a
    # sequence are offloaded (0 = all); deep blocks are the least shared
    max_offload_depth_blocks: int = 0
    # G4 (hub object store, shared across workers): write cap, 0 disables
    remote_max_blocks: int = 0


@dataclass
class KvbmStats:
    offloaded: int = 0
    onboard_hits_host: int = 0
    onboard_hits_disk: int = 0
    onboard_hits_remote: int = 0
    onboard_misses: int = 0

    def to_dict(self) -> dict[str, int]:
        return dict(self.__dict__)


class KvBlockManager:
    def __init__(self, config: KvbmConfig | None = None, *, hub=None,
                 loop=None, namespace: str = "dynamo"):
        self.config = config or KvbmConfig()
        self.remote: RemoteBlockPool | None = None
        if self.config.remote_max_blocks > 0 and hub is not None and loop is not None:
            self.remote = RemoteBlockPool(
                hub, loop, max_blocks=self.config.remote_max_blocks,
                namespace=namespace,
            )
        self.disk: DiskBlockPool | None = None
        if self.config.disk_bytes > 0 and self.config.disk_dir:
            self.disk = DiskBlockPool(self.config.disk_dir, self.config.disk_bytes)
        # checksums of the blocks in G2, stamped at offer / promotion and
        # dropped on eviction. _lock (re-entrant: host.put's eviction
        # cascade re-enters it) is held across host.put/get and the stamp,
        # so no hit can see a block before its stamp; manager lock outside
        # the pool locks, always
        self._checksums: dict[int, int] = {}
        self._lock = threading.RLock()

        def _evict_host(sh: int, k: np.ndarray, v: np.ndarray) -> None:
            with self._lock:
                self._checksums.pop(sh, None)
            if self.disk is not None:
                self.disk.put(sh, k, v)

        self.host = HostBlockPool(self.config.host_bytes, on_evict=_evict_host)
        self.stats = KvbmStats()
        self._remote_q: queue.Queue | None = None
        if self.remote is not None:
            self._remote_q = queue.Queue(maxsize=128)
            threading.Thread(target=self._remote_writer, name="kvbm-g4-writer",
                             daemon=True).start()

    def _remote_writer(self) -> None:
        while True:
            sh, k, v = self._remote_q.get()
            try:
                self.remote.put(sh, k, v)
            except Exception:  # noqa: BLE001
                log.warning("g4 write failed", exc_info=True)

    def should_offload(self, block_index: int) -> bool:
        d = self.config.max_offload_depth_blocks
        return d <= 0 or block_index < d

    def offer(self, sh: int, k: np.ndarray, v: np.ndarray) -> None:
        """Write-through insert of a sealed G1 page (contiguous copies)."""
        k = np.ascontiguousarray(k)
        v = np.ascontiguousarray(v)
        with self._lock:
            if self.host.put(sh, k, v):
                self._checksums[sh] = kv_checksum(k, v)
                self.stats.offloaded += 1
        if self._remote_q is not None:
            # best-effort: a full queue (a sick hub) drops the block
            try:
                self._remote_q.put_nowait((sh, k, v))
            except queue.Full:
                pass

    def _promote(self, sh: int, k: np.ndarray, v: np.ndarray) -> None:
        """Lift a verified lower-tier block into G2, stamped."""
        with self._lock:
            if self.host.put(sh, k, v):
                self._checksums[sh] = kv_checksum(k, v)

    def _get_local(self, sh: int):
        """G2 then G3, with promotion; no hub I/O."""
        with self._lock:
            blk = self.host.get(sh)
            if blk is not None:
                blk = _corrupt_block("kvbm.onboard", blk[0], blk[1])
                try:
                    verify_checksum(self._checksums.get(sh), blk[0], blk[1],
                                    path="kvbm.host")
                except IntegrityError:
                    # DRAM rot (or an injected flip): drop the block and
                    # fall through to the lower tiers or a miss
                    log.warning("kvbm host block %016x failed checksum; evicting", sh)
                    self.host.remove(sh)
                    self._checksums.pop(sh, None)
                    blk = None
                if blk is not None:
                    self.stats.onboard_hits_host += 1
                    return blk
        if self.disk is not None:
            blk = self.disk.get(sh)
            if blk is not None:
                self._promote(sh, blk[0], blk[1])
                with self._lock:
                    self.stats.onboard_hits_disk += 1
                return blk
        return None

    def get(self, sh: int) -> tuple[np.ndarray, np.ndarray] | None:
        """Onboard probe: G2, G3, then G4 (with promotion)."""
        blk = self._get_local(sh)
        if blk is not None:
            return blk
        if self.remote is not None:
            blk = self.remote.get(sh)
            if blk is not None:
                self._promote(sh, blk[0], blk[1])
                with self._lock:
                    self.stats.onboard_hits_remote += 1
                return blk
        with self._lock:
            self.stats.onboard_misses += 1
        return None

    def get_consecutive(self, hashes: list) -> list:
        """The longest onboardable prefix of ``hashes`` (the admission
        path's call): the local tiers block by block, then the rest from G4
        in ONE concurrent batch."""
        out = []
        i = 0
        while i < len(hashes):
            blk = self._get_local(hashes[i])
            if blk is None:
                break
            out.append(blk)
            i += 1
        if self.remote is not None and i < len(hashes):
            fetched = self.remote.get_many(list(hashes[i:]))
            while i < len(hashes) and hashes[i] in fetched:
                blk = fetched[hashes[i]]
                self._promote(hashes[i], blk[0], blk[1])
                with self._lock:
                    self.stats.onboard_hits_remote += 1
                out.append(blk)
                i += 1
        if i < len(hashes):
            with self._lock:
                self.stats.onboard_misses += 1
        return out

    def tier_bytes(self) -> dict[str, int]:
        """Bytes per tier: G2 and G3 in use, and the G4 bytes THIS process
        wrote (the store is shared). fp8 blocks count at packed width."""
        out = {"host": self.host.used_bytes}
        if self.disk is not None:
            out["disk"] = self.disk.used_bytes
        if self.remote is not None:
            out["remote"] = self.remote.stored_bytes
        return out

    def __contains__(self, sh: int) -> bool:
        # local tiers only: this backs the advisory prefix probe
        # (engine.prefix_hit_tokens), which must stay cheap; G4 hits show
        # at admission
        return sh in self.host or (self.disk is not None and sh in self.disk)

    def clear(self) -> None:
        with self._lock:
            self.host.clear()
            self._checksums.clear()
        if self.disk is not None:
            self.disk.clear()
