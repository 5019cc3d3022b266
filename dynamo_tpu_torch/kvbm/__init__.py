"""KVBM: the multi-tier KV block manager (the port's copy of
dynamo_tpu/kvbm/).

KV blocks flow between cache tiers keyed by the sequence-hash chain the
router and the engine use:

  G1  device pages (the engine's PageAllocator prefix cache)
  G2  host DRAM pool (bounded bytes, LRU)
  G3  local disk (bounded bytes, LRU, survives a restart)
  G4  the hub's object store (shared across workers, and across packages)

Offload is write-through at block-seal time: the engine gathers the pages
it sealed into one device tensor, copies it to pinned host memory on a
copy stream (offload.HostBatch), and a background thread offers each block
to the manager; decode never waits on host or disk I/O. Onboard happens at
prefill admission: blocks missing in G1 but present in G2/G3/G4 are written
back into fresh device pages in place, extending the cached prefix.
"""

from dynamo_tpu_torch.kvbm.manager import KvbmConfig, KvBlockManager
from dynamo_tpu_torch.kvbm.offload import OffloadEngine
from dynamo_tpu_torch.kvbm.pool import DiskBlockPool, HostBlockPool

__all__ = [
    "KvbmConfig",
    "KvBlockManager",
    "OffloadEngine",
    "HostBlockPool",
    "DiskBlockPool",
]
