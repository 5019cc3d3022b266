"""Offload engine: the background G1 -> G2 writer (the port's copy of
dynamo_tpu/kvbm/offload.py), and the device-to-host handoff it waits on.

At each drain the engine gathers the pages sealed since the last one into a
fresh device tensor on its compute stream (sealed pages are never written
again, and that stream is ordered after any in-flight burst), then
``HostBatch`` copies it into pinned host memory on a dedicated copy stream
that waits on an event recorded after the gather: a 512-token llama-3-8b
prompt is 62 MiB, and a copy on the compute stream would queue the next
decode step's kernels behind it. The step thread never waits; this
module's thread waits on the copy's event, offers each block to the
manager as a contiguous numpy copy, and lets the pinned buffer go back to
torch's caching host allocator, so the tiers never hold pinned memory. On
a CPU device the gather is the host tensor and nothing is copied.

bf16 blocks leave as their ``uint16`` bits (numpy has no bf16 without
``ml_dtypes``); ``block_tensor`` maps them back at onboard.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time

import numpy as np
import torch

log = logging.getLogger("dynamo_tpu_torch.kvbm.offload")

_STOP = object()
_FLUSH = object()


def block_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy, sharing its memory; bf16 as ``uint16`` bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def block_tensor(a: np.ndarray) -> torch.Tensor:
    """Inverse of ``block_numpy`` (a ``uint16`` block is bf16 bits)."""
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class HostBatch:
    """One drained batch of blocks ``kb``, ``vb`` (``[L, n, ...]``, fresh
    device tensors) on its way to the host. On a CUDA device the copy runs
    on ``copy_stream`` after an event recorded on the current stream, and
    ``wait`` reports the gather's device time (from ``t0``, a timing event
    the caller recorded before the gather, to the gather's end) and the
    copy's (events on the copy stream around the two copies)."""

    def __init__(self, kb: torch.Tensor, vb: torch.Tensor,
                 copy_stream=None, t0=None):
        self.nbytes = kb.nbytes + vb.nbytes
        self.t_submit = time.perf_counter()
        self.events = None
        if kb.device.type != "cuda":
            self.k, self.v = kb, vb
            return
        gathered, start, done = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        gathered.record(torch.cuda.current_stream(kb.device))
        # pinned buffers first: a new size is a host allocation, which must
        # not sit between the copy's timing events
        self.k = torch.empty(kb.shape, dtype=kb.dtype, pin_memory=True)
        self.v = torch.empty(vb.shape, dtype=vb.dtype, pin_memory=True)
        copy_stream.wait_event(gathered)
        with torch.cuda.stream(copy_stream):
            start.record(copy_stream)
            self.k.copy_(kb, non_blocking=True)
            self.v.copy_(vb, non_blocking=True)
            done.record(copy_stream)
        # the gathered tensors are freed by the caller: their memory is not
        # reused before the copy stream is past this point
        kb.record_stream(copy_stream)
        vb.record_stream(copy_stream)
        self.events = (t0, gathered, start, done)

    def wait(self) -> tuple[np.ndarray, np.ndarray, dict]:
        """(k, v) as numpy once the copy has landed, and the batch's
        device times ``gather_ms`` / ``copy_ms`` (None on the CPU)."""
        timing = {"gather_ms": None, "copy_ms": None}
        if self.events is not None:
            t0, gathered, start, done = self.events
            done.synchronize()
            timing = {"gather_ms": t0.elapsed_time(gathered),
                      "copy_ms": start.elapsed_time(done)}
        return block_numpy(self.k), block_numpy(self.v), timing


class OffloadEngine:
    """The offload thread: a bounded queue of ``HostBatch``es (a full queue
    drops the batch and counts it in ``dropped``: offload is a cache fill,
    never worth stalling decode for; an SPMD follower's submit waits
    instead, so its tiers hold what its leader's do). ``batches`` keeps each offered
    batch's blocks, bytes, device times and lag from submit to the last
    ``offer`` (host clock)."""

    def __init__(self, manager, *, max_queue: int = 64):
        self.manager = manager
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._thread: threading.Thread | None = None
        self.dropped = 0
        self.batches: collections.deque = collections.deque(maxlen=4096)

    def start(self) -> "OffloadEngine":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="kvbm-offload",
                                            daemon=True)
            self._thread.start()
        return self

    def submit(self, hashes: list[int], batch: HostBatch, wait: bool = False) -> bool:
        """Non-blocking unless ``wait``; a full queue drops the batch
        (False)."""
        if wait:
            self._q.put((hashes, batch))
            return True
        try:
            self._q.put_nowait((hashes, batch))
        except queue.Full:
            self.dropped += 1
            return False
        return True

    def flush(self, timeout: float = 10.0) -> None:
        """Wait until everything queued so far has been offered."""
        done = threading.Event()
        self._q.put((_FLUSH, done))
        done.wait(timeout)

    def close(self) -> None:
        if self._thread is not None:
            self._q.put((_STOP, None))
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while True:
            hashes, batch = self._q.get()
            if hashes is _STOP:
                return
            if hashes is _FLUSH:
                batch.set()
                continue
            try:
                k_np, v_np, timing = batch.wait()
                for i, sh in enumerate(hashes):
                    # copies: the tiers must not hold the pinned buffer
                    self.manager.offer(sh, k_np[:, i].copy(), v_np[:, i].copy())
                self.batches.append({
                    "blocks": len(hashes), "bytes": batch.nbytes,
                    "lag_s": time.perf_counter() - batch.t_submit, **timing})
            except Exception:  # noqa: BLE001
                log.exception("offload batch failed")
