"""Event recording + deterministic replay (the counterpart of
dynamo_tpu/runtime/recorder.py).

``EventRecorder`` taps hub subjects and writes one JSONL line per event;
``replay_events`` republishes a capture in order, so a KvRouter subscribed
to the same subjects rebuilds the radix state the live session produced
and routing is regression-testable from a file.

Record format, one line per event (the reference's, byte for byte):
    {"t": <seconds since capture start>, "subject": "...", "seq": N,
     "payload": {...}}
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import TextIO

__all__ = ["EventRecorder", "replay_events", "load_recording"]


class EventRecorder:
    """Tap hub subjects to a JSONL sink. ``replay=True`` captures retained
    history first, so a recorder attached after a session still writes
    the full stream."""

    def __init__(self, hub, subject: str, sink: TextIO, *, replay: bool = True):
        self.hub = hub
        self.subject = subject
        self.sink = sink
        self.replay = replay
        self.count = 0
        self._t0 = time.monotonic()
        self._task: asyncio.Task | None = None

    async def _run(self) -> None:
        async for subj, payload, seq in self.hub.subscribe(
            self.subject, replay=self.replay, with_seq=True
        ):
            self.sink.write(json.dumps({
                "t": round(time.monotonic() - self._t0, 6),
                "subject": subj,
                "seq": seq,
                "payload": payload,
            }) + "\n")
            self.count += 1

    def start(self) -> "EventRecorder":
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def close(self) -> None:
        if self._task is not None:
            # let queued events drain to the sink before cancelling
            await asyncio.sleep(0)
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        self.sink.flush()


def load_recording(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


async def replay_events(
    hub, path: str, *, speed: float = 0.0, subject_map=None
) -> int:
    """Republish a capture in recorded order. ``speed`` > 0 dilates the
    original timing by that factor (1.0 = real time); 0 replays as fast
    as the hub accepts. ``subject_map(subject) -> subject`` rewrites
    destinations. Returns the number of events republished."""
    records = load_recording(path)
    t0 = time.monotonic()
    for rec in records:
        if speed > 0:
            delay = rec["t"] / speed - (time.monotonic() - t0)
            if delay > 0:
                await asyncio.sleep(delay)
        subject = rec["subject"]
        if subject_map is not None:
            subject = subject_map(subject)
        await hub.publish(subject, rec["payload"])
    return len(records)
