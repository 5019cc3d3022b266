"""Compute pool: CPU-bound work off the event loop (a copy of
dynamo_tpu/runtime/compute.py).

Tokenization and chat-template rendering are CPU-bound and must not stall
the serving event loop; a bounded thread pool runs them."""

from __future__ import annotations

import asyncio
import functools
import os
from concurrent.futures import ThreadPoolExecutor

__all__ = ["ComputePool"]


class ComputePool:
    def __init__(self, max_workers: int | None = None):
        if max_workers is None:
            max_workers = min(8, (os.cpu_count() or 2))
        self._ex = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="dyn-compute"
        )

    async def run(self, fn, *args, **kwargs):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._ex, functools.partial(fn, *args, **kwargs)
        )

    def shutdown(self) -> None:
        self._ex.shutdown(wait=False, cancel_futures=True)
