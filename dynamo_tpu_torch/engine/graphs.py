"""Decode bursts as captured CUDA graphs.

The port's counterpart of the JAX package's ``jax.jit(decode_steps)``, one
compiled program per ``(n_steps, n_logprobs)``, together with the JAX
engine's ``precompile()``. ``DecodeGraphs`` holds static device tensors for
one batch of ``batch`` decode slots (``models/llama.StepTensors``) and
captures the family's one-step function over them once per variant:
{greedy, sampled} x {no logprobs, ``n_logprobs`` logprobs}. Capture is lazy
(``precompile`` forces it); the variants share one graph memory pool. A
burst of ``n`` model steps is ``n`` replays, chained on the device through
the static tensors the step advances in place, so any burst length up to
``max_steps`` needs no new capture.

Per burst the host makes one host-to-device copy, from a pinned staging
buffer, of every input (the step tensors' values, plus two rows that say
which rows' tokens come from device-side feeds: earlier bursts still in
flight, and first tokens sampled at admission); then, after the replays,
one non-blocking device-to-host copy of the burst's records into pinned
memory, with an event (``Burst.ready``). Row 0 of the records is the fed
tokens.

On a CPU device the same object runs the step function eagerly: that is
the route the CPU tests take, with the same buffers, copies and feeds. On
a CUDA device a capture or a replay that fails raises; nothing falls back
to eager steps.

Launch counts: a kernel wrapper counts a launch made under capture as
``captured`` (ops/cuda/build.py). At capture this object records each
kernel's captured launches, and every replay adds them to the wrapper's
``launches``, so the counters stay true under graphs.

Graphs hold raw pointers to the KV pools and the weights: ``release()``
drops them before either is freed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from dynamo_tpu_torch.models.llama import StepTensors, record_width, unpack_records

WARMUP_STEPS = 2  # eager steps on a side stream before each capture

# int32 words of each staged input, in staging order (P = pages per slot)
_FIELDS = ("tokens", "block_tables", "seq_lens", "active", "temperature",
           "top_k", "top_p", "seeds", "steps", "step_idx", "feed_src",
           "feed_idx")
_FLOAT_FIELDS = ("temperature", "top_p")


class HostCopy:
    """A device tensor's copy to the host, started now: into pinned memory
    with an event behind it on a CUDA device (the counterpart of JAX's
    ``copy_to_host_async``); the tensor itself on the CPU."""

    def __init__(self, dev: torch.Tensor):
        self.dev = dev
        self.event = None
        if dev.device.type != "cuda":
            self.host = dev
            return
        self.host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        self.host.copy_(dev, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def ready(self) -> bool:
        """True once the copy has landed (never blocks)."""
        return self.event is None or self.event.query()

    def wait(self) -> torch.Tensor:
        """The host tensor, once the copy has landed."""
        if self.event is not None:
            self.event.synchronize()
        return self.host


class Burst:
    """One dispatched burst: its records on the device (``dev``, row 0
    the fed tokens, then one row per step) and their copy to the host."""

    def __init__(self, dev: torch.Tensor, batch: int, n_steps: int,
                 n_logprobs: int):
        self.dev = dev
        self.copy = HostCopy(dev)
        self.batch, self.n_steps, self.n_logprobs = batch, n_steps, n_logprobs

    def last_tokens(self) -> torch.Tensor:
        """The burst's last sampled token per slot [B], on the device."""
        return self.dev[self.n_steps, :self.batch]

    def result(self):
        """Wait for the host copy; returns (fed [B], sampled [B, n], and
        logprobs [B, n], top_ids [B, n, N], top_logprobs [B, n, N] or
        three Nones) as numpy arrays."""
        rows = self.copy.wait()
        fed = rows[0, :self.batch].numpy()
        out = unpack_records(rows[1:], self.batch, self.n_logprobs)
        if not self.n_logprobs:
            return fed, out.numpy(), None, None, None
        return (fed,) + tuple(x.numpy() for x in out)


class DecodeGraphs:
    """Static step tensors for ``batch`` slots of ``pages_per_seq`` pages,
    and the step function ``step(t, sampled, n_logprobs)`` captured per
    variant on a CUDA device (``models/llama.decode_step_`` bound to the
    model and pools)."""

    def __init__(
        self,
        step: Callable[[StepTensors, bool, int], None],
        *,
        batch: int,
        pages_per_seq: int,
        max_steps: int,
        n_logprobs: int,
        device: torch.device,
    ):
        self.step = step
        self.batch, self.max_steps = batch, max_steps
        self.n_logprobs = n_logprobs
        self.device = device
        self.cuda = device.type == "cuda"
        B, P = batch, pages_per_seq
        sizes = dict.fromkeys(_FIELDS, B)
        sizes.update(block_tables=B * P, step_idx=1)
        self._slices: dict[str, slice] = {}
        off = 0
        for name in _FIELDS:
            self._slices[name] = slice(off, off + sizes[name])
            off += sizes[name]
        self.flat = torch.zeros(off, dtype=torch.int32, device=device)
        views = {name: self.flat[s] for name, s in self._slices.items()}
        for name in _FLOAT_FIELDS:
            views[name] = views[name].view(torch.float32)
        views["block_tables"] = views["block_tables"].view(B, P)
        self.feed_src, self.feed_idx = views.pop("feed_src"), views.pop("feed_idx")
        self.out_flat = torch.zeros(
            (1 + max_steps) * record_width(B, n_logprobs), dtype=torch.int32,
            device=device)
        self.t = StepTensors(**views, out=self.out_flat[:0])
        self._graphs: dict[tuple[bool, int], tuple] = {}
        self._pool = None
        self.replays = 0

    # -- variants ----------------------------------------------------------

    def _tensors(self, n_logprobs: int) -> StepTensors:
        R = record_width(self.batch, n_logprobs)
        out = self.out_flat[: (1 + self.max_steps) * R].view(1 + self.max_steps, R)
        return dataclasses.replace(self.t, out=out)

    def precompile(self, variants=None) -> None:
        """Capture ``variants`` ((sampled, n_logprobs) pairs; default all
        four) now, as the JAX engine's precompile() compiles each burst
        shape before traffic. A no-op on the CPU."""
        if self.cuda:
            for key in variants or [(s, n) for s in (False, True)
                                    for n in (0, self.n_logprobs)]:
                self._graph(key)

    def release(self) -> None:
        """Drop every graph and their memory pool (they point at the
        pools and weights they were captured over)."""
        self._graphs.clear()
        self._pool = None

    def _graph(self, key: tuple[bool, int]):
        if key not in self._graphs:
            self._graphs[key] = self._capture(*key)
        return self._graphs[key]

    def _capture(self, sampled: bool, n_logprobs: int):
        """Warm up on a side stream (cuBLAS picks its algorithms and
        workspace outside the graph), then capture one step. Both run over
        blank inputs: every slot inactive, so the step only writes trash
        page 0. Returns (graph, {kernel wrapper: (launches, fp8 launches)
        per replay})."""
        from dynamo_tpu_torch.ops.cuda.build import KERNELS

        t = self._tensors(n_logprobs)
        self.flat.zero_()
        self.t.seq_lens.fill_(1)
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self.t.step_idx.zero_()
                self.step(t, sampled, n_logprobs)
        cur.wait_stream(side)
        self.t.step_idx.zero_()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = {fn: (fn.captured, fn.fp8_captured) for fn in KERNELS}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            self.step(t, sampled, n_logprobs)
        counts = {fn: (fn.captured - n, fn.fp8_captured - n8)
                  for fn, (n, n8) in before.items()}
        return graph, {fn: c for fn, c in counts.items() if c != (0, 0)}

    # -- bursts ------------------------------------------------------------

    def dispatch(
        self,
        inputs: dict[str, np.ndarray],
        n_steps: int,
        *,
        sampled: bool,
        n_logprobs: int,
        feeds: list[torch.Tensor] = (),
        feed_src: np.ndarray | None = None,
        feed_idx: np.ndarray | None = None,
    ) -> Burst:
        """One burst of ``n_steps`` model steps. ``inputs`` holds the host
        arrays of the step tensors (tokens, block_tables, seq_lens, active,
        temperature, top_k, top_p, seeds, steps). Row i's token is then
        replaced on the device by ``feeds[feed_src[i]][feed_idx[i]]`` where
        ``feed_src[i] >= 0``. ``n_logprobs`` is 0 or the object's width."""
        if not 1 <= n_steps <= self.max_steps:
            raise ValueError(f"burst of {n_steps} steps (1..{self.max_steps})")
        if n_logprobs not in (0, self.n_logprobs):
            raise ValueError(f"n_logprobs {n_logprobs} is not 0 or {self.n_logprobs}")
        key = (bool(sampled), n_logprobs)
        if self.cuda:
            graph, per_replay = self._graph(key)
        t = self._tensors(n_logprobs)
        B = self.batch
        staging = torch.empty(self.flat.numel(), dtype=torch.int32,
                              pin_memory=self.cuda)
        host = staging.numpy()
        fill = dict(inputs, step_idx=np.zeros(1, np.int32),
                    feed_src=np.full(B, -1, np.int32) if feed_src is None else feed_src,
                    feed_idx=np.zeros(B, np.int32) if feed_idx is None else feed_idx)
        for name, s in self._slices.items():
            arr = np.asarray(fill[name])
            if name in _FLOAT_FIELDS:
                host[s] = arr.astype(np.float32).reshape(-1).view(np.int32)
            else:  # ints and bools; a uint32 seed keeps its bits
                host[s] = arr.astype(np.int64).astype(np.int32).reshape(-1)
        self.flat.copy_(staging, non_blocking=True)
        for j, src in enumerate(feeds):
            pick = self.feed_src == j
            fed = src[self.feed_idx.long().clamp(0, src.shape[0] - 1)]
            self.t.tokens.copy_(torch.where(pick, fed.to(torch.int32), self.t.tokens))
        t.out[0, :B].copy_(self.t.tokens)
        for _ in range(n_steps):
            if self.cuda:
                graph.replay()
                for fn, (n, n8) in per_replay.items():
                    fn.launches += n
                    fn.fp8_launches += n8
            else:
                self.step(t, key[0], n_logprobs)
        if self.cuda:
            self.replays += n_steps
        return Burst(t.out[: 1 + n_steps].clone(), B, n_steps, n_logprobs)
