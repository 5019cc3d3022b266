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
to eager steps. ``capture=False`` runs a CUDA device's steps eagerly too,
as asked (``EngineConfig.cuda_graphs``: a gloo tp group's collectives
cannot be captured). A tp rank's step runs its NCCL collectives inside the
graph: every rank captures the same variants in the same order (the
followers replay the leader's captures, parallel/spmd.py).

Launch counts: a kernel wrapper counts a launch made under capture as
``captured`` (ops/cuda/build.py). At capture this object records each
kernel's captured launches, and every replay adds them to the wrapper's
``launches``, so the counters stay true under graphs.

Guided decoding adds a masked variant of each (``vocab_size`` given): a
static [B, V] bool mask the captured step applies to its logits before
the sample and the logprobs (``models/llama.decode_step_``), filled per
dispatch by one more host-to-device copy from a pinned [B, V] staging
buffer. A masked burst is one step (a mask holds for one position: the
host advances each slot's grammar cursor as its token lands), as the JAX
engine dispatches its masked bursts. The mask tensor keeps its address:
every dispatch copies into it, nothing rebinds it.

``VerifyGraphs`` does the same for the speculative verify
(``models/llama.verify_forward``): one graph per power-of-two row count at
the static width ``spec_k_max + 1``, the counterpart of the JAX engine's
verify programs, with one staged copy in and one targets copy out per
dispatch; with ``vocab_size`` a masked capture per row count reads a
static [R, W, V] bool mask (guided x spec), staged as the decode mask is.

Graphs hold raw pointers to the KV pools and the weights: ``release()``
drops them before either is freed.

Both objects count their captures and the host seconds spent in them
(``captures``, ``capture_secs``): the engine's ``dispatch.compile``, the
counterpart of the JAX engine's compile events.
"""

from __future__ import annotations

import dataclasses
import time
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
        vocab_size: int | None = None,
        capture: bool = True,
    ):
        self.step = step
        self.batch, self.max_steps = batch, max_steps
        self.n_logprobs = n_logprobs
        self.device = device
        self.pinned = device.type == "cuda"  # pinned host staging
        self.cuda = self.pinned and capture  # captured graphs
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
        # the masked variants' static [B, V] mask (None: no masked variant)
        self.allowed = (None if vocab_size is None else
                        torch.ones((B, vocab_size), dtype=torch.bool, device=device))
        self._graphs: dict[tuple[bool, int, bool], tuple] = {}
        self._pool = None
        self.replays = 0
        self.captures = 0
        self.capture_secs = 0.0

    # -- variants ----------------------------------------------------------

    def _tensors(self, n_logprobs: int, masked: bool = False) -> StepTensors:
        R = record_width(self.batch, n_logprobs)
        out = self.out_flat[: (1 + self.max_steps) * R].view(1 + self.max_steps, R)
        return dataclasses.replace(self.t, out=out,
                                   allowed=self.allowed if masked else None)

    def variants(self) -> list[tuple[bool, int, bool]]:
        """Every (sampled, n_logprobs, masked) variant: four, or eight with
        the masked ones."""
        masks = (False, True) if self.allowed is not None else (False,)
        return [(s, n, m) for m in masks for s in (False, True)
                for n in (0, self.n_logprobs)]

    def precompile(self, variants=None) -> None:
        """Capture ``variants`` ((sampled, n_logprobs, masked) triples;
        default all of them) now, as the JAX engine's precompile() compiles
        each burst shape before traffic. A no-op on the CPU."""
        if self.cuda:
            for key in variants or self.variants():
                self._graph(key)

    def release(self) -> None:
        """Drop every graph and their memory pool (they point at the
        pools and weights they were captured over)."""
        self._graphs.clear()
        self._pool = None

    def _graph(self, key: tuple[bool, int, bool]):
        if key not in self._graphs:
            self._graphs[key] = _timed_capture(self, key)
        return self._graphs[key]

    def _capture(self, sampled: bool, n_logprobs: int, masked: bool):
        """Warm up on a side stream (cuBLAS picks its algorithms and
        workspace outside the graph), then capture one step. Both run over
        blank inputs: every slot inactive, so the step only writes trash
        page 0 (and an all-True mask). Returns (graph, {kernel wrapper:
        (launches, fp8 launches) per replay})."""
        from dynamo_tpu_torch.ops.cuda.build import KERNELS

        t = self._tensors(n_logprobs, masked)
        self.flat.zero_()
        if masked:
            self.allowed.fill_(True)
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
        allowed: np.ndarray | None = None,
    ) -> Burst:
        """One burst of ``n_steps`` model steps. ``inputs`` holds the host
        arrays of the step tensors (tokens, block_tables, seq_lens, active,
        temperature, top_k, top_p, seeds, steps). Row i's token is then
        replaced on the device by ``feeds[feed_src[i]][feed_idx[i]]`` where
        ``feed_src[i] >= 0``. ``n_logprobs`` is 0 or the object's width.
        ``allowed`` ([B, V] bool, host) runs the masked variant, one step."""
        if not 1 <= n_steps <= self.max_steps:
            raise ValueError(f"burst of {n_steps} steps (1..{self.max_steps})")
        if n_logprobs not in (0, self.n_logprobs):
            raise ValueError(f"n_logprobs {n_logprobs} is not 0 or {self.n_logprobs}")
        masked = allowed is not None
        if masked and (self.allowed is None or n_steps != 1
                       or tuple(allowed.shape) != tuple(self.allowed.shape)):
            raise ValueError(
                f"masked burst of {n_steps} steps, mask {tuple(allowed.shape)}: "
                "one step over a [batch, vocab_size] mask of a DecodeGraphs "
                "built with vocab_size")
        key = (bool(sampled), n_logprobs, masked)
        if self.cuda:
            graph, per_replay = self._graph(key)
        t = self._tensors(n_logprobs, masked)
        B = self.batch
        staging = torch.empty(self.flat.numel(), dtype=torch.int32,
                              pin_memory=self.pinned)
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
        if masked:
            self.allowed.copy_(_pinned(allowed, self.pinned), non_blocking=True)
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
                self.step(t, sampled, n_logprobs)
        if self.cuda:
            self.replays += n_steps
        return Burst(t.out[: 1 + n_steps].clone(), B, n_steps, n_logprobs)


def _timed_capture(obj, key: tuple):
    """``obj._capture(*key)``, counted in ``obj.captures`` and timed on the
    host clock into ``obj.capture_secs``."""
    t0 = time.perf_counter()
    try:
        return obj._capture(*key)
    finally:
        obj.captures += 1
        obj.capture_secs += time.perf_counter() - t0


def _pinned(arr: np.ndarray, pin: bool) -> torch.Tensor:
    """A host bool array in pinned staging memory (the caching host
    allocator's: a block returns to it only once its copy has run)."""
    staging = torch.empty(arr.shape, dtype=torch.bool, pin_memory=pin)
    staging.numpy()[...] = arr
    return staging


def verify_row_counts(batch: int) -> list[int]:
    """The verify grid's row counts: the powers of two up to the first one
    that holds ``batch`` rows ({1, 2, 4, 8} at 8 decode slots), as the JAX
    engine's precompile() compiles them."""
    counts = [1]
    while counts[-1] < batch:
        counts.append(counts[-1] * 2)
    return counts


class VerifyGraphs:
    """The speculative-verify grid: static device inputs for up to
    ``verify_row_counts(batch)[-1]`` rows of ``width`` tokens (tokens
    [R, W], block tables [R, P], start positions [R], token counts [R],
    int32) and ``verify(tokens, block_tables, start_pos, num_tokens[,
    allowed]) -> (targets [n, W], moe_dropped)`` (the family's verify
    bound to the model and pools)
    captured once per row count n over the first n rows: the counterpart
    of the JAX engine's verify programs, one per power-of-two row count at
    the static width ``spec_k_max + 1``.

    A dispatch makes one host-to-device copy from a pinned staging buffer
    and, after the replay, one device-to-host copy of the targets into
    pinned memory. The MoE dropped-slot count of the last dispatch stays on
    the device in ``dropped`` (an int32 scalar the engine adds to its
    running total). On a CPU device the same buffers run ``verify``
    eagerly; on a CUDA device a capture or a replay that fails raises.
    Launch counters stay true under replay, as for ``DecodeGraphs``."""

    def __init__(
        self,
        verify: Callable[..., torch.Tensor],
        *,
        batch: int,
        width: int,
        pages_per_seq: int,
        device: torch.device,
        vocab_size: int | None = None,
        capture: bool = True,
    ):
        self.verify = verify
        self.row_counts = verify_row_counts(batch)
        self.width = width
        self.device = device
        self.pinned = device.type == "cuda"
        self.cuda = self.pinned and capture
        R, W, P = self.row_counts[-1], width, pages_per_seq
        sizes = {"tokens": R * W, "block_tables": R * P, "start_pos": R,
                 "num_tokens": R}
        self._slices: dict[str, slice] = {}
        off = 0
        for name, n in sizes.items():
            self._slices[name] = slice(off, off + n)
            off += n
        self.flat = torch.zeros(off, dtype=torch.int32, device=device)
        self._shapes = {"tokens": (R, W), "block_tables": (R, P),
                        "start_pos": (R,), "num_tokens": (R,)}
        self.targets = torch.zeros((R, W), dtype=torch.int32, device=device)
        self.dropped = torch.zeros((), dtype=torch.int32, device=device)
        # the masked captures' static [R, W, V] mask (None: none)
        self.allowed = (None if vocab_size is None else
                        torch.ones((R, W, vocab_size), dtype=torch.bool, device=device))
        self._graphs: dict[tuple[int, bool], tuple] = {}
        self._pool = None
        self.replays = 0
        self.captures = 0
        self.capture_secs = 0.0

    def _inputs(self, n: int) -> list[torch.Tensor]:
        """The first ``n`` rows of each static input."""
        return [self.flat[s].view(self._shapes[name])[:n]
                for name, s in self._slices.items()]

    def _run(self, n: int, masked: bool = False) -> None:
        args = self._inputs(n) + ([self.allowed[:n]] if masked else [])
        targets, dropped = self.verify(*args)
        self.targets[:n].copy_(targets)
        self.dropped.copy_(dropped)

    def variants(self) -> list[tuple[int, bool]]:
        """Every (row count, masked) capture."""
        masks = (False, True) if self.allowed is not None else (False,)
        return [(n, m) for m in masks for n in self.row_counts]

    def precompile(self, variants=None) -> None:
        """Capture ``variants`` ((row count, masked) pairs; default every
        row count, masked too when the object has a mask) now (a no-op on
        the CPU)."""
        if self.cuda:
            for key in variants or self.variants():
                self._graph(key)

    def release(self) -> None:
        """Drop every graph and their memory pool."""
        self._graphs.clear()
        self._pool = None

    def _graph(self, key: tuple[int, bool]):
        if key not in self._graphs:
            self._graphs[key] = _timed_capture(self, key)
        return self._graphs[key]

    def _capture(self, n: int, masked: bool):
        """Warm up on a side stream, then capture, both over blank inputs:
        every row has 0 tokens, so only trash page 0 is written. Returns
        (graph, {kernel wrapper: (launches, fp8 launches) per replay})."""
        from dynamo_tpu_torch.ops.cuda.build import KERNELS

        self.flat.zero_()
        if masked:
            self.allowed.fill_(True)
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._run(n, masked)
        cur.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = {fn: (fn.captured, fn.fp8_captured) for fn in KERNELS}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            self._run(n, masked)
        counts = {fn: (fn.captured - c, fn.fp8_captured - c8)
                  for fn, (c, c8) in before.items()}
        return graph, {fn: c for fn, c in counts.items() if c != (0, 0)}

    def dispatch(self, tokens: np.ndarray, block_tables: np.ndarray,
                 start_pos: np.ndarray, num_tokens: np.ndarray,
                 allowed: np.ndarray | None = None) -> HostCopy:
        """One verify of ``n`` rows (a captured row count): host arrays
        tokens [n, W], block_tables [n, P], start_pos [n], num_tokens [n],
        and for a masked verify ``allowed`` [n, W, V] bool. Returns the
        targets' copy to the host ([n, W] int32)."""
        n = tokens.shape[0]
        if n not in self.row_counts or tokens.shape[1] != self.width:
            raise ValueError(f"verify of {tuple(tokens.shape)}: rows must be one of "
                             f"{self.row_counts}, width {self.width}")
        masked = allowed is not None
        if masked and (self.allowed is None
                       or tuple(allowed.shape) != (n,) + tuple(self.allowed.shape[1:])):
            raise ValueError(f"masked verify with mask {tuple(allowed.shape)}: a "
                             "VerifyGraphs built with vocab_size takes [n, W, V]")
        if self.cuda:
            graph, per_replay = self._graph((n, masked))
        staging = torch.zeros(self.flat.numel(), dtype=torch.int32,
                              pin_memory=self.pinned)
        host = staging.numpy()
        for (name, s), arr in zip(self._slices.items(),
                                  (tokens, block_tables, start_pos, num_tokens)):
            host[s].reshape(self._shapes[name])[:n] = arr
        self.flat.copy_(staging, non_blocking=True)
        if masked:
            self.allowed[:n].copy_(_pinned(allowed, self.pinned), non_blocking=True)
        if self.cuda:
            graph.replay()
            self.replays += 1
            for fn, (c, c8) in per_replay.items():
                fn.launches += c
                fn.fp8_launches += c8
        else:
            self._run(n, masked)
        return HostCopy(self.targets[:n].clone())
