#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (dynamo_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. card: name and power limit from nvidia-smi;
2. build: every CUDA source under dynamo_tpu_torch/csrc compiles with nvcc
   (one process per source, in parallel) into build/dynamo_tpu_torch/;
3. kernels: each kernel is held against its plain PyTorch version on the
   card at the serving shapes of llama-3-8b (KH 8, G 4, D 128, page 16,
   B 8, 64 pages per sequence, seq_len 1..1024, plus a windowed-and-sinks
   case) and at the cases of CHECK_CASES (D 64 G 8 window 128 + sinks,
   G 1, G 16, seq_lens on and one past a split boundary, a window starting
   mid-page across splits, B 1 at seq_len 8192 and 8191): kv_write bitwise
   outside trash page 0, the attention kernels per element within two bf16
   spacings of the output plus 1e-5 in bf16 (a sound kernel reads at most
   one: it rounds the same f32 result after another order of sums) and at
   atol=rtol=1e-5 in f32, the fused kernel's pools bitwise equal to the
   plain append outside page 0. Each kernel, its plain version and one library
   call computing the same function are timed with CUDA events, L2 flushed
   before every launch, at the serving shapes and (attention) at B 1,
   seq_len 8192. One fused call captured in a CUDA graph, then an eager
   call at a larger batch on the same stream, then two replays on fresh
   pools: each replay must equal the first eager launch (nothing syncs with
   the host, and the graph keeps its own split tickets);
4. serve: InferenceEngine(ModelSpec.llama3_8b()) at full width and depth
   with random bf16 weights from a seeded generator, its decode graphs
   captured first (precompile), serves through generate(), on one event
   loop, with the kernel counts zeroed before each serve and read after:
   (a) default: 8 concurrent greedy requests (prompts of 64..512 tokens,
   two sharing a 256-token prefix, 32 tokens each); every request must end
   with "length" after exactly 32 tokens, the second sharer must hit the
   prefix cache, the fused kernel must launch exactly 32 times per decode
   step (graph replays included), and one stream's tokens must be
   near-argmax under the unpaged reference forward; (b) chunked: one
   greedy request with a 990-token prompt (two 512-token prefill chunks),
   near-argmax as (a); (c) logprobs: two identical requests with
   logprobs=5, temperature 0.8 and a seed, whose streams must be equal,
   with 5 ordered top entries per token and logprobs within LOGPROB_TOL of
   the reference forward's;
5. step graphs: the engine's one-step function captured in a CUDA graph
   (DecodeGraphs, greedy and sampled-with-logprobs variants) and replayed
   for a 4-step burst against eager decode_steps on copies of the same
   pools: tokens and logprobs identical, pools bitwise equal, 32 kernel
   launches per replay; once more with DYNAMO_FUSED_DECODE=0 (kv_write +
   paged_attention_v3 captured); host wall of a B=8 step, eager against
   graph, and one graph step traced (wall, device busy, idle share);
6. unfused: one decode_forward with DYNAMO_FUSED_DECODE=0 against the fused
   path on the same pool state; logits agree within the stated tolerance
   and paged_attention_v3 and kv_write each launch 32 times; one eager
   decode_forward traced;
7. pipelined: a second bf16 engine on the same weights (the first one's
   graphs and pools freed first) with pipeline_decode=True, depth 2 and
   decode_steps_per_dispatch=4 serves (a)'s requests with (a)'s checks;
8. fp8 (kv_dtype="fp8": e4m3 pools with one bf16 scale per page and KV
   head): phase 3's checks for the fp8 branches of both attention kernels
   at the same shapes and cases (queries in f32 and in bf16), plus new rows
   with 3x the amax their destination page's scale encodes (every scale
   grows), appends at row 0 of pages a last occupant left with a stale
   scale of 64, and inactive slots on page 0;
   the fused kernel's pool values AND scales bitwise equal to the plain
   append (ops/quant.py) outside page 0; times and bounds as in phase 3,
   SDPA over the dequantized context as the library call; one fp8 fused
   call in a CUDA graph; a second engine with kv_dtype="fp8" on the bf16
   engine's weights (its pools freed first) serves the same 8 requests
   (32 fp8 fused launches per decode step, the prefix hit, one stream
   near-argmax under the reference); phase 5's fused step graphs on the
   fp8 pools (values and scales bitwise); phase 6 on the fp8
   pools, where paged_attention_v3 launches 32 times in its fp8 form and
   the kv_write kernel never (fp8 appends are quant_append_rows, as in the
   reference);
9. HTTP: the one-process serving stack on the same weights, built through
   the port's entry points on one event loop (DistributedRuntime over an
   InMemoryHub, launch_engine_worker with pipeline_decode and its decode
   graphs captured, ModelWatcher, HttpFrontend on port 0) and driven by a
   stdlib HTTP client: /v1/models and /health (one instance); the 8
   prompts through generate() on the same engine before and after the
   HTTP run, /clear_kv_blocks between;
   the 8 prompts as concurrent streamed token-id /v1/completions (32
   tokens each, ignore_eos, include_usage: each ends with data: [DONE],
   usage.completion_tokens 32 and finish_reason "length"); one
   /v1/chat/completions through the chat template; one stream dropped
   after two chunks (the worker's admin cache_status must show no active
   page within 2 s); one malformed body (400, the reference's error JSON);
   /metrics (the TTFT histogram counts every request that reached the
   engine). fused_decode must launch 32 times per decode step over the
   phase. Prints client TTFT and tok/s beside the direct serves, and the
   share of completion texts equal to the decoded direct tokens;
10. CLI: ``python3 -m dynamo_tpu_torch.cli run --in http --out engine
   --model llama-3-8b --port 0 --precompile`` in a process of its own
   prints DYNAMO_HTTP=host:port and streams a 16-token chat completion.

Prints, before the last line, the card line and one JSON object with every
kernel's measurements; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
KERNEL_SHAPES = dict(B=8, KH=8, G=4, D=128, page=16, P=64)
SEQ_LENS = (1, 37, 130, 256, 511, 700, 1000, 1024)
WINDOW = 256  # windowed-and-sinks case
LONG = dict(B=1, P=512)  # one long context, where the context split matters most
LONG_SEQ_LEN = 8192
# (name, shape overrides, seq_lens or None for SEQ_LENS, window, sinks)
CHECK_CASES = (
    ("D64/G8/window128+sinks", dict(G=8, D=64), None, 128, True),
    ("G1", dict(G=1), None, 0, False),
    ("G16", dict(KH=2, G=16), None, 0, False),
    # a grid of S = 4 splits (B 8, KH 8 on 132 SMs), runs of at least 8
    # pages: 16 live pages (fused ctx 256 at seq_len 257, read-only 256)
    # make 2 splits and 32 (512 / 513) make 4, each context ending exactly
    # on its last split's end; 258 and 513 / 514 run one token past it
    ("split-boundary", {}, (256, 257, 258, 512, 513, 1, 2, 514), 0, False),
    # starts 7, 15 and 3 tokens into a page; 21-22 live pages in 2 splits
    ("window-mid-page", {}, None, 329, False),
    ("B1/8192", LONG, (LONG_SEQ_LEN,), 0, False),
    ("B1/8191", LONG, (LONG_SEQ_LEN - 1,), 0, False),
)
F32_TOL = 1e-5  # attention in f32: atol = rtol
BF16_SPACINGS = 2  # attention in bf16, per element: this many bf16 spacings
BF16_FLOOR = 1e-5  # of the larger of |got|, |want|, plus this (outputs near 0)
LOGIT_REL_TOL = 2e-2  # fused vs unfused logits: max |diff| / max |logit|
# reference logit of each served token vs the reference max, for both KV
# forms: the fp8 serve's worst gap read 0.062 on an H100 80GB HBM3 at 700 W
# (bf16: 0.000), so the bound leaves it 8x room
NEAR_ARGMAX = 0.5
# fp8 fused vs unfused logits: the unfused path reads each layer's new K/V
# row back at fp8 (up to half an e4m3 step, 1/16 of the value, off) where
# the fused one merges it exactly; it read 1.948e-2 on an H100 80GB HBM3 at
# 700 W beside bf16's 1.452e-2 (limit 2e-2): 5e-2 leaves room for other
# weights
LOGIT_REL_TOL_FP8 = 5e-2
STALE_SCALE = 64.0  # a recycled page's leftover scale (fresh-page case)
# served logprobs vs the unpaged reference forward's log-softmax at the
# same ids: the bound NEAR_ARGMAX puts on a logit gap
LOGPROB_TOL = 0.5
SERVE_TOKENS = 32
CHUNKED_PROMPT = 990  # tokens: prefill chunks of 512 + 478, under the 1024 context
GRAPH_STEPS = 4  # burst of the step-graph check
LOGPROBS = 5
CLI_TOKENS = 16  # the CLI phase's streamed chat completion
CLI_START_S = 180  # the CLI process's limit to print DYNAMO_HTTP=
REPS = 20
SLEEP_CYCLES = 5_000_000  # ~2.5 ms of device time at the H100's clock


class SmokeError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ timing


def time_ms(fn, flush, reps=REPS) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, each after an L2
    flush (the decode path finds its pages cold: 32 layers of context far
    exceed the 50 MB L2)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        # keep the device busy while the host enqueues the rest, so the
        # events time the device work and not the wrapper's host overhead
        torch.cuda._sleep(SLEEP_CYCLES)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ------------------------------------------------------------ kernels


def kernel_inputs(dtype, seed=0, seq_lens=SEQ_LENS, **over):
    """Decode-step inputs at the serving shapes (or ``over``); pools hold
    L=2 layers."""
    s = {**KERNEL_SHAPES, **over}
    B, KH, G, D, page, P = s["B"], s["KH"], s["G"], s["D"], s["page"], s["P"]
    seq_lens = (tuple(seq_lens) * B)[:B]
    rng = np.random.default_rng(seed)
    NP = 1 + B * P
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    bt = np.zeros((B, P), np.int32)
    for i in range(B):
        bt[i] = rng.permutation(np.arange(1 + i * P, 1 + (i + 1) * P))
    sl = np.asarray(seq_lens, np.int32)
    pos = sl - 1
    dst_page = np.asarray([bt[i, pos[i] // page] for i in range(B)], np.int32)
    cuda = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    return {
        "q": randn(B, KH * G, D), "k_pages": randn(2, NP, KH, page, D),
        "v_pages": randn(2, NP, KH, page, D), "k_new": randn(B, KH, D),
        "v_new": randn(B, KH, D), "bt": cuda(bt), "sl": cuda(sl),
        "dst_page": cuda(dst_page), "dst_off": cuda((pos % page).astype(np.int32)),
        "sinks": torch.randn(KH * G, generator=gen, device=DEVICE),
    }


def fp8_pools(t, seed=0):
    """Replace t's pools by fp8 QuantPools that dequantize to about the
    same normal draws (ops/cuda/sweep.py fp8_pool)."""
    from dynamo_tpu_torch.ops.cuda.sweep import fp8_pool

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1000 + seed)
    for name in ("k_pages", "v_pages"):
        t[name] = fp8_pool(t[name], gen)
    return t


def clone_pool(p):
    from dynamo_tpu_torch.ops.quant import QuantPool, is_quant

    return QuantPool(p.vals.clone(), p.scale.clone()) if is_quant(p) else p.clone()


def pools_equal(a, b) -> bool:
    """Bitwise equality outside trash page 0 (values, and scales of fp8
    pools)."""
    from dynamo_tpu_torch.ops.quant import is_quant

    if is_quant(a):
        return (torch.equal(a.vals[:, 1:].view(torch.uint8), b.vals[:, 1:].view(torch.uint8))
                and torch.equal(a.scale[:, 1:], b.scale[:, 1:]))
    return torch.equal(a[:, 1:], b[:, 1:])


def copy_pool_(dst, src) -> None:
    from dynamo_tpu_torch.ops.quant import is_quant

    if is_quant(dst):
        dst.vals.view(torch.uint8).copy_(src.vals.view(torch.uint8))
        dst.scale.copy_(src.scale)
    else:
        dst.copy_(src)


def visible(seq_lens, window, fused):
    """Per sequence: pool positions the function must read."""
    out = []
    for s in seq_lens:
        ctx = s - 1 if fused else s
        lo = max(s - window, 0) if window else 0
        out.append(max(ctx - lo, 0))
    return out


def attention_bound(fused: bool, window: int, seq_lens=SEQ_LENS, fp8=False,
                    **over) -> tuple[float, str]:
    """Least time for one call: bytes read and written once over the HBM
    rate, or flops over the bf16 peak. fp8 pools move 1 byte per element
    plus 2 bytes of scale per live (page, KV head) for K and for V; the
    fused fp8 append rewrites the head's whole page run and its scale."""
    s = {**KERNEL_SHAPES, **over}
    B, KH, G, D, page = s["B"], s["KH"], s["G"], s["D"], s["page"]
    H, el = KH * G, 2
    pel = 1 if fp8 else el  # pool element bytes
    vis = visible(seq_lens, window, fused)
    pages = sum(-(-v // page) for v in vis)
    nbytes = 2 * B * H * D * el  # q in, out
    nbytes += sum(vis) * 2 * KH * D * pel  # K and V of the live context
    nbytes += pages * 4 + B * 4  # table, lens
    if fp8:
        nbytes += pages * KH * 2 * 2  # K and V scales of the live pages
    flops = 4 * H * D * sum(vis)  # q.k and p.v
    if fused:
        nbytes += 2 * B * KH * D * el + 2 * B * 4  # new rows in, dst indices
        if fp8:
            nbytes += 2 * B * KH * (page * D + 2)  # page runs + scales out
        else:
            nbytes += 2 * B * KH * D * el  # rows out
        flops += 4 * H * D * B
    return bound_ms(nbytes, flops)


def sdpa_call(t, layer):
    """One scaled_dot_product_attention call over the gathered context
    (the library yardstick; the port never calls it). Gather, fp8 dequant
    (to q's dtype) and GQA expansion are set-up, outside the timed call."""
    from dynamo_tpu_torch.ops.attention import gather_ctx, pool_layer

    q = t["q"]
    B, H, D = q.shape
    KH = t["k_pages"].shape[2]
    k = gather_ctx(pool_layer(t["k_pages"], layer), t["bt"]).to(q.dtype)  # [B, S, KH, D]
    v = gather_ctx(pool_layer(t["v_pages"], layer), t["bt"]).to(q.dtype)
    S = k.shape[1]
    k = k.transpose(1, 2).repeat_interleave(H // KH, dim=1).contiguous()
    v = v.transpose(1, 2).repeat_interleave(H // KH, dim=1).contiguous()
    pos = torch.arange(S, device=q.device)[None]
    mask = (pos < t["sl"].long()[:, None])[:, None, None, :]
    qq = q[:, :, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask)


def bf16_spacing(x: torch.Tensor) -> torch.Tensor:
    """Gap between neighbouring bf16 values at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs().clamp(min=2.0 ** -100))
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)


def attention_error(got, want, case: str) -> tuple[float, str]:
    """Max abs error of ``got`` against ``want``, and its reading (in bf16
    also in spacings of the output); fails the case past its limit."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    max_err = err.max().item()
    require(torch.isfinite(got).all().item(), f"{case}: non-finite")
    if got.dtype == torch.bfloat16:
        sp = bf16_spacing(torch.maximum(g.abs(), w.abs()))
        use = (err / (BF16_SPACINGS * sp + BF16_FLOOR)).max().item()
        reading = (f"{max_err:.3e} ({(err / sp).max().item():.2f} bf16 spacings, "
                   f"{use:.3f} of the limit)")
        ok = use <= 1.0
        limit = f"{BF16_SPACINGS} spacings + {BF16_FLOOR}"
    else:
        reading = f"{max_err:.3e}"
        ok = max_err <= F32_TOL + F32_TOL * w.abs().max().item()
        limit = f"{F32_TOL} + {F32_TOL} * max|want|"
    require(ok, f"{case}: max err {reading}, max |want| "
                f"{w.abs().max().item():.3e}, limit {limit}")
    return max_err, reading


def check_attention(t, case: str, window: int, sinks,
                    layer: int = 1) -> tuple[float, float]:
    """Both attention kernels against their plain versions on inputs ``t``;
    the fused kernel's pools must equal the plain append outside page 0.
    Returns the two max abs errors."""
    from dynamo_tpu_torch.ops.attention import pool_layer
    from dynamo_tpu_torch.ops.cuda import fused_decode, paged_attention_v3

    args = ("q", "k_new", "v_new", "bt", "sl", "dst_page", "dst_off")
    q, kn, vn, bt, sl, dp, do = (t[k] for k in args)
    kp, vp = clone_pool(t["k_pages"]), clone_pool(t["v_pages"])
    kp2, vp2 = clone_pool(t["k_pages"]), clone_pool(t["v_pages"])
    got = fused_decode.fused_decode_attention(
        q, kp, vp, kn, vn, bt, sl, dp, do, layer=layer,
        window=window, sinks=sinks)
    want = fused_decode.fused_decode_plain(
        q, kp2, vp2, kn, vn, bt, sl, dp, do, layer=layer,
        window=window, sinks=sinks)
    torch.cuda.synchronize()
    err_f, read_f = attention_error(got, want, f"fused_decode {case}")
    require(pools_equal(kp, kp2) and pools_equal(vp, vp2),
            f"fused_decode {case}: pools differ from the plain append")
    kl, vl = pool_layer(kp, layer), pool_layer(vp, layer)
    got = paged_attention_v3.paged_decode_attention_v3(
        q, kl, vl, bt, sl, window=window, sinks=sinks)
    want = paged_attention_v3.paged_attention_v3_plain(
        q, kl, vl, bt, sl, window=window, sinks=sinks)
    torch.cuda.synchronize()
    err_v, read_v = attention_error(got, want, f"paged_attention_v3 {case}")
    print(f"check {case}: fused_decode max err {read_f}, "
          f"paged_attention_v3 max err {read_v}")
    return err_f, err_v


def fused_vs_read_only(t, layer: int) -> None:
    """The two kernels on one state (the fused form, then the read-only form
    over its appended pool) compute the same function with the new key
    merged at another point of the f32 sums; print how far their bf16
    outputs drift apart, in units of the output's bf16 spacing."""
    from dynamo_tpu_torch.ops.cuda import fused_decode, paged_attention_v3

    args = ("q", "k_new", "v_new", "bt", "sl", "dst_page", "dst_off")
    q, kn, vn, bt, sl, dp, do = (t[k] for k in args)
    kp, vp = t["k_pages"].clone(), t["v_pages"].clone()
    a = fused_decode.fused_decode_attention(q, kp, vp, kn, vn, bt, sl, dp, do, layer=layer)
    b = paged_attention_v3.paged_decode_attention_v3(q, kp[layer], vp[layer], bt, sl)
    diff = (a.float() - b.float()).abs()
    sp = bf16_spacing(torch.maximum(a.float().abs(), b.float().abs()))
    print(f"fused vs read-only on the appended pool: max abs diff {diff.max().item():.3e}, "
          f"{(diff > 0).float().mean().item():.4f} of outputs differ, at most "
          f"{(diff / sp).max().item():.2f} bf16 spacings")


def check_kernels(flush) -> dict[str, dict]:
    from dynamo_tpu_torch.ops.cuda import kv_write

    results: dict[str, dict] = {}
    layer = 1
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        t = kernel_inputs(dt)
        for window, sinks in ((0, None), (WINDOW, t["sinks"])):
            case = f"{dtype_name}{'/window+sinks' if window else ''}"
            err_f, err_v = check_attention(t, case, window, sinks, layer)
            if dtype_name == "bfloat16" and window == 0:
                fused_vs_read_only(t, layer)
                results["fused_decode"] = {"max_abs_err": err_f}
                results["paged_attention_v3"] = {"max_abs_err": err_v}
        kp, vp = t["k_pages"].clone(), t["v_pages"].clone()
        kp2, vp2 = kp.clone(), vp.clone()
        kv_write.kv_write(kp, vp, t["k_new"], t["v_new"], t["dst_page"],
                          t["dst_off"], layer=0)
        kv_write.kv_write_plain(kp2, vp2, t["k_new"], t["v_new"],
                                t["dst_page"], t["dst_off"], layer=0)
        torch.cuda.synchronize()
        require(torch.equal(kp[:, 1:], kp2[:, 1:]) and torch.equal(vp[:, 1:], vp2[:, 1:]),
                f"kv_write {dtype_name}: not bitwise equal to index_put_")
        print(f"check {dtype_name}: kv_write bitwise equal outside page 0")
        if dtype_name == "bfloat16":
            results["kv_write"] = {"max_abs_err": 0.0}
        del t
        for name, over, seq_lens, window, with_sinks in CHECK_CASES:
            tc = kernel_inputs(dt, seed=len(name), seq_lens=seq_lens or SEQ_LENS, **over)
            check_attention(tc, f"{dtype_name}/{name}", window,
                            tc["sinks"] if with_sinks else None, layer)
            del tc

    # timing at the serving shapes, bf16, no window
    times = time_attention(flush, fp8=False)
    for name in ("fused_decode", "paged_attention_v3"):
        results[name].update(times[name])
    t = kernel_inputs(torch.bfloat16)
    q, kn, vn, dp, do = (t[k] for k in ("q", "k_new", "v_new", "dst_page", "dst_off"))
    kp, vp = t["k_pages"], t["v_pages"]
    B, H, D = q.shape
    KH, page = kp.shape[2], kp.shape[3]
    res = results["kv_write"]
    res["ms"] = time_ms(lambda: kv_write.kv_write(
        kp, vp, kn, vn, dp, do, layer=layer), flush)
    res["plain_ms"] = time_ms(lambda: kv_write.kv_write_plain(
        kp, vp, kn, vn, dp, do, layer=layer), flush)
    NP = kp.shape[1]
    rows = (((layer * NP + dp.long()) * KH)[:, None]
            + torch.arange(KH, device=DEVICE)[None]) * page + do.long()[:, None]
    rows = rows.reshape(-1)
    kflat, vflat = kp.view(-1, D), vp.view(-1, D)
    kr, vr = kn.reshape(-1, D), vn.reshape(-1, D)

    def library_copy():  # one index_copy_ per pool
        kflat.index_copy_(0, rows, kr)
        vflat.index_copy_(0, rows, vr)

    res["library_ms"] = time_ms(library_copy, flush)
    el = 2
    res["bound_ms"], res["bound_by"] = bound_ms(
        4 * B * KH * D * el + 2 * B * 4, 0.0)
    del t, kp, vp, kflat, vflat
    print_times(results)
    return results


def time_attention(flush, fp8: bool) -> dict[str, dict]:
    """Both attention kernels, their plain versions and SDPA timed at the
    serving shapes and (keys with "long_") at B 1 x LONG_SEQ_LEN, bf16
    queries, no window; pools bf16 or fp8."""
    from dynamo_tpu_torch.ops.attention import pool_layer
    from dynamo_tpu_torch.ops.cuda import fused_decode, paged_attention_v3

    out: dict[str, dict] = {"fused_decode": {}, "paged_attention_v3": {}}
    layer = 1
    for key, seq_lens, over in (("", SEQ_LENS, {}), ("long_", (LONG_SEQ_LEN,), LONG)):
        t = kernel_inputs(torch.bfloat16, seq_lens=seq_lens, **over)
        if fp8:
            fp8_pools(t)
        q, kn, vn, bt, sl, dp, do = (t[k] for k in
                                     ("q", "k_new", "v_new", "bt", "sl", "dst_page", "dst_off"))
        kp, vp = t["k_pages"], t["v_pages"]
        kl, vl = pool_layer(kp, layer), pool_layer(vp, layer)
        sdpa = sdpa_call(t, layer)
        fns = {
            "fused_decode": (
                lambda: fused_decode.fused_decode_attention(
                    q, kp, vp, kn, vn, bt, sl, dp, do, layer=layer),
                lambda: fused_decode.fused_decode_plain(
                    q, kp, vp, kn, vn, bt, sl, dp, do, layer=layer), True),
            "paged_attention_v3": (
                lambda: paged_attention_v3.paged_decode_attention_v3(q, kl, vl, bt, sl),
                lambda: paged_attention_v3.paged_attention_v3_plain(q, kl, vl, bt, sl),
                False),
        }
        for name, (kernel, plain, fused) in fns.items():
            r = out[name]
            r[key + "ms"] = time_ms(kernel, flush)
            r[key + "plain_ms"] = time_ms(plain, flush)
            r[key + "library_ms"] = time_ms(sdpa, flush)
            r[key + "bound_ms"], by = attention_bound(fused, 0, seq_lens=seq_lens,
                                                      fp8=fp8, **over)
            if not key:
                r["bound_by"] = by
        del t, kp, vp, kl, vl, sdpa, fns
    return out


def print_times(results: dict[str, dict]) -> None:
    for name, r in results.items():
        print(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']})")
        if "long_ms" in r:
            print(f"time {name} B=1 seq_len {LONG_SEQ_LEN}: kernel {r['long_ms']:.4f} ms, "
                  f"plain {r['long_plain_ms']:.4f} ms, library "
                  f"{r['long_library_ms']:.4f} ms, bound {r['long_bound_ms']:.5f} ms")


FP8_CASES = ("scale-growth", "fresh-over-polluted", "inactive-slots")


def fp8_case_inputs(dt, case: str, seed: int, layer: int):
    """Inputs of the fp8-only cases at the serving shapes (fp8 pools):
    new rows with 3x the amax their destination page's scale encodes
    (448 x scale, per head), so every appended page's scale grows about 3x
    and its old rows re-encode; appends at row 0 of pages whose last
    occupant left garbage and a scale of STALE_SCALE; two inactive slots
    (seq_len 1) appending to trash page 0."""
    from dynamo_tpu_torch.ops.quant import FP8_MAX

    if case == "fresh-over-polluted":
        # every position seq_len - 1 starts a page
        t = fp8_pools(kernel_inputs(dt, seed=seed, seq_lens=(17, 33, 1, 129, 257, 513,
                                                              769, 1009)), seed)
        require(bool((t["dst_off"] == 0).all()), "fresh-page case: dst_off != 0")
        for name in ("k_pages", "v_pages"):
            t[name].scale[:, t["dst_page"].long()] = STALE_SCALE
        return t
    t = fp8_pools(kernel_inputs(dt, seed=seed), seed)
    if case == "scale-growth":
        for nk, pk in (("k_new", "k_pages"), ("v_new", "v_pages")):
            encodes = FP8_MAX * t[pk].scale[layer, t["dst_page"].long()].float()  # [B, KH]
            row = t[nk].float()
            t[nk] = (row * (3 * encodes / row.abs().amax(-1))[..., None]).to(dt)
    elif case == "inactive-slots":
        for i in (1, 5):
            t["sl"][i], t["dst_page"][i], t["dst_off"][i] = 1, 0, 0
    else:
        raise SmokeError(f"unknown fp8 case {case}")
    return t


def check_kernels_fp8(flush) -> dict[str, dict]:
    """The fp8 branches of both attention kernels: queries in f32 and bf16
    over e4m3 pools, at the serving shapes (with and without window and
    sinks), every CHECK_CASES entry and FP8_CASES; then timed as phase 3."""
    results: dict[str, dict] = {"fused_decode/fp8": {}, "paged_attention_v3/fp8": {}}
    layer = 1
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        t = fp8_pools(kernel_inputs(dt))
        for window, sinks in ((0, None), (WINDOW, t["sinks"])):
            case = f"fp8/{dtype_name}{'/window+sinks' if window else ''}"
            err_f, err_v = check_attention(t, case, window, sinks, layer)
            if dtype_name == "bfloat16" and window == 0:
                results["fused_decode/fp8"]["max_abs_err"] = err_f
                results["paged_attention_v3/fp8"]["max_abs_err"] = err_v
        del t
        for name, over, seq_lens, window, with_sinks in CHECK_CASES:
            tc = fp8_pools(kernel_inputs(dt, seed=len(name), seq_lens=seq_lens or SEQ_LENS,
                                         **over), seed=len(name))
            check_attention(tc, f"fp8/{dtype_name}/{name}", window,
                            tc["sinks"] if with_sinks else None, layer)
            del tc
        for i, case in enumerate(FP8_CASES):
            tc = fp8_case_inputs(dt, case, 40 + i, layer)
            check_attention(tc, f"fp8/{dtype_name}/{case}", 0, None, layer)
            del tc
    times = time_attention(flush, fp8=True)
    for name in ("fused_decode", "paged_attention_v3"):
        results[name + "/fp8"].update(times[name])
    print_times(results)
    return results


def graph_check(fp8: bool = False) -> None:
    """Capture one fused_decode_attention call in a CUDA graph, make an
    eager call at twice the batch on the capture stream (which outgrows the
    stream's ticket buffer), then replay the graph twice on fresh pool
    copies: the output must equal the eager launch and the pools the plain
    append (with fp8 pools: values and the scales the kernel writes inside
    the graph). A ticket left dirty, a graph sharing tickets that an eager
    call frees, or a host read inside the wrapper (at capture), fails
    here."""
    from dynamo_tpu_torch.ops.cuda import fused_decode

    t = kernel_inputs(torch.bfloat16, seed=5)
    if fp8:
        fp8_pools(t, seed=5)
    args = ("q", "k_new", "v_new", "bt", "sl", "dst_page", "dst_off")
    q, kn, vn, bt, sl, dp, do = (t[k] for k in args)
    layer = 1
    kp_ref, vp_ref = clone_pool(t["k_pages"]), clone_pool(t["v_pages"])
    fused_decode.fused_decode_plain(q, kp_ref, vp_ref, kn, vn, bt, sl, dp, do,
                                    layer=layer, sinks=t["sinks"])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    kp, vp = clone_pool(t["k_pages"]), clone_pool(t["v_pages"])
    with torch.cuda.stream(side):  # eager launch on the capture stream
        eager = fused_decode.fused_decode_attention(
            q, clone_pool(kp), clone_pool(vp), kn, vn, bt, sl, dp, do, layer=layer,
            sinks=t["sinks"])
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fused_decode.fused_decode_attention(
            q, kp, vp, kn, vn, bt, sl, dp, do, layer=layer, sinks=t["sinks"])
    big = kernel_inputs(torch.bfloat16, seed=6, B=2 * KERNEL_SHAPES["B"])
    if fp8:
        fp8_pools(big, seed=6)
    with torch.cuda.stream(side):
        fused_decode.fused_decode_attention(
            *(big[k] for k in ("q", "k_pages", "v_pages", "k_new", "v_new", "bt",
                               "sl", "dst_page", "dst_off")), layer=layer)
    side.synchronize()
    del big
    form = "fp8" if fp8 else "bf16"
    for rep in range(2):
        copy_pool_(kp, t["k_pages"])
        copy_pool_(vp, t["v_pages"])
        graph.replay()
        torch.cuda.synchronize()
        require(torch.equal(out, eager), f"graph {form} replay {rep}: output differs from eager")
        require(pools_equal(kp, kp_ref) and pools_equal(vp, vp_ref),
                f"graph {form} replay {rep}: pools differ from the plain append")
    print(f"graph {form}: fused_decode captured once, an eager call at twice the batch, "
          "replayed twice: output equal to the eager launch, pools equal to the "
          "plain append")


# ------------------------------------------------------------ serving


def make_prompts(vocab: int):
    rng = np.random.default_rng(1234)
    lens = rng.integers(64, 513, size=8)
    prompts = [rng.integers(3, vocab, int(n)).tolist() for n in lens]
    shared = rng.integers(3, vocab, 256).tolist()
    # requests 0 and 1 share a 256-token prefix (16 full pages)
    prompts[0] = shared + prompts[0][: max(int(lens[0]) - 256, 16)]
    prompts[1] = shared + rng.integers(3, vocab, 100).tolist()
    return prompts


async def serve(engine, prompts):
    from dynamo_tpu_torch.runtime.context import Context

    t0 = time.perf_counter()
    ttft: dict[int, float] = {}
    first_token = asyncio.Event()

    async def one(i):
        req = {"token_ids": prompts[i], "sampling": {"temperature": 0.0},
               "stop_conditions": {"max_tokens": SERVE_TOKENS, "ignore_eos": True}}
        t_sub = time.perf_counter()
        items = []
        async for item in engine.generate(req, Context()):
            if item["token_ids"] and i not in ttft:
                ttft[i] = time.perf_counter() - t_sub
                if i == 0:
                    first_token.set()
            items.append(item)
        return items

    tasks = {i: asyncio.ensure_future(one(i)) for i in range(len(prompts)) if i != 1}
    # the second sharer arrives once the first one's prompt pages are sealed
    await first_token.wait()
    cached_before = engine.cached_prompt_tokens
    tasks[1] = asyncio.ensure_future(one(1))
    results = {i: await task for i, task in tasks.items()}
    wall = time.perf_counter() - t0
    return results, ttft, wall, engine.cached_prompt_tokens - cached_before


def near_argmax_check(spec, params, prompt, tokens) -> tuple[float, float]:
    """Teacher-forced unpaged reference forward over prompt + served
    tokens: each served token's reference logit must lie within NEAR_ARGMAX
    of the reference maximum. Returns (exact agreement, worst gap)."""
    from dynamo_tpu_torch.models import llama

    seq = torch.tensor(prompt + tokens[:-1], device=DEVICE)
    with torch.no_grad():
        logits = llama.reference_forward(spec, params, seq)[len(prompt) - 1:]
    served = torch.tensor(tokens, device=DEVICE)
    top = logits.max(dim=-1).values
    picked = logits.gather(1, served[:, None])[:, 0]
    gap = (top - picked).max().item()
    agree = (logits.argmax(dim=-1) == served).float().mean().item()
    require(torch.isfinite(logits).all().item(), "reference logits non-finite")
    require(gap <= NEAR_ARGMAX, f"served token {gap:.3f} below the reference max")
    return agree, gap


def profile_decode_step(step, form: str) -> None:
    """One traced decode step (B=8, fused path): wall time, device-busy
    time (sum of kernel self times, kernels replayed from a CUDA graph
    included), idle share, the fused kernel's device time and the top
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    # device-side events only: a CPU op's device time repeats its kernels'
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels)
    attn = [e for e in kernels if "decode_attention_kernel" in e.key]
    if not busy:
        print(f"profile {form}: wall {wall * 1e3:.2f} ms; device busy not measured "
              "(the trace holds no device kernels)")
        return
    print(f"profile {form}: wall {wall * 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms, idle share {max(0.0, 1 - busy / 1e6 / wall):.3f}, "
          f"fused_decode {sum(dev_us(e) for e in attn) / 1e3:.3f} ms over "
          f"{sum(e.count for e in attn)} launches")
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        print(f"  {dev_us(e) / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")


def prefill_slots(engine, prompts, room: int = 1):
    """Prefill ``prompts`` into fresh pages of the engine's pools (one
    packed prefill, beside the engine); returns host arrays: block tables
    [B, P] with page room for ``room`` decode tokens, the first tokens
    (argmax) [B] and seq_lens [B] counting them, int32."""
    from dynamo_tpu_torch.models import llama

    spec, cfg = engine.spec, engine.config
    B = len(prompts)
    bts = np.zeros((B, cfg.max_pages_per_seq), np.int32)
    for i, p in enumerate(prompts):
        for j in range((len(p) + room - 1) // cfg.page_size + 1):
            bts[i, j] = engine.allocator.alloc_page()
    tokens = np.zeros((B, cfg.bucket_for(max(len(p) for p in prompts))), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = p
    lens = torch.tensor([len(p) for p in prompts])
    with torch.no_grad():
        logits = llama.prefill_forward_batch(
            spec, engine.params, torch.from_numpy(tokens).to(DEVICE),
            torch.from_numpy(bts).to(DEVICE), torch.zeros(B, dtype=torch.int64),
            engine.k_pages, engine.v_pages, lens)
    first = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
    return bts, first, (lens + 1).to(torch.int32).numpy()


def host_ms(fn, reps: int = 10) -> float:
    """Mean host wall time of ``fn()`` up to the device's completion."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def step_graph_check(engine, prompts, unfused: bool = False) -> None:
    """The engine's one-step function captured in a CUDA graph
    (engine/graphs.DecodeGraphs) against eager decode_steps, on copies of
    the same pools after a prefill of ``prompts``: a GRAPH_STEPS burst in
    the greedy variant and in the sampled variant with logprobs (half the
    rows at temperature 0.8, with top-k / top-p on some). Tokens and
    logprobs must be identical and the pools bitwise equal outside page 0;
    each replay must run one attention launch per layer (unfused: v3 and
    kv_write each). Then, fused, the host wall of one B=8 step of each
    variant, eager against graph, and one traced greedy graph step."""
    from dynamo_tpu_torch.engine.graphs import DecodeGraphs
    from dynamo_tpu_torch.models import llama

    spec, cfg = engine.spec, engine.config
    form = engine.kv_dtype + (" unfused" if unfused else "")
    L, B, n = spec.num_layers, len(prompts), GRAPH_STEPS
    n_lp = min(20, spec.vocab_size - 1)
    bts, first, seq_lens = prefill_slots(engine, prompts, room=n)
    half = B // 2
    inputs = {
        "tokens": first, "block_tables": bts, "seq_lens": seq_lens,
        "active": np.ones(B, bool),
        "temperature": np.asarray([0.0] * half + [0.8] * (B - half), np.float32),
        "top_k": np.asarray([0] * (B - 2) + [40, 0], np.int32),
        "top_p": np.asarray([1.0] * (B - 1) + [0.9], np.float32),
        "seeds": (np.arange(B, dtype=np.uint32) * 7919 + 11).astype(np.uint32),
        "steps": np.zeros(B, np.int32),
    }
    if unfused:
        os.environ["DYNAMO_FUSED_DECODE"] = "0"
    want_counts = ({"paged_attention_v3": L * n, "kv_write": L * n} if unfused
                   else {"fused_decode": L * n})
    try:
        for sampled, lp_width in ((False, 0), (True, n_lp)):
            inp = dict(inputs, temperature=inputs["temperature"] * sampled)
            eager_pools = (clone_pool(engine.k_pages), clone_pool(engine.v_pages))
            graph_pools = (clone_pool(engine.k_pages), clone_pool(engine.v_pages))
            with torch.no_grad():
                want = llama.decode_steps(
                    spec, engine.params, *(torch.from_numpy(inp[k]) for k in
                                           ("tokens", "block_tables", "seq_lens")),
                    *eager_pools, torch.from_numpy(inp["active"]),
                    *(torch.from_numpy(inp[k]) for k in ("temperature", "top_k", "top_p")),
                    torch.from_numpy(inp["seeds"].astype(np.int64)),
                    torch.from_numpy(inp["steps"]), n_steps=n, n_logprobs=lp_width)
            want = [x.cpu().numpy() for x in (want if lp_width else (want,))]

            def step(t, s, k, pools=graph_pools):
                llama.decode_step_(spec, engine.params, *pools, t, sampled=s, n_logprobs=k)

            runner = DecodeGraphs(step, batch=B, pages_per_seq=cfg.max_pages_per_seq,
                                  max_steps=n, n_logprobs=n_lp, device=torch.device(DEVICE))
            with torch.no_grad():
                runner.precompile([(sampled, lp_width)])
                zero_counts()
                got = runner.dispatch(inp, n, sampled=sampled, n_logprobs=lp_width).result()
            counts = {k: v for k, v in read_counts().items() if v}
            variant = f"{'sampled' if sampled else 'greedy'}, n_logprobs {lp_width}"
            require(counts == {**want_counts, **({"fused_decode/fp8": L * n} if not unfused
                                                 and engine.kv_dtype == "fp8" else {})},
                    f"graph {form} ({variant}): launches {counts} over {n} replays")
            require(np.array_equal(got[0], first), f"graph {form}: fed column differs")
            tok_ok = np.array_equal(got[1], want[0])
            lp_diff = max((float(np.abs(a.astype(np.float64) - b).max())
                           for a, b in zip(got[2::2], want[1::2])), default=0.0)
            ids_ok = lp_width == 0 or np.array_equal(got[3], want[2])
            pools_ok = (pools_equal(graph_pools[0], eager_pools[0])
                        and pools_equal(graph_pools[1], eager_pools[1]))
            print(f"graph {form} ({variant}): {n} replays vs eager decode_steps: tokens "
                  f"{'identical' if tok_ok else 'DIFFER'}, logprobs max |diff| {lp_diff:.3e}, "
                  f"top ids {'identical' if ids_ok else 'DIFFER'}, pools "
                  f"{'bitwise equal' if pools_ok else 'DIFFER'}; launches {counts}")
            require(tok_ok and ids_ok and lp_diff == 0.0 and pools_ok,
                    f"graph {form} ({variant}) differs from eager decode_steps")
            if not unfused:

                def graph_step():
                    return runner.dispatch(inp, 1, sampled=sampled,
                                           n_logprobs=lp_width).result()

                def eager_step():
                    with torch.no_grad():
                        out = llama.decode_steps(
                            spec, engine.params, *(torch.from_numpy(inp[k]) for k in
                                                   ("tokens", "block_tables", "seq_lens")),
                            *eager_pools, torch.from_numpy(inp["active"]),
                            *(torch.from_numpy(inp[k]) for k in
                              ("temperature", "top_k", "top_p")),
                            torch.from_numpy(inp["seeds"].astype(np.int64)),
                            torch.from_numpy(inp["steps"]), n_steps=1, n_logprobs=lp_width)
                        return [x.cpu() for x in (out if lp_width else (out,))]

                e_ms, g_ms = host_ms(eager_step), host_ms(graph_step)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                burst = runner.dispatch(inp, 1, sampled=sampled, n_logprobs=lp_width)
                end.record()
                burst.result()
                print(f"step {engine.kv_dtype} B={B} ({variant}): host wall eager decode_steps "
                      f"{e_ms:.2f} ms, graph replay {g_ms:.2f} ms ({e_ms / g_ms:.1f}x); "
                      f"graph step device span {start.elapsed_time(end):.3f} ms")
                if not sampled:
                    profile_decode_step(graph_step, f"{engine.kv_dtype} graph step")
            runner.release()
            del eager_pools, graph_pools, runner
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("DYNAMO_FUSED_DECODE", None)


def unfused_check(engine, prompts):
    """One decode step through the fused kernel and through the unfused
    pair on the same pool state. Each path reads only the context below
    the new token plus its own new row, so the second run sees the same
    state as the first. With fp8 pools the unfused pair is the quantized
    append (quant_append_rows: the kv_write kernel does not launch) and
    paged_attention_v3's fp8 form, which reads the new row back at fp8.
    Returns the unfused run's launches (v3, v3 in fp8 form, kv_write)."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.ops.cuda import fused_decode, kv_write, paged_attention_v3

    spec = engine.spec
    fp8 = engine.kv_dtype == "fp8"
    B = len(prompts)
    bts, first, lens = prefill_slots(engine, prompts)
    bts_d = torch.from_numpy(bts).to(DEVICE)
    nxt = torch.from_numpy(first).to(DEVICE)
    seq_lens = torch.from_numpy(lens).to(DEVICE)
    fused_fn = fused_decode.fused_decode_attention
    v3_fn = paged_attention_v3.paged_decode_attention_v3
    with torch.no_grad():
        active = torch.ones(B, dtype=torch.bool, device=DEVICE)
        profile_decode_step(lambda: llama.decode_forward(
            spec, engine.params, nxt, bts_d, seq_lens, engine.k_pages,
            engine.v_pages, active), f"{engine.kv_dtype} eager decode_forward")
        out = {}
        for mode in ("1", "0"):
            os.environ["DYNAMO_FUSED_DECODE"] = mode
            for fn in (fused_fn, v3_fn):
                fn.launches = fn.fp8_launches = 0
            kv_write.kv_write.launches = 0
            out[mode] = llama.decode_forward(
                spec, engine.params, nxt, bts_d, seq_lens, engine.k_pages,
                engine.v_pages, active)
            torch.cuda.synchronize()
            out[mode + "_launches"] = [fused_fn.launches, fused_fn.fp8_launches,
                                       v3_fn.launches, v3_fn.fp8_launches,
                                       kv_write.kv_write.launches]
        os.environ.pop("DYNAMO_FUSED_DECODE")
    L = spec.num_layers
    f8 = L if fp8 else 0
    require(out["1_launches"] == [L, f8, 0, 0, 0],
            f"fused path launches (fused, fp8, v3, fp8, kv_write) {out['1_launches']}")
    want = [0, 0, L, f8, 0 if fp8 else L]
    require(out["0_launches"] == want,
            f"unfused path launches (fused, fp8, v3, fp8, kv_write) {out['0_launches']}")
    tol = LOGIT_REL_TOL_FP8 if fp8 else LOGIT_REL_TOL
    ref, alt = out["1"], out["0"]
    rel = ((alt - ref).abs().max() / ref.abs().max()).item()
    agree = (alt.argmax(-1) == ref.argmax(-1)).float().mean().item()
    require(torch.isfinite(alt).all().item(), "unfused logits non-finite")
    require(rel <= tol, f"unfused {engine.kv_dtype} logits differ: rel {rel:.3e}")
    print(f"unfused {engine.kv_dtype}: logits max|diff|/max|logit| = {rel:.3e} (tol {tol}), "
          f"argmax agreement {agree:.3f}, launches (fused, fused fp8, v3, v3 fp8, "
          f"kv_write) {out['1_launches']} then {out['0_launches']}")
    return out["0_launches"][2:]


def zero_counts() -> None:
    from dynamo_tpu_torch.ops.cuda import fused_decode, kv_write, paged_attention_v3  # noqa: F401
    from dynamo_tpu_torch.ops.cuda.build import KERNELS

    for fn in KERNELS:
        fn.launches = fn.fp8_launches = 0


def read_counts() -> dict[str, int]:
    """Kernels run since zero_counts(), graph replays included."""
    from dynamo_tpu_torch.ops.cuda import fused_decode, kv_write, paged_attention_v3

    f = fused_decode.fused_decode_attention
    v3 = paged_attention_v3.paged_decode_attention_v3
    return {"fused_decode": f.launches, "fused_decode/fp8": f.fp8_launches,
            "paged_attention_v3": v3.launches, "paged_attention_v3/fp8": v3.fp8_launches,
            "kv_write": kv_write.kv_write.launches}


def serve_phases(engine, phases):
    """Drive ``phases`` [(name, async fn(engine))] on one event loop (the
    engine's step thread posts to the loop that started it), the kernel
    counts zeroed just before each and read just after; closes the engine.
    Returns {name: {"res": fn's result, "counts": kernel launches, and the
    phase's model "steps", decode dispatch "times", graph "replays",
    eager "readmits" and prefill "chunks"}}."""

    def marks():
        return {"steps": engine.steps, "replays": engine._graphs.replays,
                "readmits": engine.eager_readmits, "chunks": engine.prefill_chunks}

    async def drive():
        out = {}
        try:
            for name, fn in phases:
                before, n0 = marks(), len(engine.decode_step_times)
                zero_counts()
                res = await fn(engine)
                counts = read_counts()
                out[name] = {"res": res, "counts": counts,
                             "times": list(engine.decode_step_times)[n0:],
                             **{k: v - before[k] for k, v in marks().items()}}
        finally:
            await engine.close()
        return out

    return asyncio.run(drive())


def precompile(engine, label: str) -> None:
    t0 = time.perf_counter()
    engine.precompile()
    torch.cuda.synchronize()
    print(f"precompile {label}: {len(engine._graphs._graphs)} decode graph variants "
          f"captured in {time.perf_counter() - t0:.2f} s")


async def requests(engine, reqs):
    """Run ``reqs`` concurrently; returns (items per request, TTFT per
    request, wall seconds)."""
    from dynamo_tpu_torch.runtime.context import Context

    t0 = time.perf_counter()

    async def one(req):
        items, first = [], None
        async for item in engine.generate(req, Context()):
            if item["token_ids"] and first is None:
                first = time.perf_counter() - t0
            items.append(item)
        return items, first

    out = await asyncio.gather(*(one(r) for r in reqs))
    return [o[0] for o in out], [o[1] for o in out], time.perf_counter() - t0


def make_request(prompt, n=SERVE_TOKENS, **extra):
    """A request for ``n`` tokens, greedy unless ``extra`` sets sampling."""
    return {"token_ids": prompt, "sampling": {"temperature": 0.0},
            "stop_conditions": {"max_tokens": n, "ignore_eos": True}, **extra}


def chunked_check(engine, prompt, out) -> None:
    """The long prompt prefilled in chunks and streamed its 32 tokens,
    near-argmax under the reference forward."""
    (items, ttft, wall), counts, steps = out["res"], out["counts"], out["steps"]
    toks = [t for x in items[0] for t in x["token_ids"]]
    require(items[0][-1]["finish_reason"] == "length" and len(toks) == SERVE_TOKENS,
            f"chunked request: {len(toks)} tokens, finish {items[0][-1]['finish_reason']}")
    require(out["chunks"] == 2, f"chunked request ran {out['chunks']} prefill chunks")
    require(counts["fused_decode"] == engine.spec.num_layers * steps == out["replays"]
            * engine.spec.num_layers,
            f"chunked serve: fused_decode {counts['fused_decode']} over {steps} steps")
    agree, gap = near_argmax_check(engine.spec, engine.params, prompt, toks)
    print(f"serve chunked {engine.kv_dtype}: {len(prompt)}-token prompt in "
          f"{out['chunks']} prefill chunks of <= "
          f"{engine.config.max_prefill_chunk_tokens}, TTFT {1e3 * ttft[0]:.1f} ms, "
          f"{SERVE_TOKENS} tokens in {wall:.3f} s; reference exact greedy agreement "
          f"{agree:.3f}, worst gap {gap:.3f} (tol {NEAR_ARGMAX})")


def logprob_check(engine, prompt, out) -> None:
    """Two identical seeded temperature-0.8 requests with logprobs: equal
    streams, LOGPROBS ordered top entries per token, and every served
    logprob within LOGPROB_TOL of the reference forward's log-softmax."""
    from dynamo_tpu_torch.models import llama

    (items, ttft, wall), counts, steps = out["res"], out["counts"], out["steps"]
    streams = [[t for x in it for t in x["token_ids"]] for it in items]
    entries = [e for x in items[0] for e in x.get("logprobs") or ()]
    toks = streams[0]
    require(all(it[-1]["finish_reason"] == "length" for it in items)
            and len(toks) == SERVE_TOKENS, "logprob requests did not finish by length")
    require(streams[0] == streams[1], "identical seeded requests streamed different tokens")
    require(len(entries) == SERVE_TOKENS and all(len(e["top"]) == LOGPROBS for e in entries),
            f"logprob entries: {len(entries)} for {SERVE_TOKENS} tokens")
    require([e["id"] for e in entries] == toks, "logprob entry ids differ from the tokens")
    for e in entries:
        tops = [t["logprob"] for t in e["top"]]
        require(all(np.isfinite(tops)) and tops == sorted(tops, reverse=True)
                and e["logprob"] <= tops[0] + 1e-6 and tops[0] <= 0.0,
                f"bad logprob entry {e}")
    require(counts["fused_decode"] == engine.spec.num_layers * steps == out["replays"]
            * engine.spec.num_layers,
            f"logprob serve: fused_decode {counts['fused_decode']} over {steps} steps")
    seq = torch.tensor(prompt + toks[:-1], device=DEVICE)
    with torch.no_grad():
        ref = torch.log_softmax(
            llama.reference_forward(engine.spec, engine.params, seq)[len(prompt) - 1:], -1)
    ids = torch.tensor([[e["id"]] + [t["id"] for t in e["top"]] for e in entries],
                       device=DEVICE)
    got = torch.tensor([[e["logprob"]] + [t["logprob"] for t in e["top"]] for e in entries],
                       device=DEVICE)
    diff = (ref.gather(1, ids) - got).abs().max().item()
    off_argmax = sum(e["id"] != e["top"][0]["id"] for e in entries)
    require(diff <= LOGPROB_TOL, f"served logprobs {diff:.3f} from the reference")
    print(f"serve logprobs {engine.kv_dtype}: 2 x {SERVE_TOKENS} tokens (logprobs={LOGPROBS}, "
          f"temperature 0.8, seed) in {wall:.3f} s, streams equal, {off_argmax} of "
          f"{SERVE_TOKENS} tokens off the top entry; max |logprob - reference| {diff:.4f} "
          f"(tol {LOGPROB_TOL})")


def serve_check(engine, prompts, out, label, bf16_tokens=None):
    """Check a serve of ``prompts``: the streams, the prefix-cache hit, the
    launch counts (all in fp8 form for an fp8 engine) and one stream
    against the reference forward. Returns (launches, served tokens per
    request); with ``bf16_tokens`` also prints the share of tokens equal
    to them."""
    results, ttft, wall, hit = out["res"]
    serve_launches, steps, times = out["counts"], out["steps"], out["times"]
    spec = engine.spec
    fp8 = engine.kv_dtype == "fp8"
    tokens = {}
    for i, items in results.items():
        toks = [t for x in items for t in x["token_ids"]]
        require(items[-1]["finish_reason"] == "length" and len(toks) == SERVE_TOKENS,
                f"request {i}: {len(toks)} tokens, finish {items[-1]['finish_reason']}")
        require(all(0 <= t < spec.vocab_size for t in toks), f"request {i}: bad ids")
        tokens[i] = toks
    require(hit >= 256, f"second sharer's prefix-cache hit was {hit} tokens")
    require(serve_launches["fused_decode"] == spec.num_layers * steps,
            f"fused_decode launched {serve_launches['fused_decode']} times "
            f"over {steps} decode steps")
    require(serve_launches["fused_decode/fp8"] == (serve_launches["fused_decode"] if fp8 else 0),
            f"fused_decode launched {serve_launches['fused_decode/fp8']} times in fp8 form "
            f"on a {engine.kv_dtype} engine")
    require(serve_launches["kv_write"] == 0 and serve_launches["paged_attention_v3"] == 0,
            "the fused serving path launched the unfused kernels")
    require(out["replays"] == steps,
            f"{out['replays']} graph replays for {steps} decode steps")
    n_out = sum(len(v) for v in tokens.values())
    disp_ms = 1e3 * sum(times) / max(len(times), 1)
    print(f"serve {label}: {len(results)} requests, {n_out} tokens in {wall:.3f} s = "
          f"{n_out / wall:.1f} tok/s; TTFT mean "
          f"{1e3 * sum(ttft.values()) / len(ttft):.1f} ms, max "
          f"{1e3 * max(ttft.values()):.1f} ms; decode dispatch-to-host mean {disp_ms:.2f} ms "
          f"over {len(times)} dispatches of {steps} steps ({1e3 * wall / steps:.2f} ms of "
          f"wall per step); prefix-cache hit {hit} tokens; fused_decode launches "
          f"{serve_launches['fused_decode']} = {spec.num_layers} x {steps} "
          f"({serve_launches['fused_decode/fp8']} in fp8 form); graph replays "
          f"{out['replays']}; eager re-admissions {out['readmits']}; KV pools "
          f"{engine.pool_bytes} bytes ({engine.pool_bytes / 1e9:.3f} GB)")
    if bf16_tokens is not None:
        same = sum(a == b for i in tokens for a, b in zip(tokens[i], bf16_tokens[i]))
        print(f"serve {label}: {same / n_out:.4f} of the tokens equal to the "
              f"default bf16 serve's ({same} of {n_out})")
    longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    agree, gap = near_argmax_check(spec, engine.params, prompts[longest], tokens[longest])
    print(f"reference {label}: request {longest} exact greedy agreement "
          f"{agree:.3f}, worst gap to the reference max {gap:.3f} (tol {NEAR_ARGMAX})")
    return serve_launches, tokens


def new_engine(spec, cfg, label, params=None):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.core import InferenceEngine

    t0 = time.perf_counter()
    engine = InferenceEngine(spec, EngineConfig(**cfg), params=params, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.params.parameters())
    print(f"engine {label}: {spec.name} {n_params / 1e9:.2f}B params, KV pools "
          f"{engine.pool_bytes / 1e9:.3f} GB, {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
          f"allocated, init {time.perf_counter() - t0:.1f} s")
    precompile(engine, label)
    return engine


def drop_engine(engine):
    """Free an engine's pools, its graphs first (they point at the pools);
    returns its weights."""
    params = engine.params
    engine.release_graphs()
    engine.k_pages = engine.v_pages = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return params


# ------------------------------------------------------------ HTTP serving


async def http_call(port, method, path, body=None, raw=None, drop_after=None):
    """One HTTP/1.1 request on a connection of its own (stdlib only).
    Returns (status, body bytes, seconds from the send to each body chunk).
    A chunked (SSE) body is read chunk by chunk; with ``drop_after`` the
    client goes away after that many chunks."""
    data = raw if raw is not None else b"" if body is None else json.dumps(body).encode()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        t0 = time.perf_counter()
        writer.write(f"{method} {path} HTTP/1.1\r\nHost: localhost\r\nConnection: close\r\n"
                     f"Content-Type: application/json\r\nContent-Length: {len(data)}\r\n"
                     "\r\n".encode() + data)
        await writer.drain()
        lines = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1").split("\r\n")
        status = int(lines[0].split(" ")[1])
        headers = dict((k.strip().lower(), v.strip()) for k, _, v in
                       (ln.partition(":") for ln in lines[1:] if ln))
        if headers.get("transfer-encoding", "").lower() != "chunked":
            out = await reader.readexactly(int(headers.get("content-length", 0)))
            return status, out, [time.perf_counter() - t0]
        chunks, times = [], []
        while drop_after is None or len(chunks) < drop_after:
            size = int((await reader.readuntil(b"\r\n")).split(b";")[0], 16)
            if size == 0:
                break
            chunks.append(await reader.readexactly(size))
            await reader.readexactly(2)
            times.append(time.perf_counter() - t0)
        return status, b"".join(chunks), times
    finally:
        writer.close()


def sse_events(body: bytes) -> list:
    """The SSE payloads of a stream: parsed JSON, and the final "[DONE]"."""
    events = [e for e in body.decode().split("\n\n") if e]
    require(all(e.startswith("data: ") for e in events), f"bad SSE framing {body[:200]!r}")
    return [e[6:] if e == "data: [DONE]" else json.loads(e[6:]) for e in events]


async def admin_call(drt, payload):
    """The worker's first answer to ``payload`` on its admin endpoint."""
    from dynamo_tpu_torch.runtime.context import Context

    client = await drt.namespace("dynamo").component("backend").endpoint(
        "admin").client().start()
    try:
        (inst,) = await client.wait_for_instances(1, timeout=2)
        async for item in client.call_instance(inst.instance_id, payload, Context()):
            return item
    finally:
        await client.close()


def http_serve(spec, cfg, params, prompts, default_serve_out, default_tokens):
    """Phase 9: the one-process serving stack through the port's entry
    points (in-memory hub, launch_engine_worker with its decode graphs
    captured, ModelWatcher, HttpFrontend on port 0), all on one event loop,
    driven by a stdlib HTTP client: /v1/models and /health; the 8 prompts as
    concurrent streamed token-id completions (32 tokens, ignore_eos, usage);
    one chat completion through the chat template; one stream dropped after
    two chunks; one malformed body; the worker's pages all freed; /metrics.
    The same 8 requests through generate() on the same engine before and
    after the HTTP run (/clear_kv_blocks between) give the frontend's cost. Returns the
    phase's fused_decode launches."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.worker import launch_engine_worker
    from dynamo_tpu_torch.frontend.http import HttpFrontend
    from dynamo_tpu_torch.frontend.tokenizer import MockTokenizer
    from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub import InMemoryHub

    name, L = spec.name, spec.num_layers
    n = len(prompts)

    async def drive():
        drt = DistributedRuntime(InMemoryHub())
        t0 = time.perf_counter()
        engine, _ = await launch_engine_worker(
            drt, model=name, spec=spec, params=params, device=DEVICE, precompile=True,
            engine_config=EngineConfig(**cfg, pipeline_decode=True))
        print(f"http worker: {name} engine built, {len(engine._graphs._graphs)} decode "
              f"graph variants captured, registered in {time.perf_counter() - t0:.2f} s")
        watcher = await ModelWatcher(drt, ModelManager()).start()
        frontend = HttpFrontend(watcher.manager, host="127.0.0.1", port=0, drt=drt)
        try:
            await watcher.wait_for_model(name, timeout=30)
            _, port = await frontend.start()
            out = {"engine": engine}
            for path in ("/v1/models", "/health"):
                status, body, _ = await http_call(port, "GET", path)
                out[path] = (status, json.loads(body))
            async def clear():
                # evict the prompts' cached pages through the HTTP admin route
                status, body, _ = await http_call(port, "POST", "/clear_kv_blocks", {})
                t_clear = time.perf_counter()
                while engine.allocator.evictable_pages and time.perf_counter() - t_clear < 2:
                    await asyncio.sleep(0.01)
                return (status, json.loads(body)), engine.allocator.evictable_pages

            # the same requests through generate() on the same engine, before
            # and after the HTTP run (each on a cleared prefix cache)
            direct = [make_request(p) for p in prompts]
            out["direct"] = [await requests(engine, direct)]
            out["clear"] = [await clear()]
            before = (engine.steps, engine._graphs.replays)
            zero_counts()
            t_http = time.perf_counter()
            out["streams"] = await asyncio.gather(*(http_call(port, "POST", "/v1/completions", {
                "model": name, "prompt": p, "max_tokens": SERVE_TOKENS, "ignore_eos": True,
                "stream": True, "stream_options": {"include_usage": True}}) for p in prompts))
            out["wall"] = time.perf_counter() - t_http
            status, body, _ = await http_call(port, "POST", "/v1/chat/completions", {
                "model": name, "messages": [{"role": "user", "content": "Name three colours."}],
                "max_tokens": SERVE_TOKENS, "ignore_eos": True})
            out["chat"] = (status, json.loads(body))
            status, body, _ = await http_call(port, "POST", "/v1/completions", {
                "model": name, "prompt": prompts[3][:64], "max_tokens": 512,
                "ignore_eos": True, "stream": True}, drop_after=2)
            out["dropped"] = (status, sse_events(body))
            status, body, _ = await http_call(port, "POST", "/v1/chat/completions",
                                              raw=b"{not json")
            out["malformed"] = (status, json.loads(body))
            t_drop = time.perf_counter()
            status = await admin_call(drt, {"op": "cache_status"})
            while status["active_pages"] and time.perf_counter() - t_drop < 2:
                await asyncio.sleep(0.02)
                status = await admin_call(drt, {"op": "cache_status"})
            out["freed_s"] = time.perf_counter() - t_drop
            out["cache_status"] = status
            out["counts"] = read_counts()
            out["steps"] = engine.steps - before[0]
            out["replays"] = engine._graphs.replays - before[1]
            status, body, _ = await http_call(port, "GET", "/metrics")
            out["metrics"] = (status, body.decode())
            out["clear"].append(await clear())
            out["direct"].append(await requests(engine, direct))
        finally:
            await frontend.stop()
            await watcher.close()
            await engine.close()
            await drt.close()
        return out

    out = asyncio.run(drive())
    require(out["/v1/models"][0] == 200 and [m["id"] for m in out["/v1/models"][1]["data"]]
            == [name], f"/v1/models: {out['/v1/models']}")
    require(out["/health"] == (200, {"status": "healthy", "models": {name: {"instances": 1}}}),
            f"/health: {out['/health']}")
    require(all(c == ((200, {"results": {"dynamo/backend": {"workers_cleared": 1}}}), 0)
                for c in out["clear"]),
            f"/clear_kv_blocks: (answer, cached pages left) {out['clear']}")
    tok = MockTokenizer()
    ttft, texts = [], []
    for i, (status, body, times) in enumerate(out["streams"]):
        ev = sse_events(body) if status == 200 else []
        chunks = [e for e in ev[:-1] if e.get("choices")]
        usage = ev[-2].get("usage") if len(ev) >= 2 else None
        require(status == 200 and ev[-1] == "[DONE]" and chunks
                and chunks[-1]["choices"][0]["finish_reason"] == "length"
                and usage and usage["completion_tokens"] == SERVE_TOKENS
                and usage["prompt_tokens"] == len(prompts[i]),
                f"http stream {i}: status {status}, last events {ev[-3:]}")
        ttft.append(times[0])
        texts.append("".join(c["choices"][0]["text"] for c in chunks))
    status, chat = out["chat"]
    require(status == 200 and chat["choices"][0]["finish_reason"] == "length"
            and chat["usage"]["completion_tokens"] == SERVE_TOKENS,
            f"http chat: status {status}, {chat}")
    status, ev = out["dropped"]
    require(status == 200 and len(ev) == 2 and all(isinstance(e, dict) for e in ev),
            f"http dropped stream: status {status}, {ev}")
    require(out["malformed"] == (400, {"error": {
        "message": "invalid JSON body", "type": "invalid_request_error", "param": None,
        "code": None}}), f"http malformed body: {out['malformed']}")
    require(out["cache_status"]["ok"] and out["cache_status"]["active_pages"] == 0,
            f"pages still active {out['freed_s']:.2f} s after the dropped stream: "
            f"{out['cache_status']}")
    status, text = out["metrics"]
    reached = n + 2  # the streams, the chat completion, the dropped stream
    ttft_count = [float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                  if ln.startswith("dynamo_time_to_first_token_seconds_count{")]
    require(status == 200 and ttft_count == [reached],
            f"/metrics: TTFT count {ttft_count}, {reached} requests reached the engine")
    counts, steps = out["counts"], out["steps"]
    require(counts["fused_decode"] == L * steps and steps > 0 and out["replays"] == steps,
            f"http phase: fused_decode launched {counts['fused_decode']} times over "
            f"{steps} decode steps ({out['replays']} graph replays)")
    require(counts["kv_write"] == counts["paged_attention_v3"] == 0,
            "the HTTP serving path launched the unfused kernels")

    _, d_ttft, dd_wall, _ = default_serve_out["res"]
    n_tok = n * SERVE_TOKENS
    direct_tokens = [[t for x in it for t in x["token_ids"]] for it in out["direct"][0][0]]
    same = sum(texts[i] == tok.decode(direct_tokens[i]) for i in range(n))
    same_default = sum(texts[i] == tok.decode(default_tokens[i]) for i in range(n))
    wall = out["wall"]
    d_wall = sum(w for _, _, w in out["direct"]) / 2
    print(f"serve http bf16 pipelined: {n} concurrent streamed completions x "
          f"{SERVE_TOKENS} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s; client TTFT "
          f"mean {1e3 * sum(ttft) / n:.1f} ms, max {1e3 * max(ttft):.1f} ms; fused_decode "
          f"launches {counts['fused_decode']} = {L} x {steps} steps "
          f"(chat, dropped stream and the drain included), graph replays {out['replays']}")
    for when, (_, d_first, w) in zip(("before", "after"), out["direct"]):
        print(f"serve direct generate() on the same engine, {when} the HTTP run (8 at "
              f"once): {w:.3f} s = {n_tok / w:.1f} tok/s, TTFT mean "
              f"{1e3 * sum(d_first) / n:.1f} ms, max {1e3 * max(d_first):.1f} ms")
    print(f"serve http: frontend share of the wall against the mean of the two direct runs "
          f"{(wall - d_wall) / wall:.4f}; the default serve (phase 4a, non-pipelined, second "
          f"sharer late): {dd_wall:.3f} s = {n_tok / dd_wall:.1f} tok/s, TTFT mean "
          f"{1e3 * sum(d_ttft.values()) / n:.1f} ms, max {1e3 * max(d_ttft.values()):.1f} ms")
    print(f"serve http: completion texts equal to MockTokenizer.decode of the same engine's "
          f"direct tokens (before) {same}/{n}, of the default serve's {same_default}/{n}; chat "
          f"completion {chat['usage']}; dropped stream's pages freed "
          f"{1e3 * out['freed_s']:.0f} ms after the malformed body's 400; /metrics TTFT "
          f"count {int(ttft_count[0])}")
    drop_engine(out.pop("engine"))
    return counts["fused_decode"]


def cli_check(model: str, device: str | None = None) -> None:
    """Phase 10: ``python3 -m dynamo_tpu_torch.cli run --in http --out
    engine`` in a process of its own (random weights, graphs captured
    first) must print DYNAMO_HTTP=host:port and stream a chat completion
    of CLI_TOKENS tokens ending with data: [DONE]. The process is ended
    before this returns."""
    import queue
    import threading

    cmd = [sys.executable, "-m", "dynamo_tpu_torch.cli", "run", "--in", "http", "--out",
           "engine", "--model", model, "--port", "0", "--precompile"]
    if device:
        cmd += ["--device", device]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    try:
        seen, port = [], None
        while port is None:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                require(proc.poll() is None and time.perf_counter() - t0 < CLI_START_S,
                        f"cli: no DYNAMO_HTTP= (exit code {proc.poll()}): {seen[-10:]}")
                continue
            seen.append(line)
            if line.startswith("DYNAMO_HTTP="):
                port = int(line.strip().rsplit(":", 1)[1])
        t_ready = time.perf_counter() - t0
        status, body, times = asyncio.run(http_call(port, "POST", "/v1/chat/completions", {
            "model": model, "messages": [{"role": "user", "content": "Hello there"}],
            "max_tokens": CLI_TOKENS, "ignore_eos": True, "stream": True,
            "stream_options": {"include_usage": True}}))
        ev = sse_events(body) if status == 200 else []
        chunks = [e for e in ev[:-1] if e.get("choices")]
        usage = ev[-2].get("usage") if len(ev) >= 2 else None
        require(status == 200 and ev[-1] == "[DONE]" and chunks
                and chunks[-1]["choices"][0]["finish_reason"] == "length"
                and usage and usage["completion_tokens"] == CLI_TOKENS,
                f"cli: status {status}, last events {ev[-3:]}")
        print(f"cli: {' '.join(cmd[1:])}: DYNAMO_HTTP after {t_ready:.1f} s; a streamed chat "
              f"completion of {CLI_TOKENS} tokens in {times[-1]:.3f} s ({len(chunks)} "
              f"chunks, client TTFT {1e3 * times[0]:.1f} ms), usage {usage}")
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "dynamo_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout holding dynamo_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dynamo_tpu_torch.engine.config import ModelSpec
    from dynamo_tpu_torch.ops.cuda import build

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    kernels = check_kernels(flush)
    kernels.update(check_kernels_fp8(flush))
    del flush
    graph_check()
    graph_check(fp8=True)

    spec = ModelSpec.llama3_8b()
    cfg = dict(page_size=16, num_pages=2048, max_pages_per_seq=64, max_decode_slots=8)
    prompts = make_prompts(spec.vocab_size)
    rng = np.random.default_rng(99)
    long_prompt = rng.integers(3, spec.vocab_size, CHUNKED_PROMPT).tolist()
    lp_req = make_request(prompts[2], sampling={"temperature": 0.8, "seed": 2024},
                            output_options={"logprobs": LOGPROBS})

    async def default_serve(engine):
        return await serve(engine, prompts)

    engine = new_engine(spec, dict(cfg, kv_dtype="bf16"), "bf16")
    out = serve_phases(engine, [
        ("default", default_serve),
        ("chunked", lambda e: requests(e, [make_request(long_prompt)])),
        ("logprobs", lambda e: requests(e, [lp_req, lp_req])),
    ])
    serve_launches, bf16_tokens = serve_check(engine, prompts, out["default"], "bf16")
    default_out = out["default"]
    chunked_check(engine, long_prompt, out["chunked"])
    logprob_check(engine, prompts[2], out["logprobs"])
    step_graph_check(engine, prompts)
    step_graph_check(engine, prompts, unfused=True)
    unfused = unfused_check(engine, prompts)
    params = drop_engine(engine)
    del engine

    # the same weights, pipelined decode (bursts of 4, two in flight)
    engine = new_engine(spec, dict(cfg, kv_dtype="bf16", pipeline_decode=True,
                                   pipeline_depth=2, decode_steps_per_dispatch=4),
                        "bf16 pipelined", params=params)
    out = serve_phases(engine, [("pipelined", default_serve)])
    serve_check(engine, prompts, out["pipelined"], "bf16 pipelined", bf16_tokens=bf16_tokens)
    drop_engine(engine)
    del engine

    # the same weights behind an fp8 KV cache
    engine = new_engine(spec, dict(cfg, kv_dtype="fp8"), "fp8", params=params)
    out = serve_phases(engine, [("default", default_serve)])
    serve_fp8, _ = serve_check(engine, prompts, out["default"], "fp8", bf16_tokens=bf16_tokens)
    step_graph_check(engine, prompts)
    unfused_fp8 = unfused_check(engine, prompts)
    drop_engine(engine)
    del engine

    # the same weights served over HTTP by the one-process stack
    http_launches = http_serve(spec, dict(cfg, kv_dtype="bf16"), params, prompts,
                               default_out, bf16_tokens)
    del params
    torch.cuda.empty_cache()
    # the same stack from the command line, in a process of its own
    cli_check(spec.name)

    launches = {"fused_decode": serve_launches["fused_decode"] + http_launches,
                "paged_attention_v3": unfused[0], "kv_write": unfused[2],
                "fused_decode/fp8": serve_fp8["fused_decode/fp8"],
                "paged_attention_v3/fp8": unfused_fp8[1]}
    sources = {
        "fused_decode": ("dynamo_tpu_torch/csrc/fused_decode.cu",
                         "dynamo_tpu/ops/pallas/fused_decode.py:58"),
        "paged_attention_v3": ("dynamo_tpu_torch/csrc/paged_attention_v3.cu",
                               "dynamo_tpu/ops/pallas/paged_attention_v3.py:76"),
        "kv_write": ("dynamo_tpu_torch/csrc/kv_write.cu",
                     "dynamo_tpu/ops/pallas/kv_write.py:39"),
        # the kernels' quantized branches: in-register dequant, and (fused)
        # the requantizing read-modify-write of the destination page
        "fused_decode/fp8": ("dynamo_tpu_torch/csrc/fused_decode.cu",
                             "dynamo_tpu/ops/pallas/fused_decode.py:275"),
        "paged_attention_v3/fp8": ("dynamo_tpu_torch/csrc/paged_attention_v3.cu",
                                   "dynamo_tpu/ops/pallas/paged_attention_v3.py:197"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"],
         **{k: r[k] for k in ("long_ms", "long_plain_ms", "long_library_ms",
                              "long_bound_ms") if k in r}}
        for name, r in kernels.items()
    ]}
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
