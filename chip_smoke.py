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
   append (ops/quant.py) outside page 0; kv_write's fp8 form (the
   requantizing append) on the same three cases, values and scales bitwise
   equal to kv_write_plain outside page 0, timed (row "kv_write/fp8", no
   library call computes it); times and bounds as in phase 3,
   SDPA over the dequantized context as the library call; one fp8 fused
   call in a CUDA graph; a second engine with kv_dtype="fp8" on the bf16
   engine's weights (its pools freed first) serves the same 8 requests
   (32 fp8 fused launches per decode step, the prefix hit, one stream
   near-argmax under the reference); phase 5's step graphs on the fp8
   pools, fused and unfused (values and scales bitwise); phase 6 on the
   fp8 pools, where paged_attention_v3 and kv_write each launch 32 times
   in their fp8 forms, with the unfused eager step's host wall beside the
   same step with kv_write's plain version (the parent's route);
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
   share of completion texts equal to the decoded direct tokens. Then the
   serving features on the same engine, each request alone on a cleared
   prefix cache (FEATURE_TOKENS tokens, greedy): at the serve's shortest
   and longest prompt lengths, a chat completion and the same messages
   through /v1/responses non-streamed (text and output_tokens equal to the
   chat completion's) and streamed (response.created, then only
   response.output_text.delta events with the response's item id, then
   response.completed; the deltas join to the chat text, the usage's
   output_tokens equal); the engine registered again under a card with
   the hermes tool-call and deepseek_r1 reasoning parsers, and a chat
   completion with tools through it, aggregated and streamed: random
   weights write no markers, so reasoning_content plus content equal the
   plain card's content, with no tool_calls, the same finish_reason and
   usage; guided decoding: a json_schema chat (GUIDED_SCHEMA) on the plain
   card must end "stop" with content that parses and conforms, and a
   forced tool_choice chat through a card with the hermes parser alone
   must come back as one tool_calls entry naming the forced function with
   arguments of its enum; 32 fused_decode launches per step; the parsers'
   host time per chunk of a scripted stream printed;
10. CLI: ``python3 -m dynamo_tpu_torch.cli run --in http --out engine
   --model llama-3-8b --port 0 --precompile`` in a process of its own
   prints DYNAMO_HTTP=host:port and streams a 16-token chat completion;
11. processes: with every engine of phases 1-10 freed (the card's free
   memory printed, room for two workers required), ``cli hub``, two
   ``cli worker --model llama-3-8b --precompile`` on the phase-1 config
   (the same seeded weights) started together, and ``cli frontend``, each
   a fresh interpreter talking TCP: /v1/models and two generate instances
   in the hub; the 8 prompts as concurrent streamed token-id completions
   through the frontend (each ends with data: [DONE], "length" and 32
   completion tokens; both workers serve) and through the hub-discovered
   TCP data plane from this process (their token ids near-argmax under the
   reference forward, drawn here once the workers are gone; the frontend
   streams' texts must equal their decoded tokens); one guided completion
   (nvext.guided_regex GUIDED_REGEX) through the frontend, which must end
   "stop" with text the pattern matches (the worker built its vocabulary
   and the grammar crossed the wire); one more stream whose
   worker is SIGTERM'd after its 5th chunk (the stream finishes, the
   worker had it in flight, exits 0 after printing ENGINE_DRAINED
   leftover=0, its instance key leaves the hub, and the survivor serves
   the next completion); the 8 prompts once more through the frontend, all
   on the survivor. The workers register router mode "kv" (the default), so
   the frontend routes every set through its KvRouter; the first set, with
   no prefix to reuse, must not put all 8 on one worker. The frontend set
   to both workers runs twice (before and after the TCP set). Before the
   drain, the prefix-family set, from this process through its own
   KvPushRouter and KvRouter over the TCP hub, on cleared caches: 4
   families of a 384-token prefix (24 pages) with a head and a follower of
   64 distinct tokens more, greedy, 32 tokens; the 4 heads concurrently,
   then (within 5 s) the router's radix must hold each head's prompt
   hashes, computed here with compute_sequence_hashes(prompt, 16), under
   the worker that served it (xxh3 end to end: engine, event, router) and
   both workers' published load must be idle; then the 4 followers
   concurrently, each routed to its head's worker with
   estimated_prefix_hit_num_blocks 24, one of them near-argmax under the
   reference forward; a cache clear must then empty the radix for both
   workers within 5 s (their removed events). Printed, not gated: pick
   time by phase, event lag, host hash costs (xxh3 beside blake2b),
   follower against head TTFT, and the same waves through a round-robin
   PushRouter with the followers in a seeded shuffled order. The workers
   run with --health-port 0 --health-interval 1 and the hermes /
   deepseek_r1 parsers; after the prefix-family set, the health set:
   /ready 200 on both status servers; each worker's canary latency (the
   health manager's canary, from here); the admin faults op arms
   health.canary:corrupt scoped to worker A, which must be quarantined
   within 3 canary periods (its card flagged in the hub, reason="sdc" on
   its /metrics, /ready 503); the next 4 completions through the frontend
   must all go to B; clearing the spec must readmit A within 3 canary
   periods (readmission takes 3 clean canaries; a period is the interval
   plus the slowest measured canary; 0.25 s of slack for the hub's put
   and the poll). Each set of 8 is timed on cleared prefix caches and
   printed beside phase 9's. Then the survivor, the frontend and the hub
   SIGTERM'd, each exiting 0 within its deadline. The workers
   log their kernel launches since ENGINE_READY: fused_decode must launch
   32 times per logged step, and their sum joins the kernels line.
12. speculative decoding (run after phase 8 and before phase 9, so its
   engines are freed before the workers of phase 11 spawn): (a) kv_write at
   a verify's shape, 72 rows (8 sequences x 9, starting 3, 7 and 15 tokens
   into a page, siblings on shared pages, 2 padded rows on page 0), bitwise
   equal to its plain version outside page 0 and timed as in phase 3 beside
   it and one index_put_ per pool (its row "kv_write/verify" in the kernels
   line); the same on fp8 pools (row "kv_write/fp8-verify"), each row
   with its own amax (scales grow between siblings) and the pages that the
   start-15 runs cross into holding a stale scale; SPEC_REQUESTS greedy
   requests whose prompts repeat a seeded SPEC_SEGMENT-token segment up to
   64..512 tokens, SPEC_TOKENS tokens each
   (the last SPEC_SHORT), through an engine with spec_mode="ngram"
   (spec_k_max 8, pipelined, decode graphs and the verify grid captured by
   precompile) and one with spec off, each freed before the next is built;
   (b) on the first spec engine, before it serves: the verify captured per
   row count (1, 2, 4, 8) against an eager verify_forward on copies of the
   same pools (targets identical, pools bitwise equal outside page 0,
   kv_write 32 launches per replay, in its fp8 form on fp8 pools), the
   device span of an 8-row verify replay against a B=8 decode graph step
   (and, on fp8 pools, against the bf16 verify), one traced replay; (c) on the
   phase-4 random weights: every stream near-argmax under the reference
   forward and equal to spec-off's up to its first position whose reference
   top-2 gap is under NEAR_ARGMAX, kv_write launched 32 times per verify
   dispatch; (d) on peaked weights (the same layer tensors; the input
   embedding scaled by the smallest of SPEC_SCALES that gives a reference
   top-2 gap over NEAR_ARGMAX; an untied head whose column for a token is
   the embedding row of the token it follows in its segment, so the greedy
   stream continues the segment): streams equal spec-off's token for
   token, acceptance >= 0.9, >= 4 tokens per verify row, the short request
   ends "length" after exactly SPEC_SHORT tokens, free plus cached pages
   back to the start, and with engine.spec_verify armed through FAULTS the
   same requests again: every verify faults, every slot falls back to
   bursts, streams unchanged; (e) (d) on fp8 pools, (b) on fp8 pools first:
   streams equal spec-off's, kv_write launched 32 times per verify
   dispatch, all in its fp8 form. Prints verifies,
   drafts, acceptance, tokens per verify dispatch and row, tok/s on and
   off, and the host wall per verify dispatch.
13. overload (run after phase 12 and before phase 9, on the phase-4
   weights): (a) slot pressure, on a pipelined engine (depth 2, bursts of
   4, phase 4's config) with preemption on, then on one with it off: the 8
   prompts of phase 4 as batch-class requests of tenant "bt"
   (OVERLOAD_BATCH_TOKENS tokens, ignore_eos); once every one holds a slot
   with its first token, OVERLOAD_INTERACTIVE interactive requests
   (seeded prompts of 64..128 tokens, OVERLOAD_INTERACTIVE_TOKENS tokens)
   OVERLOAD_GAP_S apart. Gates: every stream ends "length" with its count;
   at least one interactive_admission preemption with preemption on, none
   off; interactive TTFT lower on than off (means); every batch stream
   near-argmax under the reference forward and equal to its preemption-off
   run up to its first reference near-tie; interactive streams
   near-argmax; 0 active pages after; fused_decode once per layer and
   step. Prints interactive TTFT mean and max both ways, batch tok/s,
   preemptions by reason and admission_rejects. (b) page pressure: a
   pipelined engine with an OVERLOAD_PAGES-page pool, which two batch
   streams of OVERLOAD_PAGE_PROMPT + OVERLOAD_PAGE_TOKENS tokens exhaust;
   then one interactive request, which must complete near-argmax through
   an interactive_pages preemption; both batch streams end "length", 0
   active pages after. (c) quota: on that engine, tenant "q" with
   OVERLOAD_QUOTA: its second request must raise OverQuota with a positive
   Retry-After, counted in admission_rejects.
14. guided decoding (run after phase 13 and before phase 9, on the phase-4
   weights, with the mock tokenizer's vocabulary at 128256 ids): the
   grammars' char DFAs checked finite (the bounded ones' longest sentence
   under GUIDED_TOKENS); (a) masked step graphs on pools of their own
   after a prefill of the 8 prompts, 4 rows under the masks of distinct
   states of the GUIDED_SCHEMA grammar and 4 all-True, a greedy replay and
   a sampled-with-20-logprobs replay (rows 2, 3, 6, 7 at temperature 0.8)
   of DecodeGraphs' masked variant against eager decode_steps(allowed=...)
   on copies of the same pools: records bitwise equal, every masked row's
   token allowed, the all-True rows' records bitwise equal to the unmasked
   graph's, pools bitwise equal outside page 0, 32 fused_decode launches
   per replay; the same on fp8 pools, and one greedy unfused bf16 replay
   (32 launches each of paged_attention_v3 and kv_write); (b) one
   pipelined engine (phase 7's bursts of 4, depth 2) with the vocabulary,
   its unmasked then masked decode variants captured (seconds and graph
   memory of each printed), serves the 8 prompts at once, GUIDED_TOKENS
   tokens each, even ones greedy and odd ones seeded at temperature 0.8:
   2 json_schema, 2 json_object, 2 regex, 2 free. Gates: no violation
   counted; every guided stream walks its grammar's DFA; the json_schema
   and regex requests end "stop", conformant, their texts parsing and
   conforming or matching; a conformant json_object parses; the ok count
   equals the conformant finishes; the greedy guided streams near-argmax
   under the reference forward masked by their cursors; the free streams
   near the reference (the greedy one's argmax, the sampled one's seeded
   Gumbel draw) and equal to the same requests served all free on the
   same engine (cleared cache) up to their first reference near-tie;
   every dispatch while a guided slot is live is one masked step with no
   burst in flight; 0 active pages; 32 fused_decode launches per step;
   (c) guided x spec: VerifyGraphs' masked capture per row count against
   an eager verify_forward(allowed=...) on copies of pools of its own
   (targets identical and allowed, pools bitwise equal outside page 0, 32
   kv_write launches per replay), then the greedy guided requests of (b)
   and one of GUIDED_REPEAT through an engine with spec_mode "ngram"
   (spec_k_max 8) and one with spec off: at least one masked verify
   dispatch, kv_write 32 times per verify dispatch, every stream
   near-argmax under the masked reference, spec on equal to off up to the
   first masked reference near-tie. Prints, not gated: the vocabulary
   build, compile ms, one new state's mask ms (the O(V) walk), mask staging
   bytes and device ms per dispatch ([8, V] decode, [8, 9, V] verify), host
   wall of a masked against an unmasked graph step, dispatch-to-host ms of
   masked single steps against the free pipelined bursts, tok/s mixed
   against all-free, and the spec cell's walls.

15. MoE and checkpoints (run last, once every llama engine is freed): (a)
   gpt-oss-120b at full width (d 2880, 64/8 heads, D 64, 128 experts
   top-4, vocab 201088, YaRN, sinks, window 128 on its sliding layers) cut
   to MOE_LAYERS layers (two sliding, two full; ~28 GB of bf16 weights,
   random from seed 0, the input embedding scaled by MOE_EMBED_SCALE),
   decode graphs captured first: the 8 default prompts, 32 greedy tokens
   each, with phase 4's checks (4 fused_decode launches per step, every
   request "length", the prefix hit), moe_dropped_slots printed; a
   MOE_PROMPT-token prompt served alone, whose prefill must drop 0 slots,
   near-argmax under reference_forward at capacity T (drop-free: what the
   engine's drop-free run computed); phase 5's step graphs on this engine
   (greedy and sampled with logprobs, bitwise); the graph step's split into
   experts (moe_mlp per layer, CUDA events), attention and the rest, and
   the experts one step's routing touches; (c) fused_decode at gpt-oss's
   shape (KH 8, G 8, D 64, window 128 + sinks) checked, timed beside its
   plain version and SDPA with the same mask and sinks (row
   "fused_decode/gpt-oss", its launches those of (a)'s serves); (b)
   llama-3-8b at full width, CKPT_LAYERS layers, written by save_params
   under build/checkpoints/ and read back by load_model_dir: weights and one
   prefill's logits bitwise equal; CKPT_REQUESTS greedy requests through an
   in-process engine on the loaded weights and through `cli run
   --model-path` over HTTP, texts equal (the head zeroed outside printable
   ASCII ids, so each token has its character); write and load seconds and
   GB/s printed.
16. MLA (after phase 15, once phase 15's engines and checkpoint are freed): (a)
   deepseek-r1 at full width (d 7168, 128 heads, q-LoRA 1536, kv-LoRA 512,
   rope 64, v 128, 256 experts top-8 in 8 groups with 4 taken, 1 shared
   expert, vocab 129280, YaRN x40) cut from 61 to MLA_LAYERS layers with
   first_k_dense 3 kept (three dense layers, one MoE layer; ~30.2 GB of
   bf16 weights, random from seed 0, the input embedding scaled by
   MOE_EMBED_SCALE), on a bf16 latent pool and then an fp8 one (one scale
   per row) on the same weights, decode graphs captured first: the 8
   default prompts, 32 greedy tokens each, with phase 4's checks (every
   request "length", the prefix hit) and no kernel launched (MLA's path
   has none: DYNAMO_FUSED_DECODE does not apply); a MLA_PROMPT-token
   prompt served alone, a whole prefill bucket, near-argmax under
   mla.reference_forward with the prompt's rows routed as the prefill
   routed them (its dropped slots, counted by wrapping moe.moe_mlp, equal
   to the reference's) and each served token's row drop-free, as decode's;
   phase 5's step graphs (greedy and sampled with logprobs, bitwise,
   values and scales on fp8) and phase 12's verify graphs (1, 2, 4, 8 rows
   x 9 against eager verify_forward, targets and pools bitwise; the span
   of an 8-row replay against a decode step); (b) on bf16, a B=8 step's parts per layer
   with CUDA events (absorbed attention, experts with the shared expert,
   dense MLPs, the head) against the traced graph step's busy time, and
   the experts one step's routing touches; the latent pools' bytes, bf16
   against fp8; (c) the latent attention of one layer, plain (what decode
   runs) against one scaled_dot_product_attention call on the same
   inputs, at B=8 over SEQ_LENS and B=1 x LONG_SEQ_LEN, beside its byte
   bound; (d) deepseek-r1 at full width, MLA_CKPT_LAYERS layer (dense,
   ~4.9 GB), written by save_params under build/checkpoints/ and read back
   by load_model_dir: weights and one prefill's logits bitwise equal,
   write and load GB/s printed. Phase 16 adds ~25 s of command time.

17. text (after 16): a llama-3-format tokenizer written by this script
   (llama-3's Split pattern and ByteLevel, its 256 specials at 128000..,
   its chat template and clean-up flag, 128,000 base entries: the 256 byte
   symbols and 127,744 merges grown by a fixed rule from TEXT_CORPUS, then
   systematic pairs, trigrams and four-letter strings) beside llama-3-8b at
   full width, CKPT_LAYERS layers (seeded weights whose dim 0 is a constant
   the head reads as a bias: every token holding "{" except "{}" at
   TEXT_BRACE_BIAS, so a json_object answer closes). Host costs, each
   beside the card line: HFTokenizer load, encode and decode us per token
   (and IncrementalDecoder pushes), apply_chat_template ms,
   TokenVocab.from_tokenizer at 128,256 ids, a json_schema compile and one
   new state's mask, and the tokenizers library's encode as a yardstick
   where it is installed. Then TEXT_CHATS (English, code, multilingual,
   JSON-ish) served one at a time by an in-process engine with the config
   ``cli run --spec ngram`` builds, and streamed by ``cli run --in http
   --model-path DIR --spec ngram --precompile``: prompt_tokens equal to the
   tokenizer's count of the rendered prompt, texts equal to the in-process
   streams pushed through IncrementalDecoder, a json_object chat that ends
   "stop" and parses, and (from the process's ENGINE_LAUNCHES line at
   SIGTERM) verify dispatches and kv_write launches; then ``cli run
   --guided off`` serves a free chat on fused_decode and refuses the
   json_object chat. The mock tokenizer's prompt counts are printed beside
   the BPE ones.

Phases run in the order 1-8, 12, 13, 14, 9, 10, 11, 15, 16, 17.

Prints, before the last line, the card line and one JSON object with every
kernel's measurements; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import re
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
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
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
FEATURE_TOKENS = 16  # each request of phase 9's serving-feature set
CLI_START_S = 180  # the CLI process's limit to print DYNAMO_HTTP=
REPS = 20
SLEEP_CYCLES = 5_000_000  # ~2.5 ms of device time at the H100's clock
# phase 11's prefix-family set: FAMILIES shared prefixes of FAMILY_PREFIX
# tokens (24 pages of 16), each with a head and a follower of FAMILY_TAIL
# distinct tokens more
FAMILIES = 4
FAMILY_PREFIX = 384
FAMILY_TAIL = 64
FAMILY_SEED = 4242
EVENT_DEADLINE_S = 5.0  # head blocks into the router's radix; cleared caches out
# phase 12 (speculative decoding): SPEC_REQUESTS greedy requests whose
# prompts repeat a seeded SPEC_SEGMENT-token segment up to 64..512 tokens,
# SPEC_TOKENS tokens each (the last SPEC_SHORT: not a multiple of the
# verify width SPEC_W = spec_k_max + 1)
SPEC_W = 9
SPEC_REQUESTS = 8
SPEC_SEGMENT = 12
SPEC_SEED = 909
SPEC_TOKENS = 64
SPEC_SHORT = 50
SPEC_SCALES = (1.0, 4.0, 16.0, 64.0, 256.0)  # input-embedding scales tried, smallest first
# phase 13 (overload): the 8 prompts of phase 4 as batch-class requests of
# OVERLOAD_BATCH_TOKENS tokens (tenant "bt"), then OVERLOAD_INTERACTIVE
# interactive requests of OVERLOAD_INTERACTIVE_TOKENS, OVERLOAD_GAP_S apart;
# the page-pressure cell's pool holds OVERLOAD_PAGES pages, which two batch
# streams of OVERLOAD_PAGE_PROMPT + OVERLOAD_PAGE_TOKENS tokens exhaust
OVERLOAD_BATCH_TOKENS = 192
OVERLOAD_INTERACTIVE = 4
OVERLOAD_INTERACTIVE_TOKENS = 32
OVERLOAD_GAP_S = 0.05
OVERLOAD_SEED = 1313
OVERLOAD_PAGES = 100
OVERLOAD_PAGE_PROMPT = 768
OVERLOAD_PAGE_TOKENS = 200
OVERLOAD_QUOTA = "q:rate=10,burst=60"  # the quota cell's tenant
# phase 14 (guided decoding): GUIDED_TOKENS tokens per request; the bounded
# schema (an enum and a maxLength string, both required), a sentence of it
# whose prefixes give the masked rows' distinct grammar states, the
# fixed-shape regex, and a repeating regex (its greedy output repeats, so
# prompt-lookup drafts exist for guided x spec); seeds GUIDED_SEED + i
GUIDED_TOKENS = 128
GUIDED_SEED = 1414
GUIDED_SCHEMA = {"type": "object",
                 "properties": {"color": {"enum": ["red", "green", "blue"]},
                                "name": {"type": "string", "maxLength": 8}},
                 "required": ["color", "name"]}
GUIDED_SAMPLE_TEXT = '{"color": "red", "name": "ab"}'
GUIDED_REGEX = "[0-9]{3}-[a-z]{4}"
GUIDED_REPEAT = "(ab|cd){4,40}"
# phase 9's forced tool call: a tool whose one argument is an enum (the
# hermes grammar's longest sentence is 122 tokens)
GUIDED_TOOL = {"type": "function", "function": {
    "name": "get_weather", "parameters": {
        "type": "object", "properties": {"city": {"enum": ["Paris", "Oslo"]}},
        "required": ["city"]}}}
GUIDED_TOOL_TOKENS = 160
# phase 15 (MoE and checkpoints): gpt-oss-120b at full width cut to
# MOE_LAYERS layers (the preset's alternation: two sliding, two full), its
# drop-free prompt MOE_PROMPT tokens (a whole prefill bucket: no padding
# rows), its attention window MOE_WINDOW; llama-3-8b cut to CKPT_LAYERS
# layers for the checkpoint round trip, CKPT_REQUESTS greedy requests of
# CKPT_TOKENS tokens served one at a time, the head's columns outside the
# mock tokenizer's printable ASCII ids (CKPT_IDS) zeroed so every served
# token has its own character in the HTTP text
MOE_LAYERS = 4
MOE_PROMPT = 128
# gpt-oss's input embedding scaled by this after the random init: at the
# init's 0.02 the residual stream is the attention's running average over
# the causal prefix, the same for neighbouring tokens, so routing piles onto
# a few experts (a 128-token prompt dropped 61 slots at C = 16); scaled, each
# token's own embedding dominates, as in a trained model's routing
MOE_EMBED_SCALE = 64.0
MOE_WINDOW = 128
MOE_SEED = 1515
# phase 16 (MLA): deepseek-r1 at full width cut to MLA_LAYERS layers (its
# first_k_dense of 3 kept: three dense layers and one MoE layer), its input
# embedding scaled by MOE_EMBED_SCALE for phase 15's routing reason; a
# MLA_PROMPT-token prompt served alone; a MLA_CKPT_LAYERS-layer checkpoint
MLA_LAYERS = 4
MLA_PROMPT = 128
MLA_SEED = 1616
MLA_CKPT_LAYERS = 1
CKPT_LAYERS = 2
CKPT_REQUESTS = 4
CKPT_TOKENS = 16
CKPT_IDS = (16 + 32, 16 + 127)


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


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
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
    if a.ndim < 2:  # the MLA family's empty v_pages placeholder
        return torch.equal(a, b)
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


def sdpa_call(t, layer, window: int = 0, sinks=None):
    """One scaled_dot_product_attention call over the gathered context
    (the library yardstick; the port never calls it). Gather, fp8 dequant
    (to q's dtype) and GQA expansion are set-up, outside the timed call.
    A window masks keys at or before seq_len - 1 - window; sinks join as
    one more key with zero K and V whose logit is the sink (a float mask
    adds it), so the softmax's denominator gains exp(sink) as the
    kernels'."""
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
    sl = t["sl"].long()[:, None]
    mask = (pos < sl)[:, None, None, :]
    if window:
        mask = mask & (pos > sl - 1 - window)[:, None, None, :]
    if sinks is not None:
        k = torch.cat([k, k.new_zeros(B, H, 1, D)], dim=2)
        v = torch.cat([v, v.new_zeros(B, H, 1, D)], dim=2)
        bias = torch.where(mask, 0.0, float("-inf")).to(q.dtype)
        sink = sinks.to(q.dtype)[None, :, None, None].expand(B, H, 1, 1)
        mask = torch.cat([bias.expand(B, H, 1, S), sink], dim=-1)
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
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {lib}, bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
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


def fp8_append_bound(dst_page: torch.Tensor, KH: int, page: int, D: int,
                     el: int = 2) -> tuple[float, str]:
    """Least time of kv_write's fp8 form on these rows: each touched
    (page, KV head) run of K and of V read and written once with its bf16
    scale, the rows on live pages read, every index read (bytes); one f32
    multiply or divide per run value and step on the CUDA cores
    (operations). Rows on trash page 0 are skipped."""
    pg = dst_page.cpu().numpy()
    live = pg[pg != 0]
    runs = 2 * len(set(live.tolist())) * KH
    nbytes = runs * 2 * (page * D + 2) + 2 * live.size * KH * D * el + 2 * pg.size * 4
    return bound_ms(nbytes, 2 * live.size * KH * page * D, F32_FLOPS)


def check_kv_write_fp8(t, case: str, layer: int = 1) -> None:
    """kv_write's fp8 form on ``t``'s pools and rows against kv_write_plain
    (rounds of quant_append_rows): values and scales bitwise equal outside
    page 0."""
    from dynamo_tpu_torch.ops.cuda import kv_write

    args = (t["k_new"], t["v_new"], t["dst_page"], t["dst_off"])
    got = [clone_pool(t[k]) for k in ("k_pages", "v_pages")]
    want = [clone_pool(t[k]) for k in ("k_pages", "v_pages")]
    kv_write.kv_write(*got, *args, layer=layer)
    kv_write.kv_write_plain(*want, *args, layer=layer)
    torch.cuda.synchronize()
    require(all(pools_equal(g, w) for g, w in zip(got, want)),
            f"kv_write fp8 {case}: pools differ from kv_write_plain")
    print(f"check {case}: kv_write fp8 form bitwise equal to kv_write_plain "
          "(values and scales) outside page 0")


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
        check_kv_write_fp8(t, f"fp8/{dtype_name}", layer)
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
            check_kv_write_fp8(tc, f"fp8/{dtype_name}/{case}", layer)
            del tc
    times = time_attention(flush, fp8=True)
    for name in ("fused_decode", "paged_attention_v3"):
        results[name + "/fp8"].update(times[name])
    results["kv_write/fp8"] = time_kv_write_fp8(flush, layer)
    print_times(results)
    return results


def time_kv_write_fp8(flush, layer: int) -> dict:
    """kv_write's fp8 form and its plain version at the serving shapes
    (bf16 rows, 8 rows with scale growth, one per sequence)."""
    from dynamo_tpu_torch.ops.cuda import kv_write

    t = fp8_case_inputs(torch.bfloat16, "scale-growth", 40, layer)
    kp, vp = t["k_pages"], t["v_pages"]
    args = (t["k_new"], t["v_new"], t["dst_page"], t["dst_off"])
    res = {"max_abs_err": 0.0, "library_ms": None}
    res["ms"] = time_ms(lambda: kv_write.kv_write(kp, vp, *args, layer=layer), flush)
    res["plain_ms"] = time_ms(lambda: kv_write.kv_write_plain(kp, vp, *args, layer=layer),
                              flush)
    KH, page, D = kp.shape[2], kp.shape[3], kp.shape[4]
    res["bound_ms"], res["bound_by"] = fp8_append_bound(t["dst_page"], KH, page, D)
    return res


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


def model_module(spec):
    """The spec's family module: models/llama.py, or models/mla.py for an
    MLA spec."""
    from dynamo_tpu_torch.models.family import get_family

    return get_family(spec).m


def near_argmax_check(spec, params, prompt, tokens) -> tuple[float, float]:
    """Teacher-forced unpaged reference forward (the spec family's) over
    prompt + served tokens: each served token's reference logit must lie
    within NEAR_ARGMAX of the reference maximum. Returns (exact agreement,
    worst gap)."""
    seq = torch.tensor(prompt + tokens[:-1], device=DEVICE)
    with torch.no_grad():
        logits = model_module(spec).reference_forward(spec, params, seq)[len(prompt) - 1:]
    served = torch.tensor(tokens, device=DEVICE)
    top = logits.max(dim=-1).values
    picked = logits.gather(1, served[:, None])[:, 0]
    gap = (top - picked).max().item()
    agree = (logits.argmax(dim=-1) == served).float().mean().item()
    require(torch.isfinite(logits).all().item(), "reference logits non-finite")
    require(gap <= NEAR_ARGMAX, f"served token {gap:.3f} below the reference max")
    return agree, gap


def profile_decode_step(step, form: str) -> dict | None:
    """One traced decode step (B=8, fused path) or verify replay: wall
    time, device-busy time (sum of kernel self times, kernels replayed from
    a CUDA graph included), idle share, the fused kernel's device time and
    the top kernels. Returns {"wall_ms", "busy_ms", "attn_ms"} (None when
    the trace holds no device kernels)."""
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
        return None
    fused = (f", fused_decode {sum(dev_us(e) for e in attn) / 1e3:.3f} ms over "
             f"{sum(e.count for e in attn)} launches" if attn else "")
    print(f"profile {form}: wall {wall * 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms, idle share {max(0.0, 1 - busy / 1e6 / wall):.3f}"
          f"{fused}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        print(f"  {dev_us(e) / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return {"wall_ms": wall * 1e3, "busy_ms": busy / 1e3,
            "attn_ms": sum(dev_us(e) for e in attn) / 1e3}


def prefill_slots(engine, prompts, room: int = 1):
    """Prefill ``prompts`` into fresh pages of the engine's pools (one
    packed prefill, beside the engine); returns host arrays: block tables
    [B, P] with page room for ``room`` decode tokens, the first tokens
    (argmax) [B] and seq_lens [B] counting them, int32."""
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
        logits, _ = engine.fam.prefill_batch(
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


def step_graph_check(engine, prompts, unfused: bool = False) -> dict | None:
    """The engine's one-step function captured in a CUDA graph
    (engine/graphs.DecodeGraphs) against eager decode_steps, on copies of
    the same pools after a prefill of ``prompts``: a GRAPH_STEPS burst in
    the greedy variant and in the sampled variant with logprobs (half the
    rows at temperature 0.8, with top-k / top-p on some). Tokens and
    logprobs must be identical and the pools bitwise equal outside page 0;
    each replay must run one attention launch per layer (unfused: v3 and
    kv_write each; an MLA engine none: its path has no kernel). Then,
    fused, the host wall of one B=8 step of each variant, eager against
    graph, and one traced greedy graph step, whose reading
    (profile_decode_step's) it returns."""
    from dynamo_tpu_torch.engine.graphs import DecodeGraphs

    spec, cfg, fam = engine.spec, engine.config, engine.fam
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
    want_counts = ({} if spec.is_mla
                   else {"paged_attention_v3": L * n, "kv_write": L * n} if unfused
                   else {"fused_decode": L * n})
    traced = None
    try:
        for sampled, lp_width in ((False, 0), (True, n_lp)):
            inp = dict(inputs, temperature=inputs["temperature"] * sampled)
            eager_pools = (clone_pool(engine.k_pages), clone_pool(engine.v_pages))
            graph_pools = (clone_pool(engine.k_pages), clone_pool(engine.v_pages))
            with torch.no_grad():
                want = fam.decode_steps(
                    spec, engine.params, *(torch.from_numpy(inp[k]) for k in
                                           ("tokens", "block_tables", "seq_lens")),
                    *eager_pools, torch.from_numpy(inp["active"]),
                    *(torch.from_numpy(inp[k]) for k in ("temperature", "top_k", "top_p")),
                    torch.from_numpy(inp["seeds"].astype(np.int64)),
                    torch.from_numpy(inp["steps"]), n_steps=n, n_logprobs=lp_width)
            want = [x.cpu().numpy() for x in (want if lp_width else (want,))]

            def step(t, s, k, pools=graph_pools):
                fam.decode_step(spec, engine.params, *pools, t, sampled=s, n_logprobs=k)

            runner = DecodeGraphs(step, batch=B, pages_per_seq=cfg.max_pages_per_seq,
                                  max_steps=n, n_logprobs=n_lp, device=torch.device(DEVICE))
            with torch.no_grad():
                runner.precompile([(sampled, lp_width, False)])
                zero_counts()
                got = runner.dispatch(inp, n, sampled=sampled, n_logprobs=lp_width).result()
            counts = {k: v for k, v in read_counts().items() if v}
            variant = f"{'sampled' if sampled else 'greedy'}, n_logprobs {lp_width}"
            fp8_counts = ({k + "/fp8": v for k, v in want_counts.items()}
                          if engine.kv_dtype == "fp8" else {})
            require(counts == {**want_counts, **fp8_counts},
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
                        out = fam.decode_steps(
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
                    traced = profile_decode_step(graph_step,
                                                 f"{engine.kv_dtype} graph step")
            runner.release()
            del eager_pools, graph_pools, runner
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("DYNAMO_FUSED_DECODE", None)
    return traced


def unfused_check(engine, prompts):
    """One decode step through the fused kernel and through the unfused
    pair on the same pool state. Each path reads only the context below
    the new token plus its own new row, so the second run sees the same
    state as the first. With fp8 pools the unfused pair is kv_write's fp8
    form (the quantized append) and paged_attention_v3's fp8 form, which
    reads the new row back at fp8; then the unfused eager step's host wall
    with the kernel and with kv_write's plain version in its place (the
    route of the reference's XLA path). Returns the unfused run's launches
    (v3, v3 in fp8 form, kv_write, kv_write in fp8 form)."""
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
            zero_counts()
            out[mode] = llama.decode_forward(
                spec, engine.params, nxt, bts_d, seq_lens, engine.k_pages,
                engine.v_pages, active)
            torch.cuda.synchronize()
            out[mode + "_launches"] = [fused_fn.launches, fused_fn.fp8_launches,
                                       v3_fn.launches, v3_fn.fp8_launches,
                                       kv_write.kv_write.launches,
                                       kv_write.kv_write.fp8_launches]
        if fp8:

            def step():
                return llama.decode_forward(spec, engine.params, nxt, bts_d, seq_lens,
                                            engine.k_pages, engine.v_pages, active).cpu()

            kernel_ms = host_ms(step)
            real = kv_write.kv_write
            kv_write.kv_write = kv_write.kv_write_plain
            try:
                plain_ms = host_ms(step)
            finally:
                kv_write.kv_write = real
            print(f"unfused fp8 eager step B={B}: host wall {kernel_ms:.2f} ms with "
                  f"kv_write's fp8 form, {plain_ms:.2f} ms with its plain version "
                  f"(quant_append_rows) ({plain_ms / kernel_ms:.2f}x)")
        os.environ.pop("DYNAMO_FUSED_DECODE")
    L = spec.num_layers
    f8 = L if fp8 else 0
    require(out["1_launches"] == [L, f8, 0, 0, 0, 0],
            f"fused path launches (fused, fp8, v3, fp8, kv_write, fp8) {out['1_launches']}")
    want = [0, 0, L, f8, L, f8]
    require(out["0_launches"] == want,
            f"unfused path launches (fused, fp8, v3, fp8, kv_write, fp8) "
            f"{out['0_launches']}")
    tol = LOGIT_REL_TOL_FP8 if fp8 else LOGIT_REL_TOL
    ref, alt = out["1"], out["0"]
    rel = ((alt - ref).abs().max() / ref.abs().max()).item()
    agree = (alt.argmax(-1) == ref.argmax(-1)).float().mean().item()
    require(torch.isfinite(alt).all().item(), "unfused logits non-finite")
    require(rel <= tol, f"unfused {engine.kv_dtype} logits differ: rel {rel:.3e}")
    print(f"unfused {engine.kv_dtype}: logits max|diff|/max|logit| = {rel:.3e} (tol {tol}), "
          f"argmax agreement {agree:.3f}, launches (fused, fused fp8, v3, v3 fp8, "
          f"kv_write, kv_write fp8) {out['1_launches']} then {out['0_launches']}")
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
            "kv_write": kv_write.kv_write.launches,
            "kv_write/fp8": kv_write.kv_write.fp8_launches}


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
    verify = (f" and {len(engine._verify._graphs)} verify graphs (rows "
              f"{engine._verify.row_counts} x {engine._verify.width})"
              if engine._verify is not None else "")
    print(f"precompile {label}: {len(engine._graphs._graphs)} decode graph variants"
          f"{verify} captured in {time.perf_counter() - t0:.2f} s")


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


def serve_check(engine, prompts, out, label, bf16_tokens=None, reference=True):
    """Check a serve of ``prompts``: the streams, the prefix-cache hit, the
    launch counts (all in fp8 form for an fp8 engine) and, with
    ``reference``, one stream against the reference forward. Returns
    (launches, served tokens per request); with ``bf16_tokens`` also
    prints the share of tokens equal to them."""
    results, ttft, wall, hit = out["res"]
    serve_launches, steps, times = out["counts"], out["steps"], out["times"]
    spec = engine.spec
    fp8 = engine.kv_dtype == "fp8"
    # fused_decode launches per decode step: one per layer, none on MLA's
    # path (no kernel there; DYNAMO_FUSED_DECODE does not apply)
    per_step = 0 if spec.is_mla else spec.num_layers
    tokens = {}
    for i, items in results.items():
        toks = [t for x in items for t in x["token_ids"]]
        require(items[-1]["finish_reason"] == "length" and len(toks) == SERVE_TOKENS,
                f"request {i}: {len(toks)} tokens, finish {items[-1]['finish_reason']}")
        require(all(0 <= t < spec.vocab_size for t in toks), f"request {i}: bad ids")
        tokens[i] = toks
    require(hit >= 256, f"second sharer's prefix-cache hit was {hit} tokens")
    require(serve_launches["fused_decode"] == per_step * steps,
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
          f"{serve_launches['fused_decode']} = {per_step} x {steps} "
          f"({serve_launches['fused_decode/fp8']} in fp8 form); graph replays "
          f"{out['replays']}; eager re-admissions {out['readmits']}; KV pools "
          f"{engine.pool_bytes} bytes ({engine.pool_bytes / 1e9:.3f} GB)")
    if bf16_tokens is not None:
        same = sum(a == b for i in tokens for a, b in zip(tokens[i], bf16_tokens[i]))
        print(f"serve {label}: {same / n_out:.4f} of the tokens equal to the "
              f"default bf16 serve's ({same} of {n_out})")
    if reference:
        longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
        agree, gap = near_argmax_check(spec, engine.params, prompts[longest],
                                       tokens[longest])
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
    """Free an engine's pools, its graphs first (they point at the pools),
    and let go of its weights, which it returns: the engine sits in a
    reference cycle (its graphs hold its bound step function), so the
    caller's ``del`` alone would keep them until the next collection."""
    import gc

    params, engine.params = engine.params, None
    engine.release_graphs()
    engine.k_pages = engine.v_pages = None
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return params


# ------------------------------------------------------ speculative decoding


def check_kv_write_verify(flush, fp8: bool = False) -> dict:
    """kv_write at a verify's shape: 8 sequences x SPEC_W rows (72),
    starting 3, 7 and 15 tokens into a page, siblings on shared pages, the
    last 2 rows padded onto trash page 0; llama-3-8b's KH 8, D 128; bf16
    rows. On fp8 pools each row carries its own amax (0.3x to 10x a
    normal draw, so scales grow between siblings) and the pages the
    start-15 runs cross into at offset 0 hold STALE_SCALE. Bitwise equal to
    the plain version outside page 0 (fp8: values and scales); timed as
    phase 3 with its plain version and (bf16) one index_put_ per pool."""
    from dynamo_tpu_torch.ops.cuda import kv_write
    from dynamo_tpu_torch.ops.cuda.sweep import fp8_pool

    KH, D, page, B, W, P = 8, 128, 16, 8, SPEC_W, 8
    N = B * W
    rng = np.random.default_rng(21)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(21)
    NP = 1 + B * P
    pools = [torch.randn((2, NP, KH, page, D), generator=gen, device=DEVICE)
             .to(torch.bfloat16) for _ in range(2)]
    rows = [torch.randn((N, KH, D), generator=gen, device=DEVICE).to(torch.bfloat16)
            for _ in range(2)]
    dst_page = np.zeros((N,), np.int32)
    dst_off = np.zeros((N,), np.int32)
    for i in range(B):
        pages = 1 + i * P + rng.permutation(P)
        start = (3, 7, 15)[i % 3] + page * int(rng.integers(0, 4))
        for w in range(W):
            pos = start + w
            dst_page[i * W + w] = pages[pos // page]
            dst_off[i * W + w] = pos % page
    dst_page[-2:] = 0  # padded rows
    dp = torch.from_numpy(dst_page).to(DEVICE)
    do = torch.from_numpy(dst_off).to(DEVICE)
    shared = N - 2 - len(set(dst_page[:-2].tolist()))
    layer = 1
    fresh = sorted({int(p) for p, o in zip(dst_page, dst_off) if p and not o})
    if fp8:
        pools = [fp8_pool(p, gen) for p in pools]
        amp = 0.3 + 9.7 * torch.rand((N, 1, 1), generator=gen, device=DEVICE)
        rows = [(r.float() * amp).to(torch.bfloat16) for r in rows]
        for p in pools:
            p.scale[layer, fresh] = STALE_SCALE
    got = [clone_pool(p) for p in pools]
    want = [clone_pool(p) for p in pools]
    kv_write.kv_write(*got, *rows, dp, do, layer=layer)
    kv_write.kv_write_plain(*want, *rows, dp, do, layer=layer)
    torch.cuda.synchronize()
    if fp8:
        old_pages = sorted(set(dst_page[dst_page > 0].tolist()) - set(fresh))
        grown = int((got[0].scale[layer, old_pages] > pools[0].scale[layer, old_pages])
                    .sum())
    form = "fp8" if fp8 else "bf16"
    require(all(pools_equal(g, w) for g, w in zip(got, want)),
            f"kv_write {form} at the verify shape: not bitwise equal to the plain version")
    res = {"max_abs_err": 0.0}
    kp, vp = pools
    res["ms"] = time_ms(lambda: kv_write.kv_write(kp, vp, *rows, dp, do, layer=layer),
                        flush)
    res["plain_ms"] = time_ms(lambda: kv_write.kv_write_plain(
        kp, vp, *rows, dp, do, layer=layer), flush)
    if fp8:
        res["library_ms"] = None
        res["bound_ms"], res["bound_by"] = fp8_append_bound(dp, KH, page, D)
        extra = (f"; {len(fresh)} runs cross into a page at offset 0 over a stale "
                 f"scale of {STALE_SCALE}; {grown} of {len(old_pages) * KH} K scales of "
                 "the other touched pages grew")
    else:
        idx = (dp.long()[:, None], torch.arange(KH, device=DEVICE)[None], do.long()[:, None])

        def library_put():  # one index_put_ per pool
            kp[layer].index_put_(idx, rows[0])
            vp[layer].index_put_(idx, rows[1])

        res["library_ms"] = time_ms(library_put, flush)
        res["bound_ms"], res["bound_by"] = bound_ms(4 * N * KH * D * 2 + 2 * N * 4, 0.0)
        extra = ""
    lib = "none" if res["library_ms"] is None else f"{res['library_ms']:.4f}"
    print(f"check kv_write {form} verify shape: {N} rows ({B} x {SPEC_W}, starts 3/7/15 "
          f"into a page, {shared} rows on a page an earlier row also writes, 2 padded "
          f"rows on page 0{extra}) bitwise equal to the plain version outside page 0; "
          f"{res['ms']:.4f} ms (plain {res['plain_ms']:.4f}, library {lib}), bound "
          f"{res['bound_ms']:.6f} ms by {res['bound_by']}")
    return res


def spec_prompts(vocab: int):
    """SPEC_REQUESTS prompts, each a seeded 12-token segment repeated up to
    64..512 tokens; the segments' 96 tokens are distinct."""
    rng = np.random.default_rng(SPEC_SEED)
    toks = rng.choice(np.arange(3, vocab), size=SPEC_REQUESTS * SPEC_SEGMENT,
                      replace=False).tolist()
    lens = rng.integers(64, 513, size=SPEC_REQUESTS)
    segs = [toks[i * SPEC_SEGMENT:(i + 1) * SPEC_SEGMENT] for i in range(SPEC_REQUESTS)]
    return segs, [(s * (int(n) // SPEC_SEGMENT + 1))[: int(n)] for s, n in zip(segs, lens)]


def verify_graph_check(engine, prompts, bf16_verify_ms=None) -> float:
    """The engine's verify captured per row count (VerifyGraphs) against an
    eager verify_forward on copies of the same pools, after a prefill of
    ``prompts``: each row is the first token plus the next segment tokens,
    rows of 1..SPEC_W tokens at mid-page starts. Targets identical, pools
    bitwise equal outside page 0 (fp8 values and scales), kv_write 32
    launches per replay (in its fp8 form on fp8 pools; none on an MLA
    engine, whose latent rows are plain stores). Then the device
    span of a verify replay of 8 rows against a decode graph step of 8
    slots (and against ``bf16_verify_ms``, a bf16 verify's span, when
    given), and the host wall of an eager verify. Returns the span."""
    from dynamo_tpu_torch.engine.graphs import VerifyGraphs, verify_row_counts

    spec, cfg, fam = engine.spec, engine.config, engine.fam
    B, W, fp8 = len(prompts), cfg.spec_k_max + 1, engine.kv_dtype == "fp8"
    L = 0 if spec.is_mla else spec.num_layers  # kv_write launches per verify
    bts, first, seq_lens = prefill_slots(engine, prompts, room=W)
    tokens = np.zeros((B, W), np.int32)
    nts = np.asarray([W, W - 2, 1, W, 5, W, 3, W][:B], np.int32)
    for i, p in enumerate(prompts):
        tokens[i, 0] = first[i]
        tokens[i, 1:] = [p[(len(p) + j) % SPEC_SEGMENT] for j in range(W - 1)]
        tokens[i, nts[i]:] = 0
    starts = (seq_lens - 1).astype(np.int32)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    base = (clone_pool(engine.k_pages), clone_pool(engine.v_pages))
    eager = (clone_pool(engine.k_pages), clone_pool(engine.v_pages))
    graph = (clone_pool(engine.k_pages), clone_pool(engine.v_pages))
    runner = VerifyGraphs(
        lambda t, b, s, n: fam.verify(spec, engine.params, t, b, s, *graph, n),
        batch=B, width=W, pages_per_seq=cfg.max_pages_per_seq, device=torch.device(DEVICE))
    form = engine.kv_dtype
    try:
        with torch.no_grad():
            runner.precompile()
            for n in verify_row_counts(B):
                for pools in (eager, graph):
                    for dst, src in zip(pools, base):
                        copy_pool_(dst, src)
                want = fam.verify(spec, engine.params, dev(tokens[:n]),
                                            dev(bts[:n]), dev(starts[:n]), *eager,
                                            dev(nts[:n]))[0].cpu().numpy()
                zero_counts()
                got = runner.dispatch(tokens[:n], bts[:n], starts[:n], nts[:n]).wait().numpy()
                counts = read_counts()
                pools_ok = all(pools_equal(a, b) for a, b in zip(graph, eager))
                print(f"verify graph {form} ({n} rows x {W}): replay vs eager verify_forward: "
                      f"targets {'identical' if np.array_equal(got, want) else 'DIFFER'}, pools "
                      f"{'bitwise equal' if pools_ok else 'DIFFER'}; kv_write launches "
                      f"{counts['kv_write']} ({counts['kv_write/fp8']} in fp8 form)")
                require(np.array_equal(got, want) and pools_ok,
                        f"verify graph {form} ({n} rows) differs from eager verify_forward")
                require(counts["kv_write"] == L and counts["kv_write/fp8"] == (L if fp8 else 0),
                        f"verify graph {form}: kv_write launched {counts['kv_write']} times "
                        f"({counts['kv_write/fp8']} fp8) in one replay")
            # device spans: verify replay (8 rows) vs a decode graph step (8 slots)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

            def span(fn, reps=5):
                fn()
                total = 0.0
                for _ in range(reps):
                    torch.cuda.synchronize()
                    start.record()
                    out = fn()
                    end.record()
                    out.wait() if hasattr(out, "wait") else out.result()
                    total += start.elapsed_time(end)
                return total / reps

            v_ms = span(lambda: runner.dispatch(tokens, bts, starts, nts))
            inputs = {"tokens": first, "block_tables": bts, "seq_lens": seq_lens,
                      "active": np.ones(B, bool), "temperature": np.zeros(B, np.float32),
                      "top_k": np.zeros(B, np.int32), "top_p": np.ones(B, np.float32),
                      "seeds": np.zeros(B, np.uint32), "steps": np.zeros(B, np.int32)}
            d_ms = span(lambda: engine._graphs.dispatch(inputs, 1, sampled=False,
                                                       n_logprobs=0))
            e_ms = host_ms(lambda: fam.verify(
                spec, engine.params, dev(tokens), dev(bts), dev(starts), *eager,
                dev(nts))[0].cpu(), reps=5)
            profile_decode_step(lambda: runner.dispatch(tokens, bts, starts, nts).wait(),
                                f"{form} verify replay ({B} x {W})")
        vs_bf16 = (f", {v_ms / bf16_verify_ms:.2f}x the bf16 verify's "
                   f"{bf16_verify_ms:.3f} ms" if bf16_verify_ms else "")
        print(f"verify {form}: device span of a {B} x {W} verify replay {v_ms:.3f} ms vs a "
              f"B={B} decode graph step {d_ms:.3f} ms ({v_ms / d_ms:.2f}x){vs_bf16}; eager "
              f"verify_forward host wall {e_ms:.2f} ms ({e_ms / v_ms:.1f}x the replay)")
        return v_ms
    finally:
        runner.release()
        engine.allocator.release([int(p) for p in bts.reshape(-1) if p])
        del base, eager, graph, runner
        torch.cuda.empty_cache()


def peaked_params(spec, params, segs):
    """Weights whose greedy stream continues each prompt's segment: the
    layer tensors of ``params`` shared, the input embedding scaled, and a
    head whose column for token u is the embedding row of the token that
    u follows in its segment (every other token maps to itself). With the
    residual stream dominated by the input token, the argmax after token t
    is the next token of t's segment. Picks the smallest scale in
    SPEC_SCALES at which every position of one prompt's reference forward
    has its argmax on the segment and a top-2 gap over NEAR_ARGMAX."""
    from dynamo_tpu_torch.models import llama

    require(not spec.tie_embeddings, f"{spec.name}: the peaked head needs an untied head")
    succ = torch.arange(spec.vocab_size, device=DEVICE)
    for seg in segs:
        for a, b in zip(seg, seg[1:] + seg[:1]):
            succ[b] = a  # head column of b: the row of the token b follows
    head = params.embed[succ].T.contiguous()
    layers = [{n: t for n, t in lp.named_parameters()} for lp in params.layers]
    prompt = (segs[0] * 8)[: 4 * SPEC_SEGMENT + 5]
    seq = torch.tensor(prompt, device=DEVICE)
    want = torch.tensor(prompt[1:] + [segs[0][len(prompt) % SPEC_SEGMENT]], device=DEVICE)
    for scale in SPEC_SCALES:
        p = llama.LlamaParams(params.embed * scale, params.final_norm, layers, head)
        with torch.no_grad():
            logits = llama.reference_forward(spec, p, seq)
        top2 = logits.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).min().item()
        if torch.equal(logits.argmax(-1), want) and gap > NEAR_ARGMAX:
            print(f"spec peaked weights: input embedding x {scale}, head = embedding rows "
                  f"permuted along the {len(segs)} segments; worst reference top-2 gap "
                  f"{gap:.3f} over {len(prompt)} positions")
            return p
        del p
    raise SmokeError("no scale in SPEC_SCALES makes the stream follow the segments")


def spec_reqs(prompts, n=SPEC_TOKENS):
    reqs = [make_request(p, n) for p in prompts]
    reqs[-1] = make_request(prompts[-1], SPEC_SHORT)  # not a multiple of SPEC_W
    return reqs


def spec_streams(out, reqs) -> list[list[int]]:
    items, _ttft, _wall = out["res"]
    streams = []
    for i, (it, req) in enumerate(zip(items, reqs)):
        toks = [t for x in it for t in x["token_ids"]]
        n = req["stop_conditions"]["max_tokens"]
        require(it[-1]["finish_reason"] == "length" and len(toks) == n,
                f"spec request {i}: {len(toks)} tokens of {n}, finish "
                f"{it[-1]['finish_reason']}")
        streams.append(toks)
    return streams


def spec_serve(spec, cfg, params, prompts, label, extra=(), graph_check=False,
               bf16_verify_ms=None):
    """Serve ``prompts`` on an engine with spec ngram and on one with spec
    off (the first freed before the second is built), both precompiled;
    ``extra`` phases run on the spec engine after the main serve, and with
    ``graph_check`` the verify graph check runs on it first. Returns
    {"ngram": phase outputs, "off": ..., "snap": spec counters after the
    serve, "verify_ms": host ms per verify dispatch, "free": (free pages at
    the start, free + evictable at the end), and with ``graph_check``
    "verify_span": an 8-row verify replay's device span in ms}."""
    reqs = spec_reqs(prompts)
    res = {}
    for mode in ("ngram", "off"):
        engine = new_engine(spec, dict(cfg, spec_mode=mode), f"{label} spec {mode}",
                            params=params)
        free0 = engine.allocator.free_pages
        marks = {}

        async def serve_spec(e):
            out = await requests(e, reqs)
            marks.update(snap=dict(e.spec_snapshot(), rows=e.spec_rows),
                         verify=list(e.verify_times),
                         free=(free0, e.allocator.free_pages + e.allocator.evictable_pages))
            return out

        phases = [("serve", serve_spec)] + (list(extra) if mode == "ngram" else [])
        if mode == "ngram" and graph_check:
            res["verify_span"] = verify_graph_check(engine, prompts, bf16_verify_ms)
        res[mode] = serve_phases(engine, phases)
        if mode == "ngram":
            res.update(snap=marks["snap"], free=marks["free"],
                       verify_ms=1e3 * sum(marks["verify"]) / max(len(marks["verify"]), 1))
        drop_engine(engine)
        del engine
    return res


def spec_report(res, reqs, label, L) -> dict:
    """Print one spec cell's counters and rates (the decode bursts of
    either engine must launch fused_decode once per layer and step);
    returns its numbers."""
    snap = res["snap"]
    on, off = res["ngram"]["serve"], res["off"]["serve"]
    for mode, out in (("on", on), ("off", off)):
        require(out["counts"]["fused_decode"] == L * out["steps"] == L * out["replays"],
                f"spec {label} {mode}: fused_decode {out['counts']['fused_decode']} over "
                f"{out['steps']} decode steps")
    n_tok = sum(r["stop_conditions"]["max_tokens"] for r in reqs)
    tps = {m: n_tok / res[m]["serve"]["res"][2] for m in ("ngram", "off")}
    # tokens a verify lands: the accepted drafts plus one per row
    per_dispatch = (snap["accepted"] + snap["rows"]) / max(snap["verifies"], 1)
    per_row = (snap["accepted"] + snap["rows"]) / max(snap["rows"], 1)
    print(f"spec {label}: verifies {snap['verifies']} of {snap['rows']} rows, drafted "
          f"{snap['drafted']}, accepted {snap['accepted']}, acceptance "
          f"{snap['acceptance_rate']}, tokens per verify dispatch {per_dispatch:.2f} "
          f"({per_row:.2f} per row), decode steps {on['steps']}; "
          f"{tps['ngram']:.1f} tok/s on vs {tps['off']:.1f} off "
          f"({tps['ngram'] / tps['off']:.2f}x); host wall per verify dispatch "
          f"{res['verify_ms']:.2f} ms; launches on: kv_write {on['counts']['kv_write']} "
          f"({on['counts']['kv_write/fp8']} in fp8 form), fused_decode "
          f"{on['counts']['fused_decode']}; off: fused_decode {off['counts']['fused_decode']}")
    return {"per_dispatch": per_dispatch, "per_row": per_row, "tps": tps, "snap": snap,
            "kv_write": on["counts"]["kv_write"], "kv_write/fp8": on["counts"]["kv_write/fp8"]}


def equal_to_first_near_tie(spec, params, prompt, got, want) -> tuple[int, int]:
    """Two greedy streams of ``prompt`` served different ways: both
    near-argmax under the reference forward; returns (the first position
    where they differ, the first position of ``got`` whose reference top-2
    gap is under NEAR_ARGMAX), each len(got) when there is none. The
    streams may only part at or after a near-tie."""
    from dynamo_tpu_torch.models import llama

    near_argmax_check(spec, params, prompt, got)
    near_argmax_check(spec, params, prompt, want)
    seq = torch.tensor(prompt + got[:-1], device=DEVICE)
    with torch.no_grad():
        top2 = llama.reference_forward(spec, params, seq)[len(prompt) - 1:].topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    tie = int(np.argmax(gaps < NEAR_ARGMAX)) if (gaps < NEAR_ARGMAX).any() else len(gaps)
    same = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), len(got))
    return same, tie


def spec_phase(spec, cfg, params, flush) -> tuple[dict, dict, int, int]:
    """Phase 12: speculative decoding. Returns (kv_write's verify-shape
    measurements on bf16 and on fp8 pools, its launches on the bf16 and on
    the fp8 spec path)."""
    from dynamo_tpu_torch.runtime.faults import FAULTS

    L = spec.num_layers
    kv_res = check_kv_write_verify(flush)
    kv_res_fp8 = check_kv_write_verify(flush, fp8=True)
    segs, prompts = spec_prompts(spec.vocab_size)
    reqs = spec_reqs(prompts)
    scfg = dict(cfg, pipeline_decode=True, spec_k_max=SPEC_W - 1)

    # (b) + (c): the phase-4 random weights
    res = spec_serve(spec, dict(scfg, kv_dtype="bf16"), params, prompts, "random",
                     graph_check=True)
    random_span = res["verify_span"]
    c = spec_report(res, reqs, "random weights bf16", L)
    require(c["kv_write"] == L * c["snap"]["verifies"] > 0,
            f"spec random: kv_write {c['kv_write']} launches for "
            f"{c['snap']['verifies']} verify dispatches")
    on = spec_streams(res["ngram"]["serve"], reqs)
    off = spec_streams(res["off"]["serve"], reqs)
    agree = []
    for i, p in enumerate(prompts):
        same, tie = equal_to_first_near_tie(spec, params, p, on[i], off[i])
        require(same >= tie, f"spec random request {i}: spec on and off part at token "
                             f"{same}, before the first reference near-tie at {tie}")
        agree.append((same, tie))
    print(f"spec random: streams near-argmax under the reference; spec on = off up to "
          f"(first difference, first near-tie) {agree}")

    # (d): peaked weights, the layers of (c) shared
    pparams = peaked_params(spec, params, segs)

    async def fault_serve(e):
        v0 = e.spec_verifies
        FAULTS.configure("engine.spec_verify:error@1.0", seed=5)
        try:
            out = await requests(e, reqs)
        finally:
            trips = FAULTS.snapshot()["trips"].get("engine.spec_verify:error", 0)
            FAULTS.configure("")
        return out, e.spec_verifies - v0, trips

    res = spec_serve(spec, dict(scfg, kv_dtype="bf16"), pparams, prompts, "peaked",
                     extra=[("fault", fault_serve)])
    d = spec_report(res, reqs, "peaked weights bf16", L)
    on = spec_streams(res["ngram"]["serve"], reqs)
    off = spec_streams(res["off"]["serve"], reqs)
    require(on == off, "spec peaked: streams differ between spec on and off")
    require(d["snap"]["acceptance_rate"] is not None and d["snap"]["acceptance_rate"] >= 0.9,
            f"spec peaked: acceptance {d['snap']['acceptance_rate']} < 0.9")
    require(d["per_row"] >= 4, f"spec peaked: {d['per_row']:.2f} tokens per verify "
                                "row < 4")
    require(d["kv_write"] == L * d["snap"]["verifies"],
            f"spec peaked: kv_write {d['kv_write']} for {d['snap']['verifies']} verifies")
    free0, free1 = res["free"]
    require(free1 == free0, f"spec peaked: {free1} free + cached pages after, {free0} before")
    f_out, f_verifies, trips = res["ngram"]["fault"]["res"]
    fault_streams = spec_streams({"res": f_out}, reqs)
    require(fault_streams == off and f_verifies == 0 and trips >= 1,
            f"spec peaked fault: streams {'equal' if fault_streams == off else 'DIFFER'}, "
            f"{f_verifies} verifies, {trips} trips")
    print(f"spec peaked: streams equal spec off; request {len(reqs) - 1} ended 'length' "
          f"after exactly {SPEC_SHORT} tokens; free + cached pages {free1} = {free0} at "
          f"the start; engine.spec_verify fault ({trips} trips): every slot fell back to "
          f"bursts, 0 verifies, streams unchanged")

    # (e): (d) on fp8 pools, with the verify graph check on fp8 pools first
    res = spec_serve(spec, dict(scfg, kv_dtype="fp8"), pparams, prompts, "peaked fp8",
                     graph_check=True, bf16_verify_ms=random_span)
    e = spec_report(res, reqs, "peaked weights fp8", L)
    on = spec_streams(res["ngram"]["serve"], reqs)
    off = spec_streams(res["off"]["serve"], reqs)
    require(on == off, "spec peaked fp8: streams differ between spec on and off")
    require(e["kv_write"] == e["kv_write/fp8"] == L * e["snap"]["verifies"] > 0,
            f"spec fp8: kv_write {e['kv_write']} launches ({e['kv_write/fp8']} fp8) for "
            f"{e['snap']['verifies']} verify dispatches")
    print(f"spec peaked fp8: acceptance {e['snap']['acceptance_rate']}; streams equal spec "
          f"off; {e['tps']['ngram']:.1f} tok/s on vs {e['tps']['off']:.1f} off "
          f"({e['tps']['ngram'] / e['tps']['off']:.2f}x; bf16 peaked "
          f"{d['tps']['ngram'] / d['tps']['off']:.2f}x); verify replay "
          f"{res['verify_span']:.3f} ms vs bf16 {random_span:.3f} ms")
    del pparams
    torch.cuda.empty_cache()
    return kv_res, kv_res_fp8, c["kv_write"] + d["kv_write"], e["kv_write/fp8"]


# ------------------------------------------------------------ overload


def overload_prompts(vocab: int):
    rng = np.random.default_rng(OVERLOAD_SEED)
    inter = [rng.integers(3, vocab, int(n)).tolist()
             for n in rng.integers(64, 129, OVERLOAD_INTERACTIVE)]
    pages = [rng.integers(3, vocab, OVERLOAD_PAGE_PROMPT).tolist() for _ in range(2)]
    return inter, pages


async def tenant_stream(engine, req, tenant, priority, t0):
    """One request under ``tenant`` / ``priority`` headers: (items, seconds
    from its submit to its first token, seconds from ``t0`` to its end)."""
    from dynamo_tpu_torch.runtime.context import PRIORITY_HEADER, TENANT_HEADER, Context

    t_sub = time.perf_counter()
    items, first = [], None
    ctx = Context(headers={TENANT_HEADER: tenant, PRIORITY_HEADER: priority})
    async for item in engine.generate(req, ctx):
        if item["token_ids"] and first is None:
            first = time.perf_counter() - t_sub
        items.append(item)
    return items, first, time.perf_counter() - t0


def stream_tokens(items, n, what) -> list[int]:
    toks = [t for x in items for t in x["token_ids"]]
    require(items[-1]["finish_reason"] == "length" and len(toks) == n,
            f"{what}: {len(toks)} tokens of {n}, finish {items[-1]['finish_reason']}")
    return toks


def overload_slot_cell(spec, cfg, params, prompts, inter, preemption: bool) -> dict:
    """Slot pressure: the 8 batch requests fill every slot, then the
    interactive arrivals, OVERLOAD_GAP_S apart, on a pipelined engine with
    ``preemption`` on or off. Returns the drive's phase output."""

    async def drive(engine):
        t0 = time.perf_counter()
        batch = [asyncio.ensure_future(tenant_stream(
            engine, make_request(p, OVERLOAD_BATCH_TOKENS), "bt", "batch", t0))
            for p in prompts]
        # every batch stream holds a slot and has its first token
        while (sum(s is not None and not s.first_pending for s in engine._slots)
               < len(prompts)):
            require(not any(b.done() for b in batch), "a batch stream ended before "
                                                      "all 8 held a slot")
            await asyncio.sleep(0.002)
        t_inter = time.perf_counter()
        interactive = []
        for p in inter:
            interactive.append(asyncio.ensure_future(tenant_stream(
                engine, make_request(p, OVERLOAD_INTERACTIVE_TOKENS), "it",
                "interactive", t0)))
            await asyncio.sleep(OVERLOAD_GAP_S)
        b_out = await asyncio.gather(*batch)
        i_out = await asyncio.gather(*interactive)
        return {"batch": b_out, "inter": i_out, "t_inter": t_inter - t0,
                "preemptions": dict(engine.preemptions),
                "rejects": dict(engine.admission_rejects),
                "active_pages": engine.allocator.active_pages}

    label = f"overload preemption {'on' if preemption else 'off'}"
    engine = new_engine(spec, dict(cfg, kv_dtype="bf16", pipeline_decode=True,
                                   pipeline_depth=2, decode_steps_per_dispatch=4,
                                   preemption=preemption), label, params=params)
    out = serve_phases(engine, [("slots", drive)])["slots"]
    drop_engine(engine)
    return out


def overload_phase(spec, cfg, params, prompts) -> int:
    """Phase 13: the overload plane on the phase-4 weights. Returns the
    fused_decode launches of its drives."""
    L = spec.num_layers
    inter, page_prompts = overload_prompts(spec.vocab_size)
    cells = {on: overload_slot_cell(spec, cfg, params, prompts, inter, on)
             for on in (True, False)}
    launches = 0
    streams = {}
    for on, out in cells.items():
        label = f"overload preemption {'on' if on else 'off'}"
        counts, steps = out["counts"], out["steps"]
        require(counts["fused_decode"] == L * steps == L * out["replays"],
                f"{label}: fused_decode {counts['fused_decode']} over {steps} steps")
        launches += counts["fused_decode"]
        res = out["res"]
        b = [stream_tokens(items, OVERLOAD_BATCH_TOKENS, f"{label} batch {i}")
             for i, (items, _f, _e) in enumerate(res["batch"])]
        it = [stream_tokens(items, OVERLOAD_INTERACTIVE_TOKENS, f"{label} interactive {i}")
              for i, (items, _f, _e) in enumerate(res["inter"])]
        require(res["active_pages"] == 0, f"{label}: {res['active_pages']} pages held "
                                          "after every stream ended")
        ttft = [f for _i, f, _e in res["inter"]]
        b_end = max(e for _i, _f, e in res["batch"])
        n_batch = len(b) * OVERLOAD_BATCH_TOKENS
        streams[on] = {"batch": b, "inter": it, "ttft": ttft}
        print(f"{label}: interactive TTFT mean {1e3 * sum(ttft) / len(ttft):.1f} ms, max "
              f"{1e3 * max(ttft):.1f} ms ({len(ttft)} requests of "
              f"{OVERLOAD_INTERACTIVE_TOKENS} tokens, {1e3 * OVERLOAD_GAP_S:.0f} ms apart, "
              f"the first {1e3 * res['t_inter']:.0f} ms after the batch submits); batch "
              f"{n_batch} tokens in {b_end:.3f} s = {n_batch / b_end:.1f} tok/s; "
              f"preemptions {res['preemptions']}; admission_rejects {res['rejects']}; "
              f"{steps} decode steps, fused_decode {counts['fused_decode']}")
    on, off = cells[True]["res"], cells[False]["res"]
    require(on["preemptions"].get("interactive_admission", 0) >= 1,
            f"overload: no interactive_admission preemption ({on['preemptions']})")
    require(off["preemptions"] == {}, f"overload off: preemptions {off['preemptions']}")
    mean = {k: sum(v["ttft"]) / len(v["ttft"]) for k, v in streams.items()}
    require(mean[True] < mean[False], f"overload: interactive TTFT {mean[True]:.3f} s "
                                      f"with preemption, {mean[False]:.3f} s without")
    agree = []
    for i, p in enumerate(prompts):
        same, tie = equal_to_first_near_tie(spec, params, p, streams[True]["batch"][i],
                                            streams[False]["batch"][i])
        require(same >= tie, f"overload batch {i}: the preemption-on stream parts from "
                             f"the preemption-off one at token {same}, before the first "
                             f"reference near-tie at {tie}")
        agree.append((same, tie))
    for i, p in enumerate(inter):
        near_argmax_check(spec, params, p, streams[True]["inter"][i])
    print(f"overload: interactive TTFT {mean[True] / mean[False]:.3f}x with preemption; "
          f"batch streams near-argmax, preemption on = off up to (first difference, first "
          f"near-tie) {agree}; interactive streams near-argmax; 0 active pages after")

    # page pressure, then the quota cell, on one small-pool engine
    async def page_cell(engine):
        t0 = time.perf_counter()
        batch = [asyncio.ensure_future(tenant_stream(
            engine, make_request(p, OVERLOAD_PAGE_TOKENS), "bt", "batch", t0))
            for p in page_prompts]
        while engine.allocator.available() > 0:
            require(not any(b.done() for b in batch), "a batch stream ended before the "
                                                      "pool ran out")
            await asyncio.sleep(0.002)
        t_full = time.perf_counter() - t0
        items, first, _end = await tenant_stream(
            engine, make_request(inter[0], OVERLOAD_INTERACTIVE_TOKENS), "it",
            "interactive", t0)
        b_out = await asyncio.gather(*batch)
        return {"batch": b_out, "inter": items, "ttft": first, "t_full": t_full,
                "preemptions": dict(engine.preemptions),
                "active_pages": engine.allocator.active_pages}

    async def quota_cell(engine):
        from dynamo_tpu_torch.runtime.context import OverQuota

        t0 = time.perf_counter()
        req = make_request(inter[1][:32], 8)
        first, _f, _e = await tenant_stream(engine, req, "q", "batch", t0)
        try:
            await tenant_stream(engine, req, "q", "batch", t0)
        except OverQuota as e:
            return {"first": first, "error": str(e), "retry": e.retry_after_s,
                    "rejects": dict(engine.admission_rejects)}
        raise SmokeError(f"quota: the second request of tenant q ({OVERLOAD_QUOTA}) "
                         "was not refused")

    engine = new_engine(spec, dict(cfg, kv_dtype="bf16", pipeline_decode=True,
                                   pipeline_depth=2, decode_steps_per_dispatch=4,
                                   num_pages=OVERLOAD_PAGES, tenants=OVERLOAD_QUOTA),
                        "overload pages", params=params)
    out = serve_phases(engine, [("pages", page_cell), ("quota", quota_cell)])
    drop_engine(engine)
    del engine
    for name in ("pages", "quota"):
        counts, steps = out[name]["counts"], out[name]["steps"]
        require(counts["fused_decode"] == L * steps == L * out[name]["replays"],
                f"overload {name}: fused_decode {counts['fused_decode']} over {steps} steps")
        launches += counts["fused_decode"]
    pg = out["pages"]["res"]
    for i, (items, _f, _e) in enumerate(pg["batch"]):
        stream_tokens(items, OVERLOAD_PAGE_TOKENS, f"overload pages batch {i}")
    toks = stream_tokens(pg["inter"], OVERLOAD_INTERACTIVE_TOKENS, "overload pages interactive")
    near_argmax_check(spec, params, inter[0], toks)
    require(pg["preemptions"].get("interactive_pages", 0) >= 1,
            f"overload pages: no interactive_pages preemption ({pg['preemptions']})")
    require(pg["active_pages"] == 0, f"overload pages: {pg['active_pages']} pages held "
                                     "after every stream ended")
    print(f"overload pages: {OVERLOAD_PAGES}-page pool exhausted by 2 batch streams "
          f"({OVERLOAD_PAGE_PROMPT} + {OVERLOAD_PAGE_TOKENS} tokens) after "
          f"{1e3 * pg['t_full']:.0f} ms; the interactive request completed "
          f"({OVERLOAD_INTERACTIVE_TOKENS} tokens, near-argmax, TTFT "
          f"{1e3 * pg['ttft']:.1f} ms); preemptions {pg['preemptions']}; both batch streams "
          f"ended 'length'; 0 active pages after; fused_decode "
          f"{out['pages']['counts']['fused_decode']}")
    q = out["quota"]["res"]
    stream_tokens(q["first"], 8, "overload quota first request")
    require(q["retry"] > 0 and q["rejects"]["over_quota"] == 1,
            f"overload quota: Retry-After {q['retry']}, rejects {q['rejects']}")
    print(f"overload quota ({OVERLOAD_QUOTA}): the second request refused: {q['error']}; "
          f"Retry-After {q['retry']:.3f} s; admission_rejects {q['rejects']}")
    return launches


# ------------------------------------------------------------ HTTP serving


# ------------------------------------------------------------ guided decoding


def guided_grammars(vocab) -> dict:
    """Phase 14's grammars, lowered as the frontend lowers them; the bounded
    ones (a schema of an enum and a maxLength string, a fixed-shape regex,
    the repeating regex) must be finite: their char DFA has no cycle, and
    its longest sentence, one mock token per char, fits in GUIDED_TOKENS."""
    from dynamo_tpu_torch.guided import grammar_from_request

    reqs = {
        "json_schema": {"response_format": {"type": "json_schema", "json_schema": {
            "name": "smoke", "schema": GUIDED_SCHEMA}}},
        "json_object": {"response_format": {"type": "json_object"}},
        "regex": {"nvext": {"guided_regex": GUIDED_REGEX}},
        "repeat": {"nvext": {"guided_regex": GUIDED_REPEAT}},
    }
    out = {k: grammar_from_request(r) for k, r in reqs.items()}
    for kind in ("json_schema", "regex", "repeat"):
        n = longest_sentence(out[kind]["regex"])
        require(n is not None and n < GUIDED_TOKENS,
                f"guided {kind}: grammar not finite within {GUIDED_TOKENS} tokens ({n})")
    return out


def longest_sentence(src: str) -> int | None:
    """Chars of the longest sentence of a regex's char DFA, or None when
    the DFA has a cycle (an unbounded grammar)."""
    from dynamo_tpu_torch.guided import compile_regex

    dfa = compile_regex(src)
    memo: dict[int, int] = {}
    on_path: set[int] = set()

    def longest(s: int) -> int | None:
        if s in memo:
            return memo[s]
        if s in on_path:
            return None
        on_path.add(s)
        best = 0
        for nxt in set(dfa.trans[s].values()):
            n = longest(nxt)
            if n is None:
                return None
            best = max(best, n + 1)
        on_path.discard(s)
        memo[s] = best
        return best

    return longest(dfa.start)


def guided_states(comp, grammar, text: str, k: int = 4) -> list[int]:
    """``k`` distinct char-DFA states along ``text`` (a sentence of the
    grammar), the start state first."""
    tok = {t: i for i, t in enumerate(comp.vocab.tokens) if t}
    st = comp.state_for(grammar, eos_ids=(2,))
    states = [st.state]
    for ch in text:
        require(st.advance(tok[ch]), f"guided: {text!r} leaves the grammar at {ch!r}")
        if st.state not in states:
            states.append(st.state)
    require(len(states) >= k, f"guided: {len(states)} distinct states along {text!r}")
    return states[:k]


def own_pools(spec, params, prompts, kv_dtype: str, room: int):
    """Fresh pools holding ``prompts`` after one packed prefill (slot i owns
    a run of pages of its own, page 0 the trash page); returns (pools,
    block tables [B, P], first tokens [B], seq_lens [B] counting them), the
    arrays int32 on the host."""
    from dynamo_tpu_torch.models import llama

    B, page, P = len(prompts), 16, 64
    per = max((len(p) + room) // page + 1 for p in prompts)
    pools = llama.init_cache(spec, 1 + B * per, page, device=DEVICE, kv_dtype=kv_dtype)
    bts = np.zeros((B, P), np.int32)
    for i in range(B):
        bts[i, :per] = np.arange(1 + i * per, 1 + (i + 1) * per)
    T = -(-max(len(p) for p in prompts) // page) * page
    tokens = np.zeros((B, T), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = p
    lens = torch.tensor([len(p) for p in prompts])
    with torch.no_grad():
        logits, _ = llama.prefill_forward_batch(
            spec, params, torch.from_numpy(tokens).to(DEVICE),
            torch.from_numpy(bts).to(DEVICE), torch.zeros(B, dtype=torch.int64),
            *pools, lens)
    first = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
    return pools, bts, first, (lens + 1).to(torch.int32).numpy()


def staging_ms(dst: torch.Tensor, src: np.ndarray, reps: int = 10) -> float:
    """Device ms of one mask staging: the pinned host buffer's copy into the
    graph's static mask (graphs.py's ``_pinned`` then ``copy_``)."""
    from dynamo_tpu_torch.engine.graphs import _pinned

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    total = 0.0
    for _ in range(reps + 1):
        host = _pinned(src, True)
        torch.cuda.synchronize()
        start.record()
        dst.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / (reps + 1)


def masked_graph_check(spec, params, prompts, masks, kv_dtype="bf16",
                       unfused=False) -> None:
    """Phase 14 (a): the masked decode graph against eager decode_steps(
    allowed=...) on copies of the same pools after a prefill of ``prompts``
    (8 slots: rows 0-3 under the masks of distinct grammar states, rows 4-7
    all-True; rows 2, 3, 6, 7 at temperature 0.8 in the sampled variant).
    Greedy and sampled-with-logprobs replays (unfused: greedy only): records
    bitwise equal, every masked row's token allowed, the all-True rows'
    records bitwise equal to the unmasked graph's on the same inputs, pools
    bitwise equal outside page 0, one attention launch per layer (unfused:
    paged_attention_v3 and kv_write each)."""
    from dynamo_tpu_torch.engine.graphs import DecodeGraphs
    from dynamo_tpu_torch.models import llama

    L, B, V = spec.num_layers, len(prompts), spec.vocab_size
    n_lp = min(20, V - 1)
    form = kv_dtype + (" unfused" if unfused else "")
    base, bts, first, seq_lens = own_pools(spec, params, prompts, kv_dtype, room=1)
    allowed = np.ones((B, V), bool)
    allowed[: len(masks)] = masks
    inputs = {"tokens": first, "block_tables": bts, "seq_lens": seq_lens,
              "active": np.ones(B, bool),
              "temperature": np.asarray([0.0, 0.0, 0.8, 0.8] * (B // 4), np.float32),
              "top_k": np.zeros(B, np.int32), "top_p": np.ones(B, np.float32),
              "seeds": (np.arange(B, dtype=np.uint32) * 7919 + 11).astype(np.uint32),
              "steps": np.zeros(B, np.int32)}
    want_counts = ({"paged_attention_v3": L, "kv_write": L} if unfused
                   else {"fused_decode": L})
    if kv_dtype == "fp8":
        want_counts.update({k + "/fp8": v for k, v in want_counts.items()})
    if unfused:
        os.environ["DYNAMO_FUSED_DECODE"] = "0"
    variants = ((False, 0),) if unfused else ((False, 0), (True, n_lp))
    try:
        for sampled, lp_width in variants:
            inp = dict(inputs, temperature=inputs["temperature"] * sampled)
            eager = tuple(clone_pool(p) for p in base)
            graph = tuple(clone_pool(p) for p in base)
            free = tuple(clone_pool(p) for p in base)
            with torch.no_grad():
                want = llama.decode_steps(
                    spec, params, *(torch.from_numpy(inp[k]) for k in
                                    ("tokens", "block_tables", "seq_lens")),
                    *eager, torch.from_numpy(inp["active"]),
                    *(torch.from_numpy(inp[k]) for k in ("temperature", "top_k", "top_p")),
                    torch.from_numpy(inp["seeds"].astype(np.int64)),
                    torch.from_numpy(inp["steps"]), n_steps=1, n_logprobs=lp_width,
                    allowed=torch.from_numpy(allowed))
            want = [x.cpu().numpy() for x in (want if lp_width else (want,))]
            runners = {}
            for name, pools, vocab in (("masked", graph, V), ("free", free, None)):
                def step(t, s, k, pools=pools):
                    llama.decode_step_(spec, params, *pools, t, sampled=s, n_logprobs=k)
                runners[name] = DecodeGraphs(
                    step, batch=B, pages_per_seq=bts.shape[1], max_steps=1,
                    n_logprobs=n_lp, device=torch.device(DEVICE), vocab_size=vocab)
            variant = f"{'sampled' if sampled else 'greedy'}, n_logprobs {lp_width}"
            with torch.no_grad():
                runners["masked"].precompile([(sampled, lp_width, True)])
                runners["free"].precompile([(sampled, lp_width, False)])
                zero_counts()
                got = runners["masked"].dispatch(inp, 1, sampled=sampled,
                                                 n_logprobs=lp_width,
                                                 allowed=allowed).result()
                counts = {k: v for k, v in read_counts().items() if v}
                plain = runners["free"].dispatch(inp, 1, sampled=sampled,
                                                 n_logprobs=lp_width).result()
            require(counts == want_counts,
                    f"masked graph {form} ({variant}): launches {counts} in one replay")
            rec_ok = all(np.array_equal(g, w) for g, w in zip(got[1:], want))
            toks = got[1][:, 0]
            allowed_ok = all(allowed[i, toks[i]] for i in range(B))
            free_rows = slice(len(masks), B)
            free_ok = all(np.array_equal(g[free_rows], p[free_rows])
                          for g, p in zip(got[1:], plain[1:]) if g is not None)
            pools_ok = all(pools_equal(a, b) for a, b in zip(graph, eager))
            print(f"masked graph {form} ({variant}): replay vs eager decode_steps(allowed): "
                  f"records {'identical' if rec_ok else 'DIFFER'}, masked rows' tokens "
                  f"{'allowed' if allowed_ok else 'NOT ALLOWED'}, all-True rows "
                  f"{'equal' if free_ok else 'DIFFER from'} the unmasked graph's, pools "
                  f"{'bitwise equal' if pools_ok else 'DIFFER'}; launches {counts}")
            require(rec_ok and allowed_ok and free_ok and pools_ok,
                    f"masked graph {form} ({variant}) differs")
            if not unfused and not sampled and kv_dtype == "bf16":
                m_ms = host_ms(lambda: runners["masked"].dispatch(
                    inp, 1, sampled=False, n_logprobs=0, allowed=allowed).result())
                f_ms = host_ms(lambda: runners["free"].dispatch(
                    inp, 1, sampled=False, n_logprobs=0).result())
                s_ms = staging_ms(runners["masked"].allowed, allowed)
                print(f"masked graph step B={B}: host wall {m_ms:.2f} ms masked vs "
                      f"{f_ms:.2f} ms unmasked; mask staging {allowed.nbytes / 1e6:.2f} MB "
                      f"per dispatch, {s_ms:.4f} ms device")
            for r in runners.values():
                r.release()
            del eager, graph, free, runners
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("DYNAMO_FUSED_DECODE", None)
        del base
        torch.cuda.empty_cache()


def masked_verify_check(spec, params, prompts, masks) -> None:
    """Phase 14 (c): the masked verify captured per row count against an
    eager verify_forward(allowed=...) on copies of the same pools: rows of
    the first token plus the prompts' next tokens (1..SPEC_W of them), rows
    0-3 under the masks of distinct grammar states (position j of row r
    under state (r + j) mod 4), the others all-True. Targets identical and
    allowed at each valid position, pools bitwise equal outside page 0,
    kv_write 32 launches per replay."""
    from dynamo_tpu_torch.engine.graphs import VerifyGraphs, verify_row_counts
    from dynamo_tpu_torch.models import llama

    L, B, W, V = spec.num_layers, len(prompts), SPEC_W, spec.vocab_size
    base, bts, first, seq_lens = own_pools(spec, params, prompts, "bf16", room=W)
    tokens = np.zeros((B, W), np.int32)
    nts = np.asarray([W, W - 2, 1, W, 5, W, 3, W][:B], np.int32)
    for i, p in enumerate(prompts):
        tokens[i, 0] = first[i]
        tokens[i, 1:nts[i]] = p[: nts[i] - 1]
    starts = (seq_lens - 1).astype(np.int32)
    allowed = np.ones((B, W, V), bool)
    for r in range(len(masks)):
        for j in range(W):
            allowed[r, j] = masks[(r + j) % len(masks)]
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    eager = tuple(clone_pool(p) for p in base)
    graph = tuple(clone_pool(p) for p in base)
    runner = VerifyGraphs(
        lambda t, b, s, n, a=None: llama.verify_forward(spec, params, t, b, s, *graph, n, a),
        batch=B, width=W, pages_per_seq=bts.shape[1], device=torch.device(DEVICE),
        vocab_size=V)
    try:
        with torch.no_grad():
            runner.precompile()
            for n in verify_row_counts(B):
                for pools in (eager, graph):
                    for dst, src in zip(pools, base):
                        copy_pool_(dst, src)
                want = llama.verify_forward(spec, params, dev(tokens[:n]), dev(bts[:n]),
                                            dev(starts[:n]), *eager, dev(nts[:n]),
                                            dev(allowed[:n]))[0].cpu().numpy()
                zero_counts()
                got = runner.dispatch(tokens[:n], bts[:n], starts[:n], nts[:n],
                                      allowed[:n]).wait().numpy()
                counts = read_counts()
                pools_ok = all(pools_equal(a, b) for a, b in zip(graph, eager))
                ok_allowed = all(allowed[r, j, got[r, j]] for r in range(n)
                                 for j in range(nts[r]))
                print(f"masked verify graph bf16 ({n} rows x {W}): replay vs eager "
                      f"verify_forward(allowed): targets "
                      f"{'identical' if np.array_equal(got, want) else 'DIFFER'} and "
                      f"{'allowed' if ok_allowed else 'NOT ALLOWED'}, pools "
                      f"{'bitwise equal' if pools_ok else 'DIFFER'}; kv_write launches "
                      f"{counts['kv_write']}")
                require(np.array_equal(got, want) and pools_ok and ok_allowed,
                        f"masked verify graph ({n} rows) differs from eager verify_forward")
                require(counts["kv_write"] == L,
                        f"masked verify graph: kv_write launched {counts['kv_write']} "
                        "times in one replay")
            s_ms = staging_ms(runner.allowed, allowed)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

            def span(mask, reps=5):
                total = 0.0
                for _ in range(reps + 1):
                    torch.cuda.synchronize()
                    start.record()
                    out = runner.dispatch(tokens, bts, starts, nts, mask)
                    end.record()
                    out.wait()
                    total += start.elapsed_time(end)
                return total / (reps + 1)

            m_ms, u_ms = span(allowed), span(None)
        print(f"masked verify: mask staging {allowed.nbytes / 1e6:.2f} MB per dispatch "
              f"({B} x {W} x {V}), {s_ms:.4f} ms device; device span of a {B} x {W} "
              f"replay {m_ms:.3f} ms masked vs {u_ms:.3f} ms unmasked")
    finally:
        runner.release()
        del base, eager, graph, runner
        torch.cuda.empty_cache()


def guided_engine(spec, cfg, params, vocab, label):
    """An engine with a guided vocabulary whose decode (and verify) graphs
    are captured in two rounds, the unmasked variants then the masked ones:
    prints the seconds and graph-pool memory of each."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.core import InferenceEngine

    engine = InferenceEngine(spec, EngineConfig(**cfg), params=params, device=DEVICE,
                             guided_vocab=vocab)
    rounds = []
    for masked in (False, True):
        # a capture empties the allocator's cache first: start each round
        # from an empty cache, so the reserved delta is the graphs' pool
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0, m0 = time.perf_counter(), torch.cuda.memory_reserved()
        engine._graphs.precompile([v for v in engine._graphs.variants() if v[2] == masked])
        if engine._verify is not None and engine._verify.cuda:
            for key in engine._verify.variants():
                if key[1] == masked:
                    engine._verify._graph(key)
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0, torch.cuda.memory_reserved() - m0))
    verify = (f" + {len(engine._verify._graphs)} verify graphs"
              if engine._verify is not None else "")
    print(f"precompile {label}: {len(engine._graphs._graphs)} decode graph variants{verify}; "
          f"unmasked {rounds[0][0]:.2f} s, {rounds[0][1] / 2**20:.0f} MiB reserved; masked "
          f"{rounds[1][0]:.2f} s, {rounds[1][1] / 2**20:.0f} MiB reserved more")
    return engine


def guided_requests(prompts, grammars, kinds, n=GUIDED_TOKENS):
    """One request per prompt: kind i of ``kinds`` ("free" or a grammar),
    even indices greedy, odd ones seeded at temperature 0.8; free ones
    ignore EOS."""
    reqs = []
    for i, (p, kind) in enumerate(zip(prompts, kinds)):
        sampling = ({"temperature": 0.0} if i % 2 == 0
                    else {"temperature": 0.8, "seed": GUIDED_SEED + i})
        req = {"token_ids": p, "sampling": sampling,
               "stop_conditions": {"max_tokens": n, "ignore_eos": kind == "free"}}
        if kind != "free":
            req["guided"] = {**grammars[kind], "prompt_len": len(p)}
        reqs.append(req)
    return reqs


def guided_outcomes() -> dict:
    from dynamo_tpu_torch.guided import GUIDED_REQUESTS

    return {o: GUIDED_REQUESTS.labels(outcome=o).value
            for o in ("ok", "truncated", "violation", "aborted")}


def masked_reference(spec, params, prompt, tokens, comp=None, grammar=None):
    """The unpaged reference forward over prompt + served tokens, its
    logits masked by the grammar cursor along the stream when a grammar is
    given: (gap of each served token to the (masked) maximum, top-2 gap per
    position)."""
    from dynamo_tpu_torch.models import llama

    seq = torch.tensor(prompt + tokens[:-1], device=DEVICE)
    with torch.no_grad():
        logits = llama.reference_forward(spec, params, seq)[len(prompt) - 1:]
    if grammar is not None:
        st = comp.state_for(grammar, eos_ids=(2,))
        masks = []
        for t in tokens:
            masks.append(st.mask())
            st.advance(int(t))
        logits = torch.where(torch.from_numpy(np.stack(masks)).to(DEVICE), logits, -1e30)
    served = torch.tensor(tokens, device=DEVICE)
    top2 = logits.topk(2, dim=-1).values
    gap = (top2[:, 0] - logits.gather(1, served[:, None])[:, 0]).cpu().numpy()
    return gap, (top2[:, 0] - top2[:, 1]).cpu().numpy()


def near_draw(spec, params, prompt, tokens, seed, temperature):
    """A seeded stream against the reference: its draw scores (reference
    logits / T plus the request's Gumbel noise at each step) give (gap of
    each served token to the maximum score, top-2 score gap per
    position)."""
    from dynamo_tpu_torch.engine.sampling import gumbel_noise
    from dynamo_tpu_torch.models import llama

    n = len(tokens)
    seq = torch.tensor(prompt + tokens[:-1], device=DEVICE)
    with torch.no_grad():
        logits = llama.reference_forward(spec, params, seq)[len(prompt) - 1:]
        noise = gumbel_noise(torch.full((n,), seed, device=DEVICE),
                             torch.arange(n, device=DEVICE), logits.shape[-1])
    score = logits / temperature + noise
    served = torch.tensor(tokens, device=DEVICE)
    top2 = score.topk(2, dim=-1).values
    gap = (top2[:, 0] - score.gather(1, served[:, None])[:, 0]).cpu().numpy()
    return gap, (top2[:, 0] - top2[:, 1]).cpu().numpy()


def first_tie(ties: np.ndarray, bound: float) -> int:
    low = ties < bound
    return int(np.argmax(low)) if low.any() else len(ties)


def first_diff(a, b) -> int:
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def guided_phase(spec, cfg, params, prompts) -> tuple[int, int]:
    """Phase 14: guided decoding. Returns (fused_decode launches of its
    serves, kv_write launches of its masked verifies)."""
    from dynamo_tpu_torch.frontend.tokenizer import MockTokenizer
    from dynamo_tpu_torch.guided import GrammarCompiler, TokenVocab

    L, V = spec.num_layers, spec.vocab_size
    t_phase = t0 = time.perf_counter()
    vocab = TokenVocab.from_tokenizer(MockTokenizer(), V)
    vocab_s = time.perf_counter() - t0
    grammars = guided_grammars(vocab)
    comp = GrammarCompiler(vocab, vocab_size=V)
    # compile every grammar here, timed one by one: the engines below find
    # them in the process-wide cache, so their serves time decoding alone
    compile_ms = {}
    for kind, g in grammars.items():
        t1 = time.perf_counter()
        comp.compile(g)
        compile_ms[kind] = round(1e3 * (time.perf_counter() - t1), 1)
    t0 = time.perf_counter()
    states = guided_states(comp, grammars["json_schema"], GUIDED_SAMPLE_TEXT)
    tdfa = comp.compile(grammars["json_schema"]).tdfa
    fresh = [s for s in states if s not in tdfa._masks]
    mask_ms = "not measured (every state's mask cached)"
    if fresh:
        t1 = time.perf_counter()
        tdfa.mask(fresh[0])
        mask_ms = f"{1e3 * (time.perf_counter() - t1):.1f} ms"
    cursor = comp.state_for(grammars["json_schema"], eos_ids=(2,))
    masks = np.stack([cursor.mask_for(s) for s in states])
    print(f"guided: vocab of {V} ids from the mock tokenizer in {vocab_s:.2f} s "
          f"({sum(1 for t in vocab.tokens if t)} non-empty); compile ms {compile_ms}; "
          f"one new state's mask "
          f"(the O(V) walk) {mask_ms}; {len(states)} states' masks in "
          f"{time.perf_counter() - t0:.2f} s")

    # (a) the masked step graphs, bf16, fp8 and unfused bf16
    for kv_dtype, unfused in (("bf16", False), ("fp8", False), ("bf16", True)):
        masked_graph_check(spec, params, prompts, masks, kv_dtype, unfused)

    # (b) the mixed serve on one pipelined engine
    kinds = ["json_schema", "json_schema", "json_object", "json_object", "regex", "regex",
             "free", "free"]
    reqs = guided_requests(prompts, grammars, kinds)
    free_reqs = guided_requests(prompts, grammars, ["free"] * len(prompts))
    pipelined = dict(cfg, pipeline_decode=True, pipeline_depth=2,
                     decode_steps_per_dispatch=4)
    engine = guided_engine(spec, pipelined, params, vocab, "guided pipelined")
    seen: list[tuple] = []
    dispatch = engine._graphs.dispatch

    def spy(inputs, n_steps, **kw):
        seen.append((engine._guided_live(), n_steps, kw.get("allowed") is not None,
                     len(engine._pipeline)))
        return dispatch(inputs, n_steps, **kw)

    engine._graphs.dispatch = spy
    marks = {}

    async def mixed(e):
        n0, o0 = len(e.decode_step_times), guided_outcomes()
        out = await requests(e, reqs)
        marks.update(times=list(e.decode_step_times)[n0:], n_seen=len(seen),
                     active=e.allocator.active_pages,
                     outcomes={k: v - o0[k] for k, v in guided_outcomes().items()},
                     snap=e.guided_snapshot())
        return out

    async def all_free(e):
        e.request_clear_cache()
        while e.allocator.evictable_pages:
            await asyncio.sleep(0.01)
        n0, k0 = len(e.decode_step_times), len(seen)
        res = await requests(e, free_reqs)
        marks.update(free_times=list(e.decode_step_times)[n0:], free_seen=seen[k0:])
        return res

    out = serve_phases(engine, [("mixed", mixed), ("free", all_free)])
    kinds_seen = list(seen)
    drop_engine(engine)
    del engine
    (items, _ttft, wall), counts = out["mixed"]["res"], out["mixed"]["counts"]
    streams = [[t for x in it for t in x["token_ids"]] for it in items]
    finish = [it[-1]["finish_reason"] for it in items]
    free_items, _f, free_wall = out["free"]["res"]
    free_streams = [[t for x in it for t in x["token_ids"]] for it in free_items]
    require(marks["outcomes"]["violation"] == 0, f"guided serve: violations {marks}")
    require(marks["active"] == 0, f"guided serve: {marks['active']} pages held after")
    steps = out["mixed"]["steps"]
    require(counts["fused_decode"] == L * steps == L * out["mixed"]["replays"],
            f"guided serve: fused_decode {counts['fused_decode']} over {steps} steps")
    live = [s for s in kinds_seen[: marks["n_seen"]] if s[0]]
    require(live and all(n == 1 and m and depth == 0 for _l, n, m, depth in live),
            f"guided serve: a multi-step or pipelined burst while a guided slot was live "
            f"{[s for s in live if s[1] != 1 or not s[2] or s[3]][:4]}")
    ok = 0
    for i, kind in enumerate(kinds):
        if kind == "free":
            continue
        toks = [t for t in streams[i] if t != 2]
        st = comp.state_for(grammars[kind], eos_ids=(2,))
        walks = all(st.advance(t) for t in streams[i])
        require(walks, f"guided {kind} {i}: the stream leaves the grammar")
        text = vocab.text(toks)
        ok += st.conformant and finish[i] in ("stop", "length")
        if kind in ("json_schema", "regex"):
            require(finish[i] == "stop" and st.conformant,
                    f"guided {kind} {i}: finish {finish[i]}, text {text!r}")
        if kind == "json_schema":
            doc = json.loads(text)
            require(set(doc) == {"color", "name"} and doc["color"] in ("red", "green", "blue")
                    and isinstance(doc["name"], str) and len(doc["name"]) <= 8,
                    f"guided json_schema {i}: {doc}")
        elif kind == "regex":
            require(re.fullmatch(r"[ \n\t\r]{0,3}" + GUIDED_REGEX + r"[ \n\t\r]{0,3}", text),
                    f"guided regex {i}: {text!r}")
        elif st.conformant:
            json.loads(text)
        if i % 2 == 0:
            gap, _ = masked_reference(spec, params, prompts[i], streams[i], comp,
                                      grammars[kind])
            require(gap.max() <= NEAR_ARGMAX,
                    f"guided {kind} {i}: served token {gap.max():.3f} below the masked "
                    "reference max")
        print(f"guided {kind} {i} ({'greedy' if i % 2 == 0 else 'sampled'}): "
              f"{len(streams[i])} tokens, finish {finish[i]}, conformant {st.conformant}: "
              f"{text[:80]!r}")
    require(marks["outcomes"]["ok"] == ok,
            f"guided serve: outcomes {marks['outcomes']}, {ok} conformant finishes")
    # the free streams: near the reference (argmax, or the seeded draw) and
    # equal to the all-free serve's up to their first reference near-tie
    for i in (6, 7):
        greedy = i % 2 == 0
        temp = reqs[i]["sampling"]["temperature"]
        bound = NEAR_ARGMAX if greedy else NEAR_ARGMAX / temp
        ties = []
        for s in (streams[i], free_streams[i]):
            gap, tie_gaps = (masked_reference(spec, params, prompts[i], s) if greedy
                             else near_draw(spec, params, prompts[i], s, GUIDED_SEED + i,
                                            temp))
            require(gap.max() <= bound, f"guided serve free {i}: served token "
                                        f"{gap.max():.3f} below the reference")
            ties.append(tie_gaps)
        tie = first_tie(ties[0], bound)
        same = first_diff(streams[i], free_streams[i])
        require(same >= tie, f"guided serve free {i}: differs from the all-free serve at "
                             f"{same}, before its first near-tie {tie}")
        print(f"guided free {i} ({'greedy' if greedy else 'sampled'}): equal to the "
              f"all-free serve for {same} of {len(streams[i])} tokens (first reference "
              f"near-tie at {tie})")
    n_tok, n_free = sum(map(len, streams)), sum(map(len, free_streams))
    masked_states = {k: len(comp.compile(grammars[k]).tdfa._masks)
                     for k in ("json_schema", "json_object", "regex")}
    d_mask = [t for t, s in zip(marks["times"], kinds_seen) if s[2]]
    d_free = [(t, s[1]) for t, s in zip(marks["free_times"], marks["free_seen"])]
    print(f"guided serve: {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s mixed "
          f"vs {n_free / free_wall:.1f} tok/s all-free ({n_free} tokens in "
          f"{free_wall:.3f} s); {len(d_mask)} masked single steps, dispatch to host "
          f"{1e3 * sum(d_mask) / max(len(d_mask), 1):.2f} ms each; the all-free serve's "
          f"{len(d_free)} pipelined bursts, "
          f"{1e3 * sum(t for t, _ in d_free) / max(len(d_free), 1):.2f} ms each "
          f"({sum(n for _, n in d_free)} steps, depth 2 in flight); states masked by the "
          f"grammars' O(V) walk in all {masked_states}; outcomes {marks['outcomes']}; compiler "
          f"{marks['snap']}; fused_decode {counts['fused_decode']} = {L} x {steps}")
    launches = counts["fused_decode"]

    # (c) guided x spec: the masked verify graph, then the greedy guided
    # requests of (b) plus a repeating grammar, spec ngram against spec off
    masked_verify_check(spec, params, prompts, masks)
    spec_kinds = [(0, "json_schema"), (2, "json_object"), (4, "regex"), (6, "repeat")]
    spec_reqs_ = [guided_requests([prompts[i]], grammars, [k])[0] for i, k in spec_kinds]
    res = {}
    for mode in ("ngram", "off"):
        engine = guided_engine(spec, dict(cfg, spec_mode=mode, spec_k_max=8), params,
                               vocab, f"guided spec {mode}")
        verifies: list[bool] = []
        if mode == "ngram":
            vdispatch = engine._verify.dispatch

            def vspy(*a, _d=vdispatch):
                verifies.append(a[4] is not None if len(a) > 4 else False)
                return _d(*a)

            engine._verify.dispatch = vspy
        o = serve_phases(engine, [("serve", lambda e: requests(e, spec_reqs_))])
        res[mode] = (o["serve"], list(verifies))
        drop_engine(engine)
        del engine
    on, vmasked = res["ngram"]
    off, _ = res["off"]
    require(sum(vmasked) >= 1 and on["counts"]["kv_write"] == L * len(vmasked),
            f"guided spec: {sum(vmasked)} masked of {len(vmasked)} verify dispatches, "
            f"kv_write {on['counts']['kv_write']}")
    for mode, o in (("on", on), ("off", off)):
        require(o["counts"]["fused_decode"] == L * o["steps"],
                f"guided spec {mode}: fused_decode {o['counts']['fused_decode']} over "
                f"{o['steps']} steps")
    for k, (i, kind) in enumerate(spec_kinds):
        got = [t for x in on["res"][0][k] for t in x["token_ids"]]
        want = [t for x in off["res"][0][k] for t in x["token_ids"]]
        gaps = []
        for s in (got, want):
            gap, ties = masked_reference(spec, params, prompts[i], s, comp, grammars[kind])
            require(gap.max() <= NEAR_ARGMAX, f"guided spec {kind}: served token "
                                              f"{gap.max():.3f} below the masked max")
            gaps.append(ties)
        tie = first_tie(gaps[0], NEAR_ARGMAX)
        same = first_diff(got, want)
        require(same >= tie or (got == want),
                f"guided spec {kind}: spec on differs from off at {same}, before the first "
                f"near-tie {tie}")
        print(f"guided spec {kind}: on equals off for {same} of {len(got)} tokens "
              f"(first near-tie {tie}); {vocab.text(got)[:60]!r}")
    wall_on, wall_off = on["res"][2], off["res"][2]
    print(f"guided spec: {len(vmasked)} verify dispatches ({sum(vmasked)} masked), kv_write "
          f"{on['counts']['kv_write']} = {L} x {len(vmasked)}; wall {wall_on:.3f} s on vs "
          f"{wall_off:.3f} s off; fused_decode on {on['counts']['fused_decode']}, off "
          f"{off['counts']['fused_decode']}")
    launches += on["counts"]["fused_decode"] + off["counts"]["fused_decode"]
    print(f"guided phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, on["counts"]["kv_write"]


async def http_call(port, method, path, body=None, raw=None, drop_after=None,
                    on_chunk=None):
    """One HTTP/1.1 request on a connection of its own (stdlib only).
    Returns (status, body bytes, seconds from the send to each body chunk).
    A chunked (SSE) body is read chunk by chunk; with ``drop_after`` the
    client goes away after that many chunks; ``on_chunk(n)`` is awaited
    after the n-th chunk."""
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
            if on_chunk is not None:
                await on_chunk(len(chunks))
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
            zero_counts()
            before = (engine.steps, engine._graphs.replays)
            out["features"] = await serve_features(drt, port, engine, spec, cfg, prompts,
                                                   watcher, clear)
            out["features"]["counts"] = read_counts()
            out["features"]["steps"] = engine.steps - before[0]
            out["features"]["replays"] = engine._graphs.replays - before[1]
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
    features = features_check(out["features"], L)
    drop_engine(out.pop("engine"))
    return counts["fused_decode"] + features, {"tok_s": n_tok / wall,
                                               "ttft_mean": sum(ttft) / n,
                                               "ttft_max": max(ttft)}


def feature_text(n_tokens: int) -> str:
    """A user message whose chat prompt is about ``n_tokens`` mock tokens."""
    words = "the quick brown fox jumps over a lazy dog while seven ravens watch ".split()
    out, i = [], 0
    while len(" ".join(out)) < n_tokens - 32:  # the template's own tokens
        out.append(words[i % len(words)])
        i += 1
    return " ".join(out)


async def serve_features(drt, port, engine, spec, cfg, prompts, watcher, clear) -> dict:
    """Phase 9's serving features on the same engine, each request alone
    on a cleared prefix cache (so each prefill is whole and each greedy
    stream is the same computation): a plain chat completion, then
    /v1/responses non-streamed and streamed with the same messages, at the
    shortest and longest serve prompt lengths; then the same engine
    registered a second time under a card with the hermes tool-call and
    deepseek_r1 reasoning parsers, and a chat completion with ``tools``
    through it, aggregated and streamed."""
    from dynamo_tpu_torch.frontend.model_card import register_llm

    name = spec.name
    out: dict = {"lengths": [], "responses": []}

    async def post(path, body):
        await clear()
        status, data, _ = await http_call(port, "POST", path, body)
        if status == 200 and body.get("stream"):
            return status, data
        return status, json.loads(data)

    for n in (min(map(len, prompts)), max(map(len, prompts))):
        messages = [{"role": "user", "content": feature_text(n)}]
        plain = await post("/v1/chat/completions", {
            "model": name, "messages": messages, "max_tokens": FEATURE_TOKENS})
        flat = await post("/v1/responses", {
            "model": name, "input": messages, "max_output_tokens": FEATURE_TOKENS})
        streamed = await post("/v1/responses", {
            "model": name, "input": messages, "max_output_tokens": FEATURE_TOKENS,
            "stream": True})
        out["responses"].append((plain, flat, streamed))
    # the parsed card: the same handler under another component
    parsed = f"{name}-parsed"
    await register_llm(
        drt, drt.namespace("dynamo").component("parsed").endpoint("generate"),
        engine.generate, model_name=parsed, context_length=engine.config.max_context,
        kv_block_size=cfg["page_size"], router_mode="round_robin",
        tool_call_parser="hermes", reasoning_parser="deepseek_r1")
    await watcher.wait_for_model(parsed, timeout=30)
    tools = [{"type": "function", "function": {
        "name": "get_weather", "parameters": {
            "type": "object", "properties": {"city": {"type": "string"}}}}}]
    messages = [{"role": "user", "content": feature_text(len(prompts[3]))}]
    out["plain_chat"] = await post("/v1/chat/completions", {
        "model": name, "messages": messages, "max_tokens": FEATURE_TOKENS, "tools": tools})
    out["parsed_chat"] = await post("/v1/chat/completions", {
        "model": parsed, "messages": messages, "max_tokens": FEATURE_TOKENS, "tools": tools})
    out["parsed_stream"] = await post("/v1/chat/completions", {
        "model": parsed, "messages": messages, "max_tokens": FEATURE_TOKENS, "tools": tools,
        "stream": True})
    # guided decoding: a json_schema chat on the plain card, and a forced
    # tool call through a card with the hermes parser alone (deepseek_r1
    # would take the call for reasoning)
    tooled = f"{name}-tools"
    await register_llm(
        drt, drt.namespace("dynamo").component("tools").endpoint("generate"),
        engine.generate, model_name=tooled, context_length=engine.config.max_context,
        kv_block_size=cfg["page_size"], router_mode="round_robin",
        tool_call_parser="hermes")
    await watcher.wait_for_model(tooled, timeout=30)
    out["guided_schema"] = await post("/v1/chat/completions", {
        "model": name, "messages": messages, "max_tokens": GUIDED_TOKENS,
        "response_format": {"type": "json_schema",
                            "json_schema": {"name": "smoke", "schema": GUIDED_SCHEMA}}})
    out["guided_tool"] = await post("/v1/chat/completions", {
        "model": tooled, "messages": messages, "max_tokens": GUIDED_TOOL_TOKENS,
        "tools": [GUIDED_TOOL], "tool_choice": "required"})
    return out


def responses_events(body: bytes) -> list:
    """The named SSE events of a /v1/responses stream: [(event, data)]."""
    out = []
    for e in (e for e in body.decode().split("\n\n") if e):
        name, _, data = e.partition("\n")
        require(name.startswith("event: ") and data.startswith("data: "),
                f"bad /v1/responses SSE framing {e[:200]!r}")
        out.append((name[len("event: "):], json.loads(data[len("data: "):])))
    return out


def jail_us_per_chunk(reps: int = 200) -> tuple[float, int]:
    """Host microseconds per text delta of the chat stream's parser work
    (the deepseek_r1 reasoning split, then the hermes jail), and the
    number of deltas, on a scripted stream: a think block, an answer and
    a tool call cut into 4-character deltas (the random-weight engine's
    tokens carry almost no text under the mock tokenizer)."""
    from dynamo_tpu_torch.parsers import (
        JailedStream,
        make_reasoning_parser,
        make_tool_config,
    )

    text = (feature_text(96) + "</think>" + feature_text(96) + ' <tool_call>{"name": '
            '"get_weather", "arguments": {"city": "San Francisco"}}</tool_call>')
    deltas = [text[i:i + 4] for i in range(0, len(text), 4)]
    cfg = make_tool_config("hermes")
    t0 = time.perf_counter()
    for _ in range(reps):
        jail, reasoning = JailedStream(cfg), make_reasoning_parser("deepseek_r1")
        for text in deltas:
            _, content = reasoning.feed(text)
            if content:
                jail.feed(content)
        _, tail = reasoning.finish()
        jail.feed(tail)
        jail.finish()
    return 1e6 * (time.perf_counter() - t0) / (reps * len(deltas)), len(deltas)


def features_check(f: dict, L: int) -> int:
    """Phase 9's feature gates; returns their fused_decode launches."""
    deltas = []
    for (ps, plain), (fs, flat), (ss, streamed) in f["responses"]:
        require(ps == fs == ss == 200, f"responses: statuses {ps}, {fs}, {ss}: {flat}")
        text = plain["choices"][0]["message"]["content"]
        n_out = plain["usage"]["completion_tokens"]
        require(flat["object"] == "response" and flat["status"] == "completed"
                and flat["output"][0]["content"][0]["text"] == text
                and flat["usage"]["output_tokens"] == n_out
                and flat["usage"]["input_tokens"] == plain["usage"]["prompt_tokens"],
                f"/v1/responses {flat} against the chat completion {plain}")
        ev = responses_events(streamed)
        names = [e for e, _ in ev]
        rid = ev[0][1]["response"]["id"] if ev else None
        require(len(ev) >= 2 and names[0] == "response.created"
                and names[-1] == "response.completed"
                and set(names[1:-1]) <= {"response.output_text.delta"}
                and ev[0][1]["response"]["status"] == "in_progress"
                and all(d["item_id"] == rid for _, d in ev[1:-1])
                and ev[-1][1]["response"]["id"] == rid,
                f"/v1/responses stream events {names[:3]}...{names[-2:]}")
        d = [x["delta"] for _, x in ev[1:-1]]
        require("".join(d) == text
                and ev[-1][1]["response"]["usage"]["output_tokens"] == n_out,
                f"/v1/responses stream: text or usage differ from the chat completion: "
                f"{ev[-1]}")
        deltas += d
        f["lengths"].append((plain["usage"]["prompt_tokens"], n_out, len(d)))
    (ps, plain), (qs, parsed) = f["plain_chat"], f["parsed_chat"]
    require(ps == qs == 200, f"parsed chat: statuses {ps}, {qs}: {parsed}")
    want = plain["choices"][0]["message"]["content"]
    msg = parsed["choices"][0]["message"]
    # random weights write no </think> or <tool_call>: deepseek_r1 opens in
    # reasoning, so the whole text is reasoning_content and no call is parsed
    got = (msg.get("reasoning_content") or "") + (msg.get("content") or "")
    require(got == want and "tool_calls" not in msg
            and parsed["choices"][0]["finish_reason"] == plain["choices"][0]["finish_reason"]
            and parsed["usage"] == plain["usage"],
            f"parsed chat {parsed} against the same request without parsers {plain}")
    ss, body = f["parsed_stream"]
    ev = sse_events(body) if ss == 200 else []
    chunks = [e for e in ev[:-1] if isinstance(e, dict) and e.get("choices")]
    streamed = "".join((c["choices"][0]["delta"].get("reasoning_content") or "")
                       + (c["choices"][0]["delta"].get("content") or "") for c in chunks)
    require(ss == 200 and ev[-1] == "[DONE]" and streamed == want
            and not any("tool_calls" in c["choices"][0]["delta"] for c in chunks)
            and chunks[-1]["choices"][0]["finish_reason"]
            == plain["choices"][0]["finish_reason"],
            f"parsed chat stream: status {ss}, text equal {streamed == want}")
    (gs, schema), (ts, tool) = f["guided_schema"], f["guided_tool"]
    require(gs == ts == 200, f"guided chats: statuses {gs}, {ts}: {schema} {tool}")
    content = schema["choices"][0]["message"]["content"]
    doc = json.loads(content)
    require(schema["choices"][0]["finish_reason"] == "stop"
            and set(doc) == {"color", "name"} and doc["color"] in ("red", "green", "blue")
            and isinstance(doc["name"], str) and len(doc["name"]) <= 8,
            f"guided json_schema chat: {schema}")
    calls = tool["choices"][0]["message"].get("tool_calls") or []
    require(tool["choices"][0]["finish_reason"] == "tool_calls" and len(calls) == 1
            and calls[0]["function"]["name"] == "get_weather"
            and json.loads(calls[0]["function"]["arguments"])["city"] in ("Paris", "Oslo"),
            f"guided forced tool call: {tool}")
    counts, steps = f["counts"], f["steps"]
    require(counts["fused_decode"] == L * steps and steps > 0 and f["replays"] == steps,
            f"features: fused_decode launched {counts['fused_decode']} times over "
            f"{steps} decode steps ({f['replays']} graph replays)")
    print(f"serve http guided: json_schema chat {content!r} "
          f"({schema['usage']['completion_tokens']} tokens, stop); forced tool call "
          f"{calls[0]['function']['name']}({calls[0]['function']['arguments']}) "
          f"({tool['usage']['completion_tokens']} tokens, tool_calls)")
    us, n_chunks = jail_us_per_chunk()
    print(f"serve http features: /v1/responses non-streamed and streamed equal the chat "
          f"completion (text, output tokens) at (prompt tokens, output tokens, deltas) "
          f"{f['lengths']}; the tools chat through the hermes + deepseek_r1 card equals "
          f"the plain one (reasoning_content {len(msg.get('reasoning_content') or '')} "
          f"chars, content {len(msg.get('content') or '')} chars, finish "
          f"{parsed['choices'][0]['finish_reason']}, {parsed['usage']['completion_tokens']} "
          f"tokens), streamed too; text-bearing response deltas from the engine "
          f"{len(deltas)} (most random-weight tokens have no mock-tokenizer text); parser "
          f"host time {us:.2f} us per chunk over a scripted {n_chunks}-delta stream; "
          f"fused_decode launches {counts['fused_decode']} = {L} x {steps} steps")
    return counts["fused_decode"]


def cli_check(model: str, device: str | None = None) -> None:
    """Phase 10: ``python3 -m dynamo_tpu_torch.cli run --in http --out
    engine`` in a process of its own (random weights, graphs captured
    first) must print DYNAMO_HTTP=host:port and stream a chat completion
    of CLI_TOKENS tokens ending with data: [DONE]. The process is ended
    before this returns."""
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.cli", "run", "--in", "http", "--out",
           "engine", "--model", model, "--port", "0", "--precompile"]
    if device:
        cmd += ["--device", device]
    with cli_process(cmd) as (port, t_ready):
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


@contextlib.contextmanager
def cli_process(cmd, lines_out: list | None = None):
    """Run ``cmd`` (a ``cli run --in http`` command) in a process of its
    own until it prints DYNAMO_HTTP=host:port (within CLI_START_S); yields
    (port, seconds to ready) and ends the process (SIGTERM) on exit. With
    ``lines_out``, every line the process printed lands there."""
    import queue
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                              daemon=True)
    reader.start()
    seen: list[str] = []
    try:
        port = None
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
        yield port, time.perf_counter() - t0
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
        if lines_out is not None:
            reader.join(10)
            while not lines.empty():
                seen.append(lines.get())
            lines_out.extend(ln.rstrip("\n") for ln in seen)


# ------------------------------------------------------- processes over TCP

WORKER_BYTES = 22e9  # llama-3-8b bf16 weights 16.06 GB + 4.30 GB pool + graphs
PROC_START_S = 300  # a child's limit to print its ready line
PROC_EXIT_S = 60  # a child's limit to exit after SIGTERM
HEALTH_INTERVAL_S = 1.0  # the workers' canary period (--health-interval)
HEALTH_PERIODS = 3  # quarantine and readmission each within this many canary periods


class Child:
    """One ``python3 -m dynamo_tpu_torch.cli`` process (a fresh interpreter,
    never a fork of this CUDA process); its output lines land in a queue."""

    def __init__(self, *args):
        import queue
        import threading

        self.name = args[0]
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.cli", *args], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines: queue.Queue = queue.Queue()
        self.seen: list[str] = []
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
            self.lines.put(line.rstrip("\n"))
        self.lines.put(None)

    def wait_line(self, prefix: str, timeout: float) -> str:
        """The first line from here on that starts with ``prefix``."""
        import queue

        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            try:
                line = self.lines.get(timeout=0.2)
            except queue.Empty:
                continue
            if line is None:
                break
            self.seen.append(line)
            if line.startswith(prefix):
                return line
        require(False, f"{self.name}: no {prefix!r} line within {timeout} s (exit code "
                f"{self.proc.poll()}): {self.seen[-12:]}")

    def stop(self, timeout: float = PROC_EXIT_S) -> int:
        """SIGTERM, then the exit code; a child past its deadline fails."""
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(30)
            require(False, f"{self.name} did not exit within {timeout} s of SIGTERM")

    def logged(self, prefix: str) -> str | None:
        """A line already read, or still queued, that starts with ``prefix``."""
        while True:
            line = self.lines.get_nowait() if not self.lines.empty() else None
            if line is None:
                break
            self.seen.append(line)
        return next((ln for ln in self.seen if ln.startswith(prefix)), None)


def process_phase(spec, cfg, prompts, default_tokens, http_stats, device=None) -> int:
    """Phase 11: the port as a deployment of processes over TCP. ``cli hub``,
    two ``cli worker --precompile`` on the phase-1 EngineConfig values (the
    same seeded weights) started together, ``cli frontend``; the 8 prompts
    as concurrent streamed token-id completions through the frontend, and
    once more through the hub-discovered TCP data plane from this process
    (their token ids, held near-argmax under the reference forward once the
    workers are gone); one more stream whose worker is SIGTERM'd after its
    5th chunk (the stream finishes, the worker drains and exits 0, its
    instance key leaves the hub, the survivor serves the next request); the
    8 prompts through the frontend again after the TCP set, and to the
    survivor alone; then every child
    SIGTERM'd within its deadline. Returns the workers'
    fused_decode launches, which must be 32 per logged step."""

    from dynamo_tpu_torch.frontend.tokenizer import MockTokenizer
    from dynamo_tpu_torch.models.family import get_family

    import gc

    name, n = spec.name, len(prompts)
    # the engines of phases 1-10 are closed and dropped; reference cycles
    # (an engine and its served handlers) still hold their weights until a
    # collection runs
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info() if DEVICE == "cuda" else (0, 0)
    held = torch.cuda.memory_allocated()
    print(f"processes: card memory free {free / 1e9:.2f} of {total / 1e9:.2f} GB before "
          f"spawning (this process: {held / 1e9:.3f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved)")
    # what is left is neither an engine's weights (16 GB) nor its pools
    # (4.3 GB): name the largest live tensors
    live = sorted((t for t in gc.get_objects()
                   if isinstance(t, torch.Tensor) and t.device.type == "cuda"),
                  key=lambda t: -t.untyped_storage().nbytes())[:3]
    print("processes: largest tensors this process holds: " + (", ".join(
        f"{tuple(t.shape)} {t.dtype} ({t.untyped_storage().nbytes() / 1e9:.3f} GB)"
        for t in live) or "none"))
    require(held < 2e9, f"this process still holds {held / 1e9:.3f} GB of tensors")
    require(DEVICE != "cuda" or free >= 2 * WORKER_BYTES,
            f"room for two workers: {free / 1e9:.2f} GB free, {2 * WORKER_BYTES / 1e9:.0f} "
            "GB needed")
    dev = ["--device", device] if device else []
    flags = ["--page-size", str(cfg["page_size"]), "--num-pages", str(cfg["num_pages"]),
             "--max-pages-per-seq", str(cfg["max_pages_per_seq"]),
             "--max-decode-slots", str(cfg["max_decode_slots"])]
    children: list[Child] = []
    t0 = time.perf_counter()
    try:
        hub_proc = Child("hub", "--port", "0")
        children.append(hub_proc)
        hub = hub_proc.wait_line("DYNAMO_HUB=", 60).split("=", 1)[1]
        workers = [Child("worker", "--hub", hub, "--model", name, "--precompile",
                         "--health-port", "0", "--health-interval", str(HEALTH_INTERVAL_S),
                         "--tool-call-parser", "hermes", "--reasoning-parser",
                         "deepseek_r1", *flags, *dev) for _ in range(2)]
        children += workers
        front = Child("frontend", "--hub", hub, "--port", "0", "--host", "127.0.0.1")
        children.append(front)
        port = int(front.wait_line("DYNAMO_HTTP=", 60).rsplit(":", 1)[1])
        for w in workers:
            w.status_port = int(w.wait_line("SYSTEM_STATUS_PORT=", PROC_START_S)
                                .split("=", 1)[1])
            w.wait_line("ENGINE_READY", PROC_START_S)
            line = next(ln for ln in w.seen if "engine worker " in ln)
            w.lease = int(re.search(r"engine worker ([0-9a-f]+) up", line).group(1), 16) >> 16
        t_ready = time.perf_counter() - t0
        out = asyncio.run(_drive_processes(spec, prompts, hub, port, workers, front))
        for child in (out["survivor"], front, hub_proc):
            require(child.stop() == 0, f"{child.name} exited non-zero: {child.seen[-8:]}")
    finally:
        for child in children:
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait(30)

    # kernel launches, from each worker's log line
    logs = [json.loads(w.logged("ENGINE_LAUNCHES ").split(" ", 1)[1]) for w in workers]
    fused = sum(x["launches"].get("fused_decode_attention", 0) for x in logs)
    steps = sum(x["steps"] for x in logs)
    L = spec.num_layers
    require(all(x["steps"] > 0 for x in logs), f"a worker served no decode step: {logs}")
    require(DEVICE != "cuda" or (fused == L * steps and all(
        x["replays"] == x["steps"] for x in logs)),
        f"processes: fused_decode launched {fused} times over {steps} logged steps {logs}")
    require(all(x["launches"].get(k, 0) == 0 for x in logs for k in (
        "kv_write", "paged_decode_attention_v3", "fused_decode_attention/fp8")),
        f"processes: a worker launched another kernel form: {logs}")

    status, body, _ = out["guided"]
    guided = json.loads(body) if status == 200 else {}
    text = guided["choices"][0]["text"] if guided else ""
    require(status == 200 and guided["choices"][0]["finish_reason"] == "stop"
            and re.fullmatch(r"[ \n\t\r]{0,3}" + GUIDED_REGEX + r"[ \n\t\r]{0,3}", text),
            f"processes: guided completion {status} {body[:300]!r}")
    print(f"processes: guided regex completion through the frontend process: {text!r} "
          f"({guided['usage']['completion_tokens']} tokens, stop)")

    # every stream through the frontend: both workers, then the survivor
    tok = MockTokenizer()

    def frontend_set(streams, label):
        ttft, texts = [], []
        for i, (status, body, times) in enumerate(streams):
            ev = sse_events(body) if status == 200 else []
            chunks = [e for e in ev[:-1] if e.get("choices")]
            usage = ev[-2].get("usage") if len(ev) >= 2 else None
            require(status == 200 and ev[-1] == "[DONE]" and chunks
                    and chunks[-1]["choices"][0]["finish_reason"] == "length"
                    and usage and usage["completion_tokens"] == SERVE_TOKENS
                    and usage["prompt_tokens"] == len(prompts[i]),
                    f"processes {label} stream {i}: status {status}, last events {ev[-3:]}")
            ttft.append(times[0])
            texts.append("".join(c["choices"][0]["text"] for c in chunks))
        return ttft, texts

    ttft, texts = frontend_set(out["streams"], "two-worker")
    again_ttft, _ = frontend_set(out["again"], "two-worker repeat")
    solo_ttft, solo_texts = frontend_set(out["solo"], "survivor")
    for label in ("drained", "after"):
        status, body, _ = out[label]
        ev = sse_events(body) if status == 200 else []
        usage = ev[-2].get("usage") if len(ev) >= 2 else None
        require(status == 200 and ev[-1] == "[DONE]" and usage
                and usage["completion_tokens"] == SERVE_TOKENS,
                f"processes {label} stream: status {status}, last events {ev[-3:]}")
    tcp_tokens = out["tcp"]
    require(all(len(t) == SERVE_TOKENS for t in tcp_tokens),
            f"processes: TCP data-plane streams of {[len(t) for t in tcp_tokens]} tokens")

    # the TCP streams' tokens under the reference forward, on the same seeded
    # weights drawn here now that the workers are gone
    params = get_family(spec).init_params(spec, 0, device=DEVICE)
    checks = [near_argmax_check(spec, params, prompts[i], tcp_tokens[i]) for i in range(n)]
    prefix_family_report(out["prefix"],
                         lambda p, t: near_argmax_check(spec, params, p, t))
    del params
    torch.cuda.empty_cache()

    # the stdlib codec's host cost for one coalesced frame of a decode step
    from dynamo_tpu_torch.runtime import codec

    frame = {"kind": "data", "ch": 3, "payloads": [{"token_ids": [int(t)]} for t in
                                                   tcp_tokens[0][:8]]}
    body = codec.packb(frame)
    reps = 2000
    t_pack = time.perf_counter()
    for _ in range(reps):
        codec.packb(frame)
    t_unpack = time.perf_counter()
    for _ in range(reps):
        codec.unpackb(body)
    t_end = time.perf_counter()
    pack_us, unpack_us = 1e6 * (t_unpack - t_pack) / reps, 1e6 * (t_end - t_unpack) / reps

    n_tok = n * SERVE_TOKENS
    same_default = sum(tcp_tokens[i] == default_tokens[i] for i in range(n))
    # the OpenAI streams carry text, not token ids: under the mock tokenizer
    # only ids 16..271 have text, so these texts check the few tokens that do
    decoded = [tok.decode(t) for t in tcp_tokens]
    same_text = sum(texts[i] == decoded[i] for i in range(n))
    same_solo = sum(solo_texts[i] == decoded[i] for i in range(n))
    with_text = sum(16 <= t < 272 for ts in tcp_tokens for t in ts)
    require(same_text == n, f"processes: {same_text}/{n} frontend texts equal the decoded "
            "tokens of the same prompts over the TCP data plane")
    print(f"processes: hub, 2 workers ({name}, --precompile) and frontend ready in "
          f"{t_ready:.1f} s; both workers served ({out['served']})")

    def rates(label, wall, ttft_mean, ttft_max):
        return (f"{label}: {wall:.3f} s = {n_tok / wall:.1f} tok/s, client TTFT mean "
                f"{1e3 * ttft_mean:.1f} ms, max {1e3 * ttft_max:.1f} ms")

    print(f"processes: {n} concurrent streams x {SERVE_TOKENS} tokens, each set on cleared "
          "prefix caches; " + "; ".join([
              rates("phase 9 (one process, one engine, HTTP)", n_tok / http_stats["tok_s"],
                    http_stats["ttft_mean"], http_stats["ttft_max"]),
              rates("frontend -> 2 worker processes (their first traffic)", out["wall"],
                    sum(ttft) / n, max(ttft)),
              rates("this process -> 2 worker processes over the TCP data plane "
                    "(no frontend)", out["tcp_wall"], sum(out["tcp_ttft"]) / n,
                    max(out["tcp_ttft"])),
              rates("frontend -> 2 worker processes again", out["again_wall"],
                    sum(again_ttft) / n, max(again_ttft)),
              rates("frontend -> 1 worker process (the survivor)", out["solo_wall"],
                    sum(solo_ttft) / n, max(solo_ttft))]))
    print(f"processes: the {n} prompts over the TCP data plane from this process: "
          f"{same_default}/{n} token streams equal the default serve's; near-argmax worst "
          f"gap {max(g for _, g in checks):.3f}, exact agreement min "
          f"{min(a for a, _ in checks):.3f}; frontend texts equal to their decoded tokens: "
          f"two workers {same_text}/{n} (required), survivor {same_solo}/{n} ({with_text} of "
          f"{n_tok} tokens have text under the mock tokenizer)")
    print(f"processes: drain: the SIGTERM'd worker had {out['drain_inflight']} request in "
          f"flight, exited 0 after {out['drain_s']:.2f} s with '{out['drained_line']}', its "
          f"instance key left the hub ({out['left']} generate instance left), the next "
          f"completion went to the survivor; fused_decode launches {fused} = {L} x {steps} "
          f"steps over both workers ({[x['steps'] for x in logs]} steps, replays "
          f"{[x['replays'] for x in logs]})")
    h = out["health"]
    print(f"processes: health (--health-interval {HEALTH_INTERVAL_S:g} s, hermes + "
          f"deepseek_r1 cards): /ready 200 on both workers; canary latency (median of 5, "
          f"ms) A {1e3 * h['latency'][0]:.2f}, B {1e3 * h['latency'][1]:.2f}; "
          f"health.canary:corrupt armed on A through its admin faults op: quarantined "
          f"after {h['quarantine_s']:.3f} s (reason=\"sdc\" on its /metrics, /ready 503), "
          f"the next 4 completions all on B ({h['routed']}), readmitted "
          f"{h['readmit_s']:.3f} s after the spec was cleared (limit {h['limit_s']:.3f} s "
          f"= {HEALTH_PERIODS} canary periods + 0.25 s); A ran {h['probes']} canaries, each a "
          f"one-token prefill with no decode step (0 fused_decode launches)")
    print(f"processes: codec host time per coalesced frame of 8 token items "
          f"({len(body)} bytes): pack {pack_us:.2f} us, unpack {unpack_us:.2f} us")
    return fused


async def _drive_processes(spec, prompts, hub, port, workers, front):
    """Phase 11's traffic, on this process's own loop."""
    import signal

    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub_client import RemoteHub
    from dynamo_tpu_torch.runtime.push import PushRouter, RouterMode

    name = spec.name
    prefix = "v1/instances/dynamo/backend/generate/"
    drt = DistributedRuntime(await RemoteHub.connect(hub), RuntimeConfig(hub_address=hub))
    out: dict = {}
    try:
        t0 = time.perf_counter()
        while True:
            status, body, _ = await http_call(port, "GET", "/v1/models")
            listed = [m["id"] for m in json.loads(body)["data"]] if status == 200 else []
            keys = await drt.hub.get_prefix(prefix)
            if listed == [name] and len(keys) == 2:
                break
            require(time.perf_counter() - t0 < 30,
                    f"processes: /v1/models {listed}, {len(keys)} generate instances")
            await asyncio.sleep(0.1)
        admin = await drt.namespace("dynamo").component("backend").endpoint(
            "admin").client().start()
        await admin.wait_for_instances(2, timeout=10)

        async def cache_status():
            out = {}
            for iid in admin.instance_ids():
                async for item in admin.call_instance(iid, {"op": "cache_status"},
                                                      Context()):
                    out[iid] = item
            return out

        async def clear_caches():
            # every timed set starts on cleared prefix caches, as phase 9's
            for iid in admin.instance_ids():
                async for _ in admin.call_instance(iid, {"op": "clear_kv_blocks"},
                                                   Context()):
                    pass
            t_clear = time.perf_counter()
            while any(s["cached_pages"] for s in (await cache_status()).values()):
                require(time.perf_counter() - t_clear < 5,
                        "processes: the prefix caches were not cleared")
                await asyncio.sleep(0.01)

        async def frontend_streams():
            t = time.perf_counter()
            streams = await asyncio.gather(*(http_call(port, "POST", "/v1/completions", {
                "model": name, "prompt": p, "max_tokens": SERVE_TOKENS,
                "ignore_eos": True, "stream": True,
                "stream_options": {"include_usage": True}}) for p in prompts))
            return streams, time.perf_counter() - t

        await clear_caches()
        out["streams"], out["wall"] = await frontend_streams()
        served = await cache_status()
        out["served"] = ", ".join(f"{s['cached_pages']} cached pages" for s in served.values())
        require(len(served) == 2 and all(s["cached_pages"] > 0 for s in served.values()),
                f"processes: not both workers served: {served}")

        # the same prompts over the TCP data plane, round robin, from here
        router = await PushRouter.from_endpoint(
            drt.namespace("dynamo").component("backend").endpoint("generate"),
            RouterMode.ROUND_ROBIN)
        await router.client.wait_for_instances(2, timeout=10)

        async def tcp_one(p):
            toks, first = [], None
            async for item in router.generate(make_request(p), Context()):
                if first is None:
                    first = time.perf_counter() - t_tcp
                toks += item["token_ids"]
            return toks, first

        await clear_caches()
        t_tcp = time.perf_counter()
        tcp = await asyncio.gather(*(tcp_one(p) for p in prompts))
        out["tcp_wall"] = time.perf_counter() - t_tcp
        out["tcp"], out["tcp_ttft"] = [t for t, _ in tcp], [f for _, f in tcp]
        await router.client.close()
        # the frontend set again, now that both workers have served traffic
        await clear_caches()
        out["again"], out["again_wall"] = await frontend_streams()
        # one guided completion: the frontend lowers the regex, the wire
        # carries it, a worker process compiles it against its vocabulary
        out["guided"] = await http_call(port, "POST", "/v1/completions", {
            "model": name, "prompt": "code:", "max_tokens": GUIDED_TOKENS,
            "nvext": {"guided_regex": GUIDED_REGEX}})
        # prefix families through this process's own KV router, then the
        # same waves round robin, each on cleared caches
        out["prefix"] = await _prefix_family_set(drt, spec, clear_caches)
        # health: readiness, canary latency, SDC quarantine and readmission
        out["health"] = await _health_set(drt, workers, admin, cache_status,
                                          clear_caches, port, name, prompts)

        # SIGTERM drain of the worker serving one more stream
        victim = {}

        async def on_chunk(k):
            if k != 5:
                return
            busy = [iid for iid, st in (await cache_status()).items() if st["active_pages"]]
            require(len(busy) == 1, f"processes: {len(busy)} workers hold the stream")
            w = next(w for w in workers if w.lease == busy[0] >> 16)
            victim["w"], victim["t"] = w, time.perf_counter()
            w.proc.send_signal(signal.SIGTERM)

        out["drained"] = await http_call(port, "POST", "/v1/completions", {
            "model": name, "prompt": prompts[4], "max_tokens": SERVE_TOKENS,
            "ignore_eos": True, "stream": True, "stream_options": {"include_usage": True}},
            on_chunk=on_chunk)
        w = victim.get("w")
        require(w is not None, "processes: the drained stream ended before its 5th chunk")
        code = await asyncio.to_thread(w.stop)
        out["drain_s"] = time.perf_counter() - victim["t"]
        line = w.logged("ENGINE_DRAINED ")
        require(code == 0 and line == "ENGINE_DRAINED leftover=0",
                f"processes: drained worker exit {code}, line {line!r}: {w.seen[-8:]}")
        out["drained_line"] = line
        m = re.search(r"graceful drain \((\d+) in flight",
                      next((ln for ln in w.seen if "graceful drain" in ln), ""))
        out["drain_inflight"] = int(m.group(1)) if m else None
        require(out["drain_inflight"] == 1,
                f"processes: the worker drained {out['drain_inflight']} requests, not 1")
        keys = await drt.hub.get_prefix(prefix)
        out["left"] = len(keys)
        require(len(keys) == 1 and all(int(k.rsplit("/", 1)[1], 16) >> 16 != w.lease
                                       for k in keys),
                f"processes: the drained worker's key is still in the hub: {list(keys)}")
        survivor = next(x for x in workers if x is not w)
        out["survivor"] = survivor
        before = await cache_status()
        out["after"] = await http_call(port, "POST", "/v1/completions", {
            "model": name, "prompt": prompts[5], "max_tokens": SERVE_TOKENS,
            "ignore_eos": True, "stream": True, "stream_options": {"include_usage": True}})
        after = await cache_status()
        require(list(after) == list(before) and len(after) == 1
                and next(iter(after)) >> 16 == survivor.lease,
                f"processes: the next completion's worker: {before} -> {after}")
        # the 8 streams once more through the frontend, all on the survivor:
        # one worker process at phase 9's batch, behind the same TCP hops
        await clear_caches()
        out["solo"], out["solo_wall"] = await frontend_streams()
        await admin.close()
    finally:
        await drt.close()
    return out



async def _health_set(drt, workers, admin, cache_status, clear_caches, port, name,
                      prompts) -> dict:
    """Phase 11's health set: both workers' status servers answer /ready
    200; each worker's canary latency through its TCP endpoint (the health
    manager's own canary call, from here); the admin faults op arms
    health.canary:corrupt scoped to worker A's fault identity: A must be
    quarantined within HEALTH_PERIODS canary periods, show reason="sdc" on
    its /metrics and /ready 503, and the next 4 completions through the
    frontend must all go to B; clearing the spec must readmit A within
    HEALTH_PERIODS canary periods (readmission takes 3 clean canaries)."""
    from types import SimpleNamespace

    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.health import (
        DEFAULT_CANARY,
        HealthCheckManager,
        is_quarantined,
    )

    async def status(w, path):
        st, body, _ = await http_call(w.status_port, "GET", path)
        return st, body.decode()

    async def until(cond, what, limit_s):
        t = time.perf_counter()
        while not await cond():
            require(time.perf_counter() - t < limit_s, f"processes health: {what} not "
                    f"within {limit_s:.2f} s")
            await asyncio.sleep(0.01)
        return time.perf_counter() - t

    async def ready(w):
        return (await status(w, "/ready"))[0] == 200

    async def ready_all():
        return [await ready(w) for w in workers] == [True, True]

    await until(ready_all, "/ready 200 on both workers", 10 * HEALTH_INTERVAL_S)
    gen = await drt.namespace("dynamo").component("backend").endpoint(
        "generate").client().start()
    res: dict = {}
    try:
        await gen.wait_for_instances(2, timeout=10)
        insts = {i.instance_id >> 16: i for i in gen.instances()}
        probe = HealthCheckManager(drt)
        res["latency"] = []
        for w in workers:
            served = SimpleNamespace(instance=insts[w.lease])
            times = []
            for _ in range(5):
                t = time.perf_counter()
                toks = await probe._canary(served, dict(DEFAULT_CANARY))
                times.append(time.perf_counter() - t)
                require(len(toks) == 1, f"processes health: canary answered {toks}")
            res["latency"].append(sorted(times)[2])
        # a period is the sleep plus one canary; the slack covers the card's
        # put through the hub and this poll's 10 ms step
        limit = HEALTH_PERIODS * (HEALTH_INTERVAL_S + max(res["latency"])) + 0.25
        res["limit_s"] = limit
        a, b = workers
        a_inst = insts[a.lease]
        (a_admin,) = [i for i in admin.instance_ids() if i >> 16 == a.lease]

        async def faults(spec):
            async for item in admin.call_instance(a_admin, {"op": "faults", "spec": spec},
                                                  Context()):
                return item

        async def a_quarantined():
            return is_quarantined(await drt.hub.get(a_inst.path))

        key = HealthCheckManager._fault_key(a_inst)
        armed = await faults(f"health.canary:corrupt~{key}")
        require(armed["ok"] and armed["rules"] == [f"health.canary:corrupt~{key}"],
                f"processes health: faults op answered {armed}")
        res["quarantine_s"] = await until(a_quarantined, "worker A quarantined", limit)
        st, metrics = await status(a, "/metrics")
        require(st == 200 and 'dynamo_worker_quarantines_total{reason="sdc"} 1' in metrics,
                "processes health: worker A's /metrics shows no sdc quarantine")
        require((await status(a, "/ready"))[0] == 503 and (await status(b, "/ready"))[0]
                == 200, "processes health: /ready of the quarantined worker is not 503")
        async def watched():  # this process's copy of A's card is flagged
            return any(i.instance_id == a_inst.instance_id and is_quarantined(i)
                       for i in gen.instances())

        await until(watched, "the quarantined card watched", 5)
        await asyncio.sleep(0.2)  # the frontend's watch of the same put
        await clear_caches()
        for p in prompts[:4]:
            st, body, _ = await http_call(port, "POST", "/v1/completions", {
                "model": name, "prompt": p, "max_tokens": 8, "ignore_eos": True})
            require(st == 200 and json.loads(body)["usage"]["completion_tokens"] == 8,
                    f"processes health: a completion during the quarantine: {st} {body}")
        served = await cache_status()
        by_worker = {iid >> 16: s["cached_pages"] for iid, s in served.items()}
        res["routed"] = f"cached pages A {by_worker[a.lease]}, B {by_worker[b.lease]}"
        require(by_worker[a.lease] == 0 and by_worker[b.lease] > 0,
                f"processes health: routed during A's quarantine: {res['routed']}")
        cleared = await faults("")
        require(cleared["ok"] and cleared["rules"] == [], f"faults op answered {cleared}")

        async def a_admitted():
            return not await a_quarantined()

        res["readmit_s"] = await until(a_admitted, "worker A readmitted", limit)
        await until(lambda: ready(a), "worker A /ready 200", 5)
        res["probes"] = json.loads((await status(a, "/health"))[1])["endpoints"][0]["probes"]
    finally:
        await gen.close()
    return res


async def _prefix_family_set(drt, spec, clear_caches) -> dict:
    """Phase 11's prefix-family set on the two workers, from this process:
    a KvPushRouter over a direct PushRouter and a KvRouter fed by the
    workers' KV events and load through the TCP hub. Wave 1 sends the
    FAMILIES heads concurrently; once the router's radix holds each head's
    prompt blocks (as compute_sequence_hashes computes them here) under the
    worker that served it, and both workers' published load is idle, wave 2
    sends the followers concurrently. Then a cleared cache must empty the
    radix (the workers' removed events). The same two waves once more
    through a round-robin PushRouter, followers in a seeded shuffled order.
    Returns the per-request workers, overlaps, TTFTs, event lags and pick
    times; the gates are in process_phase."""
    from dynamo_tpu_torch.kv_router import router as router_mod
    from dynamo_tpu_torch.kv_router.protocols import RouterConfig
    from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouter
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.push import PushRouter, RouterMode
    from dynamo_tpu_torch.tokens import compute_sequence_hashes

    page = 16
    rng = np.random.default_rng(FAMILY_SEED)
    heads, followers = [], []
    for _ in range(FAMILIES):
        prefix = rng.integers(3, spec.vocab_size, FAMILY_PREFIX).tolist()
        heads.append(prefix + rng.integers(3, spec.vocab_size, FAMILY_TAIL).tolist())
        followers.append(prefix + rng.integers(3, spec.vocab_size, FAMILY_TAIL).tolist())
    endpoint = drt.namespace("dynamo").component("backend").endpoint("generate")
    push = await PushRouter.from_endpoint(endpoint, RouterMode.DIRECT)
    await push.client.wait_for_instances(2, timeout=10)
    kv = await KvRouter(drt.hub, "dynamo/backend", RouterConfig(block_size=page)).start()
    res: dict = {"heads": heads, "followers": followers}
    picked: dict[int, tuple[int, int]] = {}  # id(request tokens) -> (worker, overlap)
    inner = push.generate

    def spy(request, context, *, instance_id=None):
        picked[id(request["token_ids"])] = (instance_id,
                                            request["estimated_prefix_hit_num_blocks"])
        return inner(request, context, instance_id=instance_id)

    push.generate = spy
    kvp = KvPushRouter(push, kv)
    # per-pick phase times: deltas of the router's own totals around each pick
    per_pick: list[dict] = []
    pick = kv.find_best_match

    def timed_pick(*a, **kw):
        before = dict(kv.pick_phase_totals)
        out = pick(*a, **kw)
        per_pick.append({k: kv.pick_phase_totals[k] - before[k] for k in before})
        return out

    kv.find_best_match = timed_pick
    phases = {"hash": router_mod._PH_HASH, "overlap": router_mod._PH_OVERLAP,
              "select": router_mod._PH_SELECT}
    sums0 = {k: h.sum for k, h in phases.items()}

    async def wave(prompts, route):
        """Each prompt's tokens, TTFT from the wave's start, and the host
        clock at its first and last token."""
        t0 = time.perf_counter()

        async def one(p):
            r = {"tokens": [], "first_at": None}
            async for item in route(make_request(p), Context()):
                if r["first_at"] is None and item["token_ids"]:
                    r["first_at"] = time.perf_counter()
                r["tokens"] += item["token_ids"]
            r["end_at"] = time.perf_counter()
            r["ttft"] = r["first_at"] - t0
            return r

        return await asyncio.gather(*(one(p) for p in prompts))

    def idle() -> bool:
        states = {s.worker_id: s.metrics for s in kv.scheduler.workers()}
        return len(states) == 2 and all(m.active_kv_blocks == 0 and m.running_requests == 0
                                        for m in states.values())

    async def radix_settles(cond) -> float:
        t = time.perf_counter()
        while not cond():
            require(time.perf_counter() - t < EVENT_DEADLINE_S,
                    "processes prefix set: the router's radix and load did not settle "
                    f"within {EVENT_DEADLINE_S} s: {kv.tree.num_blocks()} blocks")
            await asyncio.sleep(0.001)
        return time.perf_counter()

    try:
        await clear_caches()
        await radix_settles(lambda: kv.tree.num_blocks() == 0 and idle())
        head_hashes = [compute_sequence_hashes(h, page) for h in heads]

        def held(i: int) -> bool:
            w = picked.get(id(heads[i]), (None,))[0]
            hs = head_hashes[i]
            return w is not None and kv.tree.find_matches(
                hs, touch=False).scores.get(w) == len(hs)

        # the host clock at which each head's prompt blocks first stand in
        # the radix under its worker, polled while wave 1 runs
        seen: dict[int, float] = {}

        async def watch_radix():
            while len(seen) < FAMILIES:
                for i in range(FAMILIES):
                    if i not in seen and held(i):
                        seen[i] = time.perf_counter()
                await asyncio.sleep(0.001)

        watcher = asyncio.ensure_future(watch_radix())
        try:
            w1 = await wave(heads, kvp.generate)
            res["head_workers"] = [picked[id(h)][0] for h in heads]
            await radix_settles(lambda: all(held(i) for i in range(FAMILIES)))
            await asyncio.wait_for(watcher, EVENT_DEADLINE_S)
        finally:
            watcher.cancel()
        # the prompt blocks seal at prefill: from a head's first token (its
        # prefill is done) and from its last token (all its traffic is done)
        res["event_lag_first_s"] = [seen[i] - w1[i]["first_at"] for i in range(FAMILIES)]
        res["event_lag_s"] = [seen[i] - w1[i]["end_at"] for i in range(FAMILIES)]
        await radix_settles(idle)
        res["held_blocks"] = [len(hs) for hs in head_hashes]
        w2 = await wave(followers, kvp.generate)
        res["follower_picks"] = [picked[id(f)] for f in followers]
        res["head_ttft"] = [r["ttft"] for r in w1]
        res["follower_ttft"] = [r["ttft"] for r in w2]
        res["head_tokens"] = [r["tokens"] for r in w1]
        res["follower_tokens"] = [r["tokens"] for r in w2]
        res["pick_mean_us"] = {k: 1e6 * (h.sum - sums0[k]) / max(len(per_pick), 1)
                               for k, h in phases.items()}
        res["pick_max_us"] = {k: 1e6 * max(p[k] for p in per_pick) for k in phases}
        res["picks"] = len(per_pick)
        # the removed events of a cleared cache empty the radix
        await clear_caches()
        t_clear = time.perf_counter()
        wids = sorted(set(res["head_workers"]) | {w for w, _ in res["follower_picks"]})
        await radix_settles(lambda: all(kv.tree.num_blocks(w) == 0 for w in wids))
        res["clear_lag_s"] = time.perf_counter() - t_clear
        res["after_clear"] = {w: kv.tree.num_blocks(w) for w in push.client.instance_ids()}

        # the same waves round robin, followers in a seeded shuffled order
        rr = PushRouter(push.client, RouterMode.ROUND_ROBIN)
        served: dict[int, int] = {}

        def rr_route(request, context):
            target = rr.select()
            served[id(request["token_ids"])] = target
            return rr.generate(request, context, instance_id=target)

        order = np.random.default_rng(FAMILY_SEED + 2).permutation(FAMILIES).tolist()
        await radix_settles(idle)
        r1 = await wave(heads, rr_route)
        await radix_settles(idle)
        r2 = await wave([followers[i] for i in order], rr_route)
        rr_heads = [served[id(h)] for h in heads]
        res["rr_hits"] = [served[id(followers[i])] == rr_heads[i] for i in order]
        res["rr_order"] = order
        res["rr_head_ttft"] = [r["ttft"] for r in r1]
        res["rr_follower_ttft"] = [r["ttft"] for r in r2]
        await clear_caches()
    finally:
        await kv.close()
        await push.client.close()
    return res


def prefix_family_report(res: dict, fused_check) -> None:
    """Phase 11's prefix-family gates and lines: the radix held each head's
    prompt hashes under its worker; every follower on its head's worker with
    the prefix's page count as its overlap; one follower near-argmax
    (``fused_check(prompt, tokens)``); the cleared caches' removed events
    emptied the radix. Timings are printed, never gated."""
    import hashlib

    from dynamo_tpu_torch.kv_router.hashing import PrefixHashCache
    from dynamo_tpu_torch.tokens import block_hash, chain_hash, compute_sequence_hashes
    from dynamo_tpu_torch.xxh3 import xxh3_64

    n = FAMILIES
    prefix_pages = FAMILY_PREFIX // 16
    on_head = [w == h for (w, _), h in zip(res["follower_picks"], res["head_workers"])]
    overlaps = [o for _, o in res["follower_picks"]]
    require(sum(on_head) == n and all(o == prefix_pages for o in overlaps),
            f"processes prefix set: followers on their head's worker {on_head}, overlap "
            f"blocks {overlaps} (want {prefix_pages} each)")
    require(all(len(t) == SERVE_TOKENS for t in res["head_tokens"] + res["follower_tokens"]),
            "processes prefix set: a stream ended short")
    require(all(v == 0 for v in res["after_clear"].values()),
            f"processes prefix set: the radix after the clear holds {res['after_clear']}")
    agree, gap = fused_check(res["followers"][0], res["follower_tokens"][0])

    # host cost of the hashes this slice puts on the step thread and the router
    rng = np.random.default_rng(0)
    block = rng.integers(0, 128_256, 16).tolist()
    data = np.asarray(block, np.uint32).tobytes()
    reps = 2000

    def per_call_us(fn) -> float:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e6 * (time.perf_counter() - t) / reps

    xx_block = per_call_us(lambda: block_hash(block))
    xx_link = per_call_us(lambda: chain_hash(0x1234, 0x5678))
    b2_block = per_call_us(lambda: hashlib.blake2b(data, digest_size=8).digest())
    b2_link = per_call_us(lambda: hashlib.blake2b(data[:16], digest_size=8).digest())
    prompt = res["followers"][0]
    direct = per_call_us(lambda: compute_sequence_hashes(prompt, 16))
    cache = PrefixHashCache()
    cache.sequence_hashes(prompt, 16)
    cached = per_call_us(lambda: cache.sequence_hashes(prompt, 16))
    cold = per_call_us(lambda: PrefixHashCache().sequence_hashes(prompt, 16))
    # the reference cache's key: one seeded xxh3 of a 4-block chunk (256
    # bytes), against chaining those four blocks directly
    chunk = np.asarray(prompt[:64], np.uint32).tobytes()
    digest = per_call_us(lambda: xxh3_64(chunk, 16))
    chain4 = per_call_us(lambda: compute_sequence_hashes(prompt[:64], 16))

    def ms(xs):
        return f"mean {1e3 * sum(xs) / len(xs):.1f} ms, max {1e3 * max(xs):.1f} ms"

    pm, px = res["pick_mean_us"], res["pick_max_us"]
    print(f"processes prefix set: {n} families ({FAMILY_PREFIX}-token prefix = "
          f"{prefix_pages} pages, {FAMILY_TAIL}-token tails, greedy, {SERVE_TOKENS} tokens) "
          f"through this process's KvRouter: heads on workers "
          f"{[hex(w) for w in res['head_workers']]}; radix held each head's "
          f"{res['held_blocks'][0]} prompt hashes (computed here) under its worker; "
          f"followers on their head's worker {sum(on_head)}/{n}, overlap blocks {overlaps}; "
          f"follower 0 near-argmax worst gap {gap:.3f}, exact agreement {agree:.3f}; "
          f"radix after the clear {res['after_clear']}")
    print(f"processes prefix set: TTFT heads {ms(res['head_ttft'])}, followers "
          f"{ms(res['follower_ttft'])}; event lag, a head's prompt blocks into the radix "
          f"under its worker, from its first token {ms(res['event_lag_first_s'])}, from "
          f"its last token {ms(res['event_lag_s'])} (negative: in before it); clear to an "
          f"empty radix {1e3 * res['clear_lag_s']:.1f} ms")
    print("processes prefix set: router pick over " + str(res["picks"]) + " picks, us "
          + ", ".join(f"{k} mean {pm[k]:.1f} max {px[k]:.1f}" for k in pm)
          + " (means from router_pick_seconds)")
    print(f"processes prefix set: host hash cost per call, us: xxh3 16-token block "
          f"{xx_block:.2f} (blake2b {b2_block:.2f}), chain link {xx_link:.2f} (blake2b "
          f"{b2_link:.2f}); a {len(prompt)}-token prompt's sequence hashes direct "
          f"{direct:.1f}, PrefixHashCache cold {cold:.1f}, warm {cached:.1f}; a 4-block "
          f"chunk's seeded 256-byte xxh3 digest (the reference cache's key) {digest:.1f} "
          f"against chaining its 4 blocks {chain4:.1f}")
    print(f"processes prefix set: round robin on cleared caches (followers in the seeded "
          f"order {res['rr_order']}): followers on their head's "
          f"worker {sum(res['rr_hits'])}/{n} ({res['rr_hits']}); TTFT heads "
          f"{ms(res['rr_head_ttft'])}, followers {ms(res['rr_follower_ttft'])}")


# ------------------------------------------------ MoE and checkpoints


def gpt_oss_spec():
    """gpt-oss-120b at full width, MOE_LAYERS layers deep."""
    import dataclasses

    from dynamo_tpu_torch.engine.config import ModelSpec

    full = ModelSpec.gpt_oss_120b()
    return dataclasses.replace(full, num_layers=MOE_LAYERS,
                               layer_types=full.layer_types[:MOE_LAYERS])


def dropped_total(engine) -> int:
    """The engine's running MoE dropped-slot total (what its next metrics
    fetch publishes as moe_dropped_slots)."""
    d = engine._moe_dropped_dev
    return 0 if d is None else int(d)


def dropfree_reference_check(spec, params, prompt, tokens):
    """near_argmax_check against the drop-free MoE: the reference forward
    with every expert's capacity at T (capacity_factor E / k), so no slot
    can drop, which is what an engine run that dropped nothing computed.
    Returns (agreement, worst gap, the reference's dropped slots: 0 by
    construction, counted all the same)."""
    from dynamo_tpu_torch.models import moe

    real, drops = moe.moe_mlp, []
    no_drop = spec.num_experts / spec.num_experts_per_token

    def counted(spec_, lp, x, *, capacity_factor=1.25, return_dropped=False):
        out, d = real(spec_, lp, x, capacity_factor=no_drop, return_dropped=True)
        drops.append(d)
        return (out, d) if return_dropped else out

    moe.moe_mlp = counted
    try:
        agree, gap = near_argmax_check(spec, params, prompt, tokens)
    finally:
        moe.moe_mlp = real
    return agree, gap, sum(int(d) for d in drops)


def expert_split(engine, prompts, traced, flush) -> None:
    """Phase 15's split of a B=8 graph step: the experts of every layer
    (moe_mlp at its decode shape, T = 8, C = 8, CUDA events, L2 flushed)
    and their three batched products alone, against the traced graph
    step's busy time and its fused_decode time; and the experts that one
    eager step's routing touches per layer, against all E (the bytes of a
    routed-only product)."""
    from dynamo_tpu_torch.models import llama, moe

    spec = engine.spec
    E, d, f = spec.num_experts, spec.hidden_size, spec.moe_intermediate_size
    B = len(prompts)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(MOE_SEED)
    x = (torch.randn(B, d, generator=gen, device=DEVICE)).to(torch.bfloat16)
    layers = [lp.moe for lp in engine.params.layers]
    C = moe.expert_capacity(B, E, spec.num_experts_per_token)
    xe = torch.randn(E, C, d, generator=gen, device=DEVICE).to(torch.bfloat16)
    h = torch.randn(E, C, f, generator=gen, device=DEVICE).to(torch.bfloat16)
    with torch.no_grad():
        moe_ms = time_ms(lambda: [moe.moe_mlp(spec, lp, x) for lp in layers], flush)
        bmm_ms = time_ms(lambda: [(torch.bmm(xe, lp.w_gate), torch.bmm(xe, lp.w_up),
                                   torch.bmm(h, lp.w_down)) for lp in layers], flush)
    w_bytes = 3 * E * d * f * 2  # bf16 gate, up, down of every expert, one layer
    bound, _ = bound_ms(w_bytes * len(layers), 0.0)
    line = (f"gpt-oss step split: experts (moe_mlp x {len(layers)} layers at T={B}, C={C}) "
            f"{moe_ms:.3f} ms, their batched products alone {bmm_ms:.3f} ms, bound "
            f"{bound:.3f} ms ({w_bytes * len(layers) / 1e9:.2f} GB of expert weights)")
    if traced is not None:
        rest = traced["busy_ms"] - moe_ms - traced["attn_ms"]
        line += (f"; traced graph step busy {traced['busy_ms']:.3f} ms: experts "
                 f"{moe_ms / traced['busy_ms']:.3f}, attention (fused_decode) "
                 f"{traced['attn_ms']:.3f} ms, the rest {rest:.3f} ms")
    print(line)
    # routed-only work: the experts one eager step's tokens pick per layer
    touched = []
    real = moe.route

    def spy(spec_, lp, xx):
        w, i = real(spec_, lp, xx)
        touched.append(int(torch.unique(i).numel()))
        return w, i

    bts, first, lens = prefill_slots(engine, prompts)
    moe.route = spy
    try:
        with torch.no_grad():
            llama.decode_forward(spec, engine.params, torch.from_numpy(first).to(DEVICE),
                                 torch.from_numpy(bts).to(DEVICE),
                                 torch.from_numpy(lens).to(DEVICE), engine.k_pages,
                                 engine.v_pages, torch.ones(B, dtype=torch.bool,
                                                            device=DEVICE))
    finally:
        moe.route = real
    per = 3 * d * f * 2
    print(f"gpt-oss routed experts per layer in one B={B} step: {touched} of {E} "
          f"(routed-only weight bytes {[round(n * per / 1e9, 3) for n in touched]} GB "
          f"against {w_bytes / 1e9:.2f} GB read by the all-experts product)")


def gpt_oss_kernel_row(flush) -> dict:
    """fused_decode at gpt-oss's shape (B 8, KH 8, G 8, D 64, window
    MOE_WINDOW + sinks, SEQ_LENS), bf16: checked against its plain version,
    timed beside it and SDPA with the same window and sinks."""
    from dynamo_tpu_torch.ops.cuda import fused_decode

    over = dict(G=8, D=64)
    layer = 1
    t = kernel_inputs(torch.bfloat16, seed=15, **over)
    err, _ = check_attention(t, "bfloat16/gpt-oss", MOE_WINDOW, t["sinks"], layer)
    q, kn, vn, bt, sl, dp, do = (t[k] for k in
                                 ("q", "k_new", "v_new", "bt", "sl", "dst_page", "dst_off"))
    kp, vp, sinks = t["k_pages"], t["v_pages"], t["sinks"]
    kw = dict(layer=layer, window=MOE_WINDOW, sinks=sinks)
    r = {"max_abs_err": err}
    r["ms"] = time_ms(lambda: fused_decode.fused_decode_attention(
        q, kp, vp, kn, vn, bt, sl, dp, do, **kw), flush)
    r["plain_ms"] = time_ms(lambda: fused_decode.fused_decode_plain(
        q, kp, vp, kn, vn, bt, sl, dp, do, **kw), flush)
    r["library_ms"] = time_ms(sdpa_call(t, layer, MOE_WINDOW, sinks), flush)
    r["bound_ms"], r["bound_by"] = attention_bound(True, MOE_WINDOW, **over)
    print_times({"fused_decode/gpt-oss": r})
    return r


def moe_phase(cfg, flush) -> tuple[int, dict]:
    """Phase 15 (a) and (c): gpt-oss-120b at full width, MOE_LAYERS deep,
    random bf16 weights from a seeded generator (the input embedding
    scaled by MOE_EMBED_SCALE), decode graphs captured first; the default
    serve (phase 4's checks, 4 fused_decode launches per step, no
    reference: packed prefills route padding rows too), one
    MOE_PROMPT-token prompt served alone, whose prefill must drop 0 slots,
    near-argmax under the reference forward made drop-free (an unpadded
    forward over prompt + tokens sees another T, so another capacity; at
    capacity T both sides compute the drop-free MoE), phase 5's step graphs,
    the step's split; then fused_decode at this shape. Returns (the serves'
    fused_decode launches, the kernel row)."""
    spec = gpt_oss_spec()
    require(spec.layer_types == ("sliding_attention", "full_attention") * 2
            and spec.num_experts == 128 and spec.hidden_size == 2880,
            f"gpt-oss spec: {spec}")
    prompts = make_prompts(spec.vocab_size)
    alone = np.random.default_rng(MOE_SEED).integers(3, spec.vocab_size,
                                                     MOE_PROMPT).tolist()
    from dynamo_tpu_torch.models import llama

    t0 = time.perf_counter()
    params = llama.init_params(spec, 0, device=DEVICE)
    with torch.no_grad():
        params.embed.mul_(MOE_EMBED_SCALE)
    engine = new_engine(spec, dict(cfg, kv_dtype="bf16"), "gpt-oss-120b", params=params)
    del params
    print(f"engine gpt-oss-120b: {MOE_LAYERS} of 36 layers, {spec.num_experts} experts "
          f"top-{spec.num_experts_per_token}, built and captured in "
          f"{time.perf_counter() - t0:.1f} s")
    drops: dict[str, int] = {}

    def counted(name, fn):
        async def run(e):
            d0 = dropped_total(e)
            res = await fn(e)
            drops[name] = dropped_total(e) - d0
            return res
        return name, run

    out = serve_phases(engine, [
        counted("default", lambda e: serve(e, prompts)),
        counted("alone", lambda e: requests(e, [make_request(alone)])),
    ])
    launches, _tokens = serve_check(engine, prompts, out["default"], "gpt-oss-120b",
                                    reference=False)
    print(f"serve gpt-oss-120b: moe_dropped_slots {dropped_total(engine)} after the serves "
          f"({drops['default']} in the default serve's prefills)")
    (items, ttft, wall), counts, steps = (out["alone"]["res"], out["alone"]["counts"],
                                          out["alone"]["steps"])
    toks = [t for x in items[0] for t in x["token_ids"]]
    require(items[0][-1]["finish_reason"] == "length" and len(toks) == SERVE_TOKENS,
            f"gpt-oss alone: {len(toks)} tokens, finish {items[0][-1]['finish_reason']}")
    require(counts["fused_decode"] == spec.num_layers * steps == spec.num_layers
            * out["alone"]["replays"],
            f"gpt-oss alone: fused_decode {counts['fused_decode']} over {steps} steps")
    require(drops["alone"] == 0, f"gpt-oss alone: its prefill dropped {drops['alone']} slots")
    agree, gap, ref_drop = dropfree_reference_check(spec, engine.params, alone, toks)
    require(ref_drop == 0, f"gpt-oss alone: the drop-free reference dropped {ref_drop} slots")
    print(f"reference gpt-oss-120b: a {MOE_PROMPT}-token prompt served alone (TTFT "
          f"{1e3 * ttft[0]:.1f} ms), 0 slots dropped by its prefill; against the "
          f"drop-free reference forward (capacity T) exact greedy agreement {agree:.3f}, "
          f"worst gap {gap:.3f} (tol {NEAR_ARGMAX})")
    traced = step_graph_check(engine, prompts)
    expert_split(engine, prompts, traced, flush)
    drop_engine(engine)
    del engine
    torch.cuda.empty_cache()
    row = gpt_oss_kernel_row(flush)
    return launches["fused_decode"] + counts["fused_decode"], row


def checkpoint_phase() -> None:
    """Phase 15 (b): llama-3-8b at full width, CKPT_LAYERS deep, written by
    the port's save_params and read back by load_model_dir onto the card:
    every weight and one prefill's logits bitwise equal; the same
    CKPT_REQUESTS greedy requests (one at a time) through an engine on the
    loaded weights and through ``cli run --model-path`` over HTTP, texts
    equal (a directory that also holds a tokenizer is phase 17's). Prints
    the write and load seconds and GB/s (the load reads files the
    write just left in the page cache)."""
    import dataclasses
    import shutil
    import tempfile

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.frontend.tokenizer import MockTokenizer
    from dynamo_tpu_torch.models import llama, loader

    spec = dataclasses.replace(ModelSpec.llama3_8b(), num_layers=CKPT_LAYERS)
    params = llama.init_params(spec, 15, device=DEVICE)
    with torch.no_grad():
        params.lm_head[:, : CKPT_IDS[0]] = 0
        params.lm_head[:, CKPT_IDS[1]:] = 0
    parent = ROOT / "build" / "checkpoints"  # git-ignored
    parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="ckpt-", dir=parent))
    ckpt = tmp / "llama-3-8b-2l"
    try:
        t0 = time.perf_counter()
        loader.save_params(spec, params, str(ckpt))
        write_s = time.perf_counter() - t0
        files = sorted(ckpt.glob("*.safetensors"))
        disk = sum(f.stat().st_size for f in files)
        t0 = time.perf_counter()
        spec2, loaded = loader.load_model_dir(str(ckpt), device=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        require(dataclasses.replace(spec2, name=spec.name) == spec,
                f"checkpoint spec differs: {spec2}")
        a, b = dict(params.named_parameters()), dict(loaded.named_parameters())
        require(sorted(a) == sorted(b) and all(
            a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a),
            "checkpoint weights differ after the round trip")
        prompts = [p[:64 + 48 * i] for i, p in enumerate(make_prompts(spec.vocab_size)
                                                          [2:2 + CKPT_REQUESTS])]
        T = 64
        tok = torch.tensor(prompts[0][:T], dtype=torch.int32, device=DEVICE)
        bt = torch.arange(1, 9, dtype=torch.int32, device=DEVICE)
        with torch.no_grad():
            la, _ = llama.prefill_forward(spec, params, tok, bt, 0,
                                          *llama.init_cache(spec, 9, 16, device=DEVICE), T)
            lb, _ = llama.prefill_forward(spec2, loaded, tok, bt, 0,
                                          *llama.init_cache(spec, 9, 16, device=DEVICE), T)
        require(torch.equal(la, lb), "prefill logits on the loaded weights differ")
        print(f"checkpoint {spec.name} x {CKPT_LAYERS} layers: save_params {disk / 1e9:.3f} GB "
              f"in {len(files)} files, {write_s:.2f} s = {disk / 1e9 / write_s:.2f} GB/s; "
              f"load_model_dir to the card {load_s:.2f} s = {disk / 1e9 / load_s:.2f} GB/s "
              f"(page cache); {len(a)} weights and one {T}-token prefill's logits bitwise "
              f"equal")
        del params, la, lb

        reqs = [make_request(p, CKPT_TOKENS) for p in prompts]
        engine = InferenceEngine(spec2, EngineConfig(pipeline_decode=True), params=loaded,
                                 device=DEVICE)
        engine.precompile()

        async def one_by_one(e):
            return [(await requests(e, [r]))[0][0] for r in reqs]

        served = serve_phases(engine, [("ckpt", one_by_one)])["ckpt"]
        drop_engine(engine)
        del engine, loaded
        torch.cuda.empty_cache()
        want = [[t for x in items for t in x["token_ids"]] for items in served["res"]]
        require(all(len(w) == CKPT_TOKENS and all(CKPT_IDS[0] <= t < CKPT_IDS[1] for t in w)
                    for w in want), f"checkpoint serve: tokens {want}")
        tok_ = MockTokenizer()
        name = ckpt.name
        cmd = [sys.executable, "-m", "dynamo_tpu_torch.cli", "run", "--in", "http",
               "--out", "engine", "--model-path", str(ckpt), "--port", "0", "--precompile"]
        with cli_process(cmd) as (port, t_ready):

            async def post_all():
                res = []
                for p in prompts:
                    res.append(await http_call(port, "POST", "/v1/completions", {
                        "model": name, "prompt": p, "max_tokens": CKPT_TOKENS,
                        "temperature": 0.0, "ignore_eos": True}))
                return res

            got = asyncio.run(post_all())
        texts = []
        for status, body, _times in got:
            js = json.loads(body) if status == 200 else {}
            require(status == 200 and js["usage"]["completion_tokens"] == CKPT_TOKENS,
                    f"cli --model-path: status {status}, {body[:300]!r}")
            texts.append(js["choices"][0]["text"])
        same = [t == tok_.decode(w) for t, w in zip(texts, want)]
        require(all(same), f"cli --model-path streams differ from the in-process engine's: "
                           f"{texts} vs {[tok_.decode(w) for w in want]}")
        print(f"checkpoint cli: {' '.join(cmd[1:])}: DYNAMO_HTTP after {t_ready:.1f} s; "
              f"{CKPT_REQUESTS} greedy completions x {CKPT_TOKENS} tokens, one at a time, "
              f"equal to the in-process engine's on the loaded weights "
              f"({sum(same)}/{len(same)}), e.g. {texts[0]!r}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------------ MLA


def deepseek_spec(layers: int = MLA_LAYERS):
    """deepseek-r1 at full width, ``layers`` deep."""
    import dataclasses

    from dynamo_tpu_torch.engine.config import ModelSpec

    return dataclasses.replace(ModelSpec.deepseek_r1(), num_layers=layers)


def prefill_capacity_reference_check(spec, params, prompt, tokens):
    """near_argmax_check against the function the engine computed for a
    prompt that filled its prefill bucket and was served alone: the
    reference forward with every MoE layer routing the prompt's rows as
    the engine's prefill did (the same rows, so the same capacity and the
    same dropped slots) and each served token's row drop-free, as a decode
    step's (C = min(T, 16) of at most 16 rows never drops). Returns
    (agreement, worst gap, the prompt rows' dropped slots)."""
    from dynamo_tpu_torch.models import moe

    real, drops, n = moe.moe_mlp, [], len(prompt)
    no_drop = spec.num_experts / spec.num_experts_per_token

    def split(spec_, lp, x, *, capacity_factor=1.25, return_dropped=False):
        a, d = real(spec_, lp, x[:n], capacity_factor=capacity_factor, return_dropped=True)
        b, db = real(spec_, lp, x[n:], capacity_factor=no_drop, return_dropped=True)
        drops.append(d)
        require(int(db) == 0, f"served rows dropped {int(db)} slots at capacity T")
        out = torch.cat([a, b])
        return (out, d + db) if return_dropped else out

    moe.moe_mlp = split
    try:
        agree, gap = near_argmax_check(spec, params, prompt, tokens)
    finally:
        moe.moe_mlp = real
    return agree, gap, sum(int(d) for d in drops)


@contextlib.contextmanager
def counted_drops():
    """moe.moe_mlp wrapped to keep every eager call's dropped-slot count
    (the MLA family reports 0, as the reference's; graph replays run no
    Python, and a call under capture is not kept). Yields the list."""
    from dynamo_tpu_torch.models import moe

    real, drops = moe.moe_mlp, []

    def counted(spec_, lp, x, *, capacity_factor=1.25, return_dropped=False):
        out, d = real(spec_, lp, x, capacity_factor=capacity_factor, return_dropped=True)
        if not torch.cuda.is_current_stream_capturing():
            drops.append(d)
        return (out, d) if return_dropped else out

    moe.moe_mlp = counted
    try:
        yield drops
    finally:
        moe.moe_mlp = real


def mla_split(engine, prompts, traced, flush) -> None:
    """Phase 16 (b): a B=8 decode step's parts, each per layer with CUDA
    events (L2 flushed) on the engine's pools after a prefill of
    ``prompts``: the absorbed attention (q and latent projections, the
    latent append, the gather, the absorbed product, the output
    projection), the experts (moe_mlp + the shared expert) and the dense
    MLPs, against the traced graph step's busy time (the rest: embedding,
    norms, the head, sampling); and the experts one eager step's routing
    touches."""
    from dynamo_tpu_torch.models import mla, moe

    spec, B = engine.spec, len(prompts)
    bts, first, lens = prefill_slots(engine, prompts)
    bt = torch.from_numpy(bts).to(DEVICE)
    sl = torch.from_numpy(lens).to(DEVICE)
    active = torch.ones(B, dtype=torch.bool, device=DEVICE)
    where = mla.decode_where(bt, sl, active, engine.config.page_size)
    rot = mla._rot(spec, where[0][:, None])
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(MLA_SEED)
    x = torch.randn(B, 1, spec.hidden_size, generator=gen, device=DEVICE).to(torch.bfloat16)
    parts = {"attention": 0.0, "experts": 0.0, "dense": 0.0}
    per_layer = []
    with torch.no_grad():
        for li, lp in enumerate(engine.params.layers):
            a_ms = time_ms(lambda: mla.decode_attention(
                spec, lp, li, x, rot, engine.k_pages, bt, where).reshape(B, -1).to(x.dtype)
                @ lp.wo, flush)
            f_ms = time_ms(lambda: mla._ffn(spec, lp, x[:, 0]), flush)
            kind = "dense" if lp.get("moe") is None else "experts"
            parts["attention"] += a_ms
            parts[kind] += f_ms
            per_layer.append(f"L{li} attention {a_ms:.3f} + {kind} {f_ms:.3f}")
        head_ms = time_ms(lambda: mla._logits(spec, engine.params, x[:, 0]), flush)
    line = (f"deepseek-r1 step split (B={B}, ms): {'; '.join(per_layer)}; sums: attention "
            f"{parts['attention']:.3f}, experts (moe_mlp + shared) {parts['experts']:.3f}, "
            f"dense MLPs {parts['dense']:.3f}; the head {head_ms:.3f}")
    if traced is not None:
        busy = traced["busy_ms"]
        rest = busy - sum(parts.values())
        line += (f"; traced graph step busy {busy:.3f} ms: attention "
                 f"{parts['attention'] / busy:.3f}, experts {parts['experts'] / busy:.3f}, "
                 f"dense {parts['dense'] / busy:.3f}, the rest {rest:.3f} ms "
                 f"({rest / busy:.3f})")
    print(line)
    touched, real = [], moe.route

    def spy(spec_, lp, xx):
        w, i = real(spec_, lp, xx)
        touched.append(int(torch.unique(i).numel()))
        return w, i

    moe.route = spy
    try:
        with torch.no_grad():
            mla.decode_forward(spec, engine.params, torch.from_numpy(first).to(DEVICE),
                               torch.from_numpy(bts).to(DEVICE),
                               torch.from_numpy(lens).to(DEVICE), engine.k_pages, active)
    finally:
        moe.route = real
    per = 3 * spec.hidden_size * spec.moe_intermediate_size * 2
    print(f"deepseek-r1 routed experts in one B={B} step: {touched} of {spec.num_experts} "
          f"(routed-only weight bytes {[round(n * per / 1e9, 3) for n in touched]} GB "
          f"against {spec.num_experts * per / 1e9:.2f} GB read by the all-experts product)")


def mla_attention_times(flush, B: int, P: int, seq_lens) -> dict:
    """Phase 16 (c) at one shape: deepseek-r1's latent attention of one
    layer (H 128, dc 512, dr 64, page 16, P pages per sequence, bf16
    latent pool) as the decode step runs it (``mla._absorbed_attention``
    over ``mla._gather_rows_any``: w_uk / w_uv cast to f32, every table
    page gathered), timed beside one scaled_dot_product_attention call on
    the same inputs: the absorbed query [q_lat, q_rope] (576) against the
    gathered rows as one shared KV head (the H heads' queries as H query
    rows of it) and the latent (512) as the value, its output re-expanded
    by w_uv for the check. The bound: the live
    latent rows at 576 x 2 B per token, q and out, or the flops at the
    bf16 peak."""
    from dynamo_tpu_torch.models import mla

    spec = deepseek_spec(1)
    H, dn, dr, dc, page = (spec.num_heads, spec.qk_nope_head_dim, spec.qk_rope_head_dim,
                           spec.kv_lora_rank, 16)
    seq_lens = (tuple(seq_lens) * B)[:B]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(MLA_SEED + B)
    rng = np.random.default_rng(MLA_SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEVICE) * scale).to(torch.bfloat16)

    cache = randn(1, 1 + B * P, page, dc + dr)
    bts = np.stack([rng.permutation(np.arange(1 + i * P, 1 + (i + 1) * P)) for i in range(B)])
    bt = torch.from_numpy(bts.astype(np.int32)).to(DEVICE)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=DEVICE)
    mask = (torch.arange(P * page, device=DEVICE)[None, :] < sl[:, None])[:, None]
    from dynamo_tpu_torch.models.mla import MlaLayer

    lp = MlaLayer({"w_uk": randn(H, dc, dn, scale=dc ** -0.5),
                   "w_uv": randn(H, dc, spec.v_head_dim, scale=dc ** -0.5)})
    q_nope, q_rope = randn(B, 1, H, dn), randn(B, 1, H, dr)
    scale = mla.softmax_scale(spec)

    def plain():
        return mla._absorbed_attention(spec, lp, q_nope, q_rope,
                                       mla._gather_rows_any(cache, 0, bt), mask)

    with torch.no_grad():
        rows = mla._gather_rows_any(cache, 0, bt)  # [B, S, 576]
        q_lat = torch.einsum("bthn,hcn->bthc", q_nope.float(), lp.w_uk.float())
        # the H heads' absorbed queries as H query rows of one shared head
        q = torch.cat([q_lat.to(torch.bfloat16), q_rope], dim=-1).transpose(1, 2)
        k, v, m = rows[:, None], rows[:, None, :, :dc], mask[:, None]

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=m, scale=scale)  # [B, 1, H, dc]

        want = plain()
        got = torch.einsum("bthc,hcv->bthv", library().transpose(1, 2).float(),
                           lp.w_uv.float())
        err = (got - want).abs().max().item()
        r = {"plain_ms": time_ms(plain, flush), "library_ms": time_ms(library, flush),
             "max_abs_err": err, "max_abs": want.abs().max().item(), "backends": {}}
        # the same call under each SDPA backend that takes it (D 576 is past
        # the flash kernels' head dim)
        from torch.nn.attention import SDPBackend, sdpa_kernel

        for b in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
            try:
                with sdpa_kernel([b]):
                    r["backends"][b.name] = time_ms(library, flush)
            except RuntimeError:
                r["backends"][b.name] = None
    live = sum(seq_lens)
    nbytes = live * (dc + dr) * 2 + B * H * (dc + dr) * 2 + B * H * dc * 2
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, 2 * H * live * (dc + dr + dc))
    r["weights_gb"] = 2 * H * dc * dn * 2 / 1e9
    return r


def mla_yardstick(flush, card: str) -> None:
    """Phase 16 (c): the latent attention at B=8 over SEQ_LENS and at
    B=1 x LONG_SEQ_LEN (no TPU kernel: the reference computes it in
    XLA)."""
    for label, B, P, sls in (("B8", 8, 64, SEQ_LENS),
                             (f"B1/{LONG_SEQ_LEN}", 1, LONG_SEQ_LEN // 16, (LONG_SEQ_LEN,))):
        r = mla_attention_times(flush, B, P, sls)
        print(f"mla attention {label} (one layer, deepseek-r1): plain {r['plain_ms']:.4f} ms, "
              f"sdpa {r['library_ms']:.4f} ms (by backend {r['backends']}), bound "
              f"{r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; w_uk + w_uv add {r['weights_gb']:.4f} GB read as bf16); "
              f"sdpa re-expanded vs plain max |diff| {r['max_abs_err']:.3e} of "
              f"max |out| {r['max_abs']:.3e} [{card}]")
        require(r["max_abs_err"] <= 2e-2 * max(r["max_abs"], 1e-3),
                f"sdpa's latent attention differs from the plain one: {r}")


def mla_phase(cfg, flush, card: str) -> None:
    """Phase 16 (a)-(c): deepseek-r1 at full width, MLA_LAYERS deep, random
    bf16 weights from a seeded generator (input embedding scaled by
    MOE_EMBED_SCALE); per latent pool form (bf16, then fp8 on the same
    weights): decode graphs captured first, the default serve (phase 4's
    checks, no kernel launched: MLA's path has none), one MLA_PROMPT-token
    prompt served alone (a whole prefill bucket: its stream near-argmax
    under mla.reference_forward routing the prompt's rows as the prefill
    did, the counting wrapper's dropped slots equal to the reference's,
    the served rows drop-free as decode's),
    phase 5's step graphs (bitwise, values and scales on fp8), phase 12's
    verify graphs (every row count against eager verify_forward, targets
    and pools bitwise); on bf16 the step's split; then the latent
    attention's yardstick."""
    from dynamo_tpu_torch.models import mla

    spec = deepseek_spec()
    require((spec.hidden_size, spec.num_heads, spec.q_lora_rank, spec.kv_lora_rank,
             spec.qk_rope_head_dim, spec.v_head_dim, spec.num_experts,
             spec.num_experts_per_token, spec.n_group, spec.topk_group,
             spec.n_shared_experts, spec.vocab_size, spec.rope_scaling_factor,
             spec.first_k_dense) == (7168, 128, 1536, 512, 64, 128, 256, 8, 8, 4, 1, 129280,
                                     40.0, 3), f"deepseek-r1 spec: {spec}")
    prompts = make_prompts(spec.vocab_size)
    alone = np.random.default_rng(MLA_SEED).integers(3, spec.vocab_size, MLA_PROMPT).tolist()
    require(cfg.get("prefill_buckets", (64, 128, 256)).count(MLA_PROMPT) == 1,
            "the prompt served alone must fill a prefill bucket")
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = mla.init_params(spec, 0, device=DEVICE)
    with torch.no_grad():
        params.embed.mul_(MOE_EMBED_SCALE)
    torch.cuda.synchronize()
    w_bytes = sum(p.nbytes for p in params.parameters())
    print(f"deepseek-r1 weights: {MLA_LAYERS} of 61 layers ({spec.first_k_dense} dense, "
          f"{MLA_LAYERS - spec.first_k_dense} MoE of {spec.num_experts} experts + "
          f"{spec.n_shared_experts} shared), {w_bytes / 1e9:.2f} GB bf16 drawn in "
          f"{time.perf_counter() - t0:.1f} s; allocated {before / 2**30:.1f} GiB before "
          f"the draw, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    pool_bytes, verify_ms = {}, {}
    for kv in ("bf16", "fp8"):
        label = f"deepseek-r1 {kv}"
        engine = new_engine(spec, dict(cfg, kv_dtype=kv), label, params=params)
        pool_bytes[kv] = engine.pool_bytes
        drops: dict[str, int] = {}
        with counted_drops() as kept:

            def counted(name, fn):
                async def run(e):
                    n0 = len(kept)
                    res = await fn(e)
                    drops[name] = sum(int(d) for d in kept[n0:])
                    return res
                return name, run

            out = serve_phases(engine, [
                counted("default", lambda e: serve(e, prompts)),
                counted("alone", lambda e: requests(e, [make_request(alone)])),
            ])
        serve_check(engine, prompts, out["default"], label, reference=False)
        (items, ttft, wall), counts = out["alone"]["res"], out["alone"]["counts"]
        toks = [t for x in items[0] for t in x["token_ids"]]
        require(items[0][-1]["finish_reason"] == "length" and len(toks) == SERVE_TOKENS,
                f"{label} alone: {len(toks)} tokens, finish {items[0][-1]['finish_reason']}")
        require(not any(counts.values()), f"{label} alone launched kernels: {counts}")
        agree, gap, ref_drop = prefill_capacity_reference_check(spec, engine.params, alone,
                                                                toks)
        require(ref_drop == drops["alone"],
                f"{label} alone: the prefill dropped {drops['alone']} slots, the reference's "
                f"prompt rows {ref_drop}")
        print(f"serve {label}: {drops['default']} slots dropped by the default serve's "
              f"prefills (counted by the wrapper); a {MLA_PROMPT}-token prompt alone (TTFT "
              f"{1e3 * ttft[0]:.1f} ms), {drops['alone']} slots dropped by its prefill, as "
              f"many by mla.reference_forward's prompt rows at the prefill's capacity (served "
              f"rows drop-free, as decode's): exact greedy agreement {agree:.3f}, worst gap "
              f"{gap:.3f} (tol {NEAR_ARGMAX}) [{card}]")
        traced = step_graph_check(engine, prompts)
        verify_ms[kv] = verify_graph_check(engine, prompts, verify_ms.get("bf16"))
        if kv == "bf16":
            mla_split(engine, prompts, traced, flush)
        drop_engine(engine)
        del engine
        torch.cuda.empty_cache()
    print(f"deepseek-r1 latent pools ({cfg['num_pages'] + 1} pages x {cfg['page_size']} "
          f"tokens x {MLA_LAYERS} layers): bf16 {pool_bytes['bf16']} bytes "
          f"({pool_bytes['bf16'] / 1e9:.4f} GB), fp8 {pool_bytes['fp8']} bytes "
          f"({pool_bytes['fp8'] / 1e9:.4f} GB) = {pool_bytes['fp8'] / pool_bytes['bf16']:.3f} "
          f"of bf16 [{card}]")
    del params
    torch.cuda.empty_cache()
    mla_yardstick(flush, card)


def mla_checkpoint_check(card: str) -> None:
    """Phase 16 (d): deepseek-r1 at full width, MLA_CKPT_LAYERS deep (a
    dense layer), written by save_params (kv_b_proj re-fused, rope
    columns re-interleaved) under build/checkpoints/ and read back by
    load_model_dir onto the card: the same spec, every weight and one
    prefill's logits bitwise equal; write and load GB/s printed."""
    import dataclasses
    import shutil
    import tempfile

    from dynamo_tpu_torch.models import loader, mla

    spec = deepseek_spec(MLA_CKPT_LAYERS)
    params = mla.init_params(spec, 16, device=DEVICE)
    parent = ROOT / "build" / "checkpoints"  # git-ignored
    parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="ckpt-", dir=parent))
    ckpt = tmp / "deepseek-r1-1l"
    try:
        t0 = time.perf_counter()
        loader.save_params(spec, params, str(ckpt))
        write_s = time.perf_counter() - t0
        disk = sum(f.stat().st_size for f in ckpt.glob("*.safetensors"))
        t0 = time.perf_counter()
        spec2, loaded = loader.load_model_dir(str(ckpt), device=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        require(dataclasses.replace(spec2, name=spec.name) == spec,
                f"deepseek checkpoint spec differs: {spec2}")
        a, b = dict(params.named_parameters()), dict(loaded.named_parameters())
        require(sorted(a) == sorted(b) and all(
            a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a),
            "deepseek checkpoint weights differ after the round trip")
        T = 64
        tok = torch.tensor(make_prompts(spec.vocab_size)[3][:T], dtype=torch.int32,
                           device=DEVICE)
        bt = torch.arange(1, 9, dtype=torch.int32, device=DEVICE)
        with torch.no_grad():
            la, _ = mla.prefill_forward(spec, params, tok, bt, 0,
                                        mla.init_cache(spec, 9, 16, device=DEVICE), T)
            lb, _ = mla.prefill_forward(spec2, loaded, tok, bt, 0,
                                        mla.init_cache(spec2, 9, 16, device=DEVICE), T)
        require(torch.equal(la, lb), "deepseek prefill logits on the loaded weights differ")
        print(f"checkpoint {spec.name} x {MLA_CKPT_LAYERS} layer: save_params "
              f"{disk / 1e9:.3f} GB in {write_s:.2f} s = {disk / 1e9 / write_s:.2f} GB/s; "
              f"load_model_dir to the card {load_s:.2f} s = {disk / 1e9 / load_s:.2f} GB/s "
              f"(page cache); {len(a)} weights and one {T}-token prefill's logits bitwise "
              f"equal [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------------ text

# phase 17: llama-3-8b at full width, CKPT_LAYERS deep, served with a
# llama-3-format tokenizer this script writes (TEXT_VOCAB base entries +
# 256 specials); TEXT_REQUESTS chats of TEXT_TOKENS greedy tokens each
TEXT_VOCAB = 128000
TEXT_TOKENS = 16
TEXT_JSON_TOKENS = 24
TEXT_SEED = 1717
# the text checkpoint's dim 0 is a constant no layer reads or writes, which
# the head uses as a bias: TEXT_BRACE_BIAS on every token holding "{"
# except "{}", so a json_object answer opens with "{}" and ends on EOS
TEXT_CONST = 1.0
TEXT_BRACE_BIAS = -30.0
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
                  r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
# llama-3-8b-instruct's chat template
LLAMA3_TEMPLATE = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + "
    "'<|end_header_id|>\n\n'+ message['content'] | trim + '<|eot_id|>' %}"
    "{% if loop.index0 == 0 %}{% set content = bos_token + content %}{% endif %}"
    "{{ content }}{% endfor %}{% if add_generation_prompt %}"
    "{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}")
# the merge rule's corpus, and the host-cost corpus (with TEXT_EXTRA)
TEXT_CORPUS = """\
The quick brown fox jumps over the lazy dog. A distributed inference server
splits a model's work between a router, a frontend and many workers. Each
worker keeps a paged cache of keys and values, and the router sends every
request to the worker whose cache already holds the longest prefix of its
prompt. When the cluster is busy, requests wait in a queue; when it is idle,
the planner may scale the number of workers down. Latency, throughput and
the time to the first token are what the users of such a system pay for.
It isn't hard to see why they're tired of slow answers: we'll measure what
you've built, and I'm sure she'd agree that it's the right thing to do.
Please summarize the following document in three sentences, then list the
main points as a bulleted list. Translate the answer into French and German.
What is the capital of France? Paris is the capital and largest city of
France, with a population of more than two million people in 2024.

def generate(self, request: dict, context: Context) -> AsyncIterator[dict]:
    \"\"\"Stream token deltas for one request.\"\"\"
    prompt = request["token_ids"]
    for step in range(self.max_tokens):
        logits = self.model.forward(prompt, self.cache)
        token = int(torch.argmax(logits[-1]))
        yield {"token_ids": [token], "finish_reason": None}
        if token == self.eos_token_id:
            return

class KvRouter:
    def __init__(self, hub, component: str, config=None):
        self.tree = RadixTree()
        self.config = config or RouterConfig()

for (int i = 0; i < n; ++i) {
    sum += a[i] * b[i];
}
return std::max(0.0f, sum / static_cast<float>(n));

const response = await fetch("/v1/chat/completions", {method: "POST"});
{"model": "llama-3-8b", "messages": [{"role": "user", "content": "Hello"}],
 "max_tokens": 128, "temperature": 0.7, "stream": true, "tools": []}
SELECT name, count(*) FROM users WHERE created_at > '2024-01-01' GROUP BY name;
import numpy as np
import torch.nn.functional as F
x = np.linspace(0.0, 1.0, 1024, dtype=np.float32)
机器学习是人工智能的一个分支。日本語のテキストも処理できます。
Les modèles de langue répondent en français. Die Antwort ist richtig.
La respuesta está en español. Ответ на русском языке. مرحبا بالعالم
"""
TEXT_EXTRA = "😀 👍🏽 👩‍💻 🇯🇵 ✨ 한국어 텍스트 Ελληνικά κείμενα.\n"
TEXT_CHATS = [
    [{"role": "system", "content": "You are a concise assistant."},
     {"role": "user", "content": "Explain in two sentences why a paged KV cache "
                                 "lets a server batch requests of different lengths."}],
    [{"role": "user", "content": "What does this function return?\n\n```python\n"
                                 "def f(xs):\n    return sorted(set(xs))[-2:]\n```"}],
    [{"role": "user", "content": "Traduis en français et en japonais : "
                                 "« the cache is full » — 机器学习 👩‍💻"}],
    [{"role": "system", "content": "Answer with a JSON object."},
     {"role": "user", "content": "List three colours and their hex codes, e.g. "
                                 "{\"red\": \"#ff0000\"}."}],
]
TEXT_JSON_CHAT = [{"role": "user", "content": "Return an empty JSON object."}]


def _llama3_specials() -> list[str]:
    named = {0: "<|begin_of_text|>", 1: "<|end_of_text|>", 6: "<|start_header_id|>",
             7: "<|end_header_id|>", 9: "<|eot_id|>"}
    out, r = [], 0
    for i in range(256):
        if i in named:
            out.append(named[i])
        else:
            out.append(f"<|reserved_special_token_{r}|>")
            r += 1
    return out


def write_llama3_tokenizer(path: Path) -> dict:
    """A llama-3-format tokenizer with llama-3's pre-tokenizer, specials,
    chat template and vocabulary size: the 256 byte-level symbols, then
    TEXT_VOCAB - 256 merges made by a fixed rule. First every pre-token of
    TEXT_CORPUS (by first appearance) grows left to right, one symbol per
    merge; then every pair of printable ASCII and whitespace symbols,
    space-led letter pairs, letter trigrams (lower, space-led, capitalised),
    digit triples and space runs; then lower-case four-letter strings in
    order until the count is reached. Each merge's parts exist before it.
    Returns the vocabulary's merge count and the corpus's pre-token count."""
    import itertools
    import string

    from dynamo_tpu_torch.frontend.hf_tokenizer import BYTE_CHAR
    from dynamo_tpu_torch.frontend.unicode_regex import compile_pattern

    vocab = {BYTE_CHAR[b]: b for b in range(256)}
    merges: list[list[str]] = []

    def add(a: str, b: str) -> bool:
        if len(vocab) >= TEXT_VOCAB or a + b in vocab:
            return False
        require(a in vocab and b in vocab, f"merge ({a!r}, {b!r}) before its parts")
        vocab[a + b] = len(vocab)
        merges.append([a, b])
        return True

    def grow(word: str) -> None:
        for k in range(2, len(word) + 1):
            add(word[:k - 1], word[k - 1])

    split = compile_pattern(LLAMA3_PATTERN)
    seen = {}
    for m in split.finditer(TEXT_CORPUS):
        seen.setdefault("".join(BYTE_CHAR[b] for b in m.group().encode()), None)
    for word in seen:
        grow(word)
    sp, nl = BYTE_CHAR[32], BYTE_CHAR[10]
    lower, upper = string.ascii_lowercase, string.ascii_uppercase
    syms = [chr(c) for c in range(0x21, 0x7F)] + [sp, nl, BYTE_CHAR[9]]
    for a in syms:  # printable ASCII and whitespace pairs
        for b in syms:
            add(a, b)
    for a in lower + upper:  # " ab", " Ab"
        for b in lower:
            add(sp + a, b)
    for a in lower + upper:  # "abc", " abc", "Abc", " Abc"
        for b in lower:
            for c in lower:
                add(a + b, c)
                add(sp + a + b, c)
    for a in string.digits:
        for b in string.digits:
            for c in string.digits:
                add(a + b, c)
    for n in range(1, 16):  # indentation: space runs, newline + spaces
        add(sp * n, sp)
        add(nl + sp * n, sp)
    for w in itertools.product(lower, repeat=4):  # then four letters, in order
        if len(vocab) >= TEXT_VOCAB:
            break
        add("".join(w[:3]), w[3])
    require(len(vocab) == TEXT_VOCAB and len(merges) == TEXT_VOCAB - 256,
            f"synthetic vocabulary: {len(vocab)} entries, {len(merges)} merges")
    specials = _llama3_specials()
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": TEXT_VOCAB + i, "content": s, "single_word": False,
                          "lstrip": False, "rstrip": False, "normalized": False,
                          "special": True} for i, s in enumerate(specials)],
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False}]},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges},
    }
    path.mkdir(parents=True, exist_ok=True)
    (path / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<|begin_of_text|>",
        "eos_token": "<|eot_id|>", "clean_up_tokenization_spaces": True,
        "model_max_length": 8192, "chat_template": LLAMA3_TEMPLATE}))
    return {"merges": len(merges), "corpus_pre_tokens": len(seen)}


def text_weights(spec):
    """Seeded weights for the text checkpoint: init_params, then dim 0
    made a constant TEXT_CONST that no layer reads or writes (its input
    rows and output columns zeroed), and the head's dim-0 row a bias of
    TEXT_BRACE_BIAS on every token holding "{" except "{}"."""
    from dynamo_tpu_torch.models import llama

    params = llama.init_params(spec, TEXT_SEED, device=DEVICE)
    with torch.no_grad():
        params.embed[:, 0] = TEXT_CONST
        for lp in params.layers:
            for k in ("wq", "wk", "wv", "w_gate", "w_up"):
                lp.get(k)[0, :] = 0
            lp.wo[:, 0] = 0
            lp.w_down[:, 0] = 0
        params.lm_head[0, :] = 0
    return params


def brace_bias(params, tokenizer) -> int:
    """Apply TEXT_BRACE_BIAS (text_weights); returns the biased count."""
    vocab = tokenizer._tok.model.vocab
    brace = [i for t, i in vocab.items() if "{" in tokenizer.decode([i]) and t != "{}"]
    with torch.no_grad():
        params.lm_head[0, torch.tensor(brace, device=params.lm_head.device)] = TEXT_BRACE_BIAS
    return len(brace)


def text_host_costs(tok_dir: Path, card: str, V: int):
    """The tokenizer's host costs, each printed beside the card line;
    returns the loaded HFTokenizer."""
    import importlib.util

    from dynamo_tpu_torch.frontend.tokenizer import HFTokenizer, IncrementalDecoder
    from dynamo_tpu_torch.guided import GrammarCompiler, TokenVocab

    t0 = time.perf_counter()
    tok = HFTokenizer(str(tok_dir))
    load_s = time.perf_counter() - t0
    corpus = TEXT_CORPUS + TEXT_EXTRA
    t0 = time.perf_counter()
    ids = tok.encode(corpus)
    enc_cold = (time.perf_counter() - t0) / len(ids)
    t0 = time.perf_counter()
    for _ in range(5):
        tok.encode(corpus)
    enc_warm = (time.perf_counter() - t0) / (5 * len(ids))
    t0 = time.perf_counter()
    text = tok.decode(ids)
    dec = (time.perf_counter() - t0) / len(ids)
    require(text == corpus, "text: decode(encode(corpus)) is not the corpus")
    t0 = time.perf_counter()
    inc = IncrementalDecoder(tok)
    for i in ids:
        inc.push([i])
    inc.flush()
    stream = (time.perf_counter() - t0) / len(ids)
    require(inc.text == corpus, "text: the incremental decode is not the corpus")
    t0 = time.perf_counter()
    tok.apply_chat_template(TEXT_CHATS[0])
    tmpl_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for chat in TEXT_CHATS:
        tok.apply_chat_template(chat)
    tmpl = (time.perf_counter() - t0) / len(TEXT_CHATS)
    t0 = time.perf_counter()
    vocab = TokenVocab.from_tokenizer(tok, V)
    vocab_s = time.perf_counter() - t0
    grammars = guided_grammars(vocab)
    comp = GrammarCompiler(vocab, vocab_size=V)
    g = grammars["json_schema"]
    t0 = time.perf_counter()
    comp.compile(g)
    compile_ms = 1e3 * (time.perf_counter() - t0)
    tdfa = comp.compile(g).tdfa
    states = guided_states(comp, g, GUIDED_SAMPLE_TEXT)
    fresh = [s for s in states if s not in tdfa._masks]
    mask_ms = []
    for s in fresh[:3]:
        t0 = time.perf_counter()
        tdfa.mask(s)
        mask_ms.append(round(1e3 * (time.perf_counter() - t0), 1))
    n = len(ids)
    print(f"text host: HFTokenizer load {load_s:.3f} s ({tok.vocab_size} + "
          f"{len(tok._tok.added)} added); encode {1e6 * enc_cold:.2f} us/token cold, "
          f"{1e6 * enc_warm:.2f} warm; decode {1e6 * dec:.2f} us/token; "
          f"IncrementalDecoder {1e6 * stream:.2f} us/token pushed one by one "
          f"({n} tokens, {len(corpus.encode())} bytes: {n / len(corpus.encode()):.3f} "
          f"tokens/byte); apply_chat_template {1e3 * tmpl_first:.2f} ms first, "
          f"{1e3 * tmpl:.3f} ms after; [{card}]")
    print(f"text host: TokenVocab.from_tokenizer {vocab_s:.2f} s at {V} ids "
          f"({sum(1 for t in vocab.tokens if t)} non-empty); json_schema compile "
          f"{compile_ms:.1f} ms; one new state's mask (the O(V) walk) {mask_ms} ms; "
          f"[{card}]")
    yard = "absent"
    if importlib.util.find_spec("tokenizers") is not None:
        # the yardstick runs in a child process: this script, like the port,
        # imports no tokenizers
        code = ("import json, sys, time\n"
                "from tokenizers import Tokenizer\n"
                "lib = Tokenizer.from_file(sys.argv[1])\n"
                "text = sys.stdin.read()\n"
                "t0 = time.perf_counter()\n"
                "ids = lib.encode(text, add_special_tokens=False).ids\n"
                "print(json.dumps({'s': time.perf_counter() - t0, 'ids': ids}))\n")
        out = subprocess.run([sys.executable, "-c", code, str(tok_dir / "tokenizer.json")],
                             input=corpus, capture_output=True, text=True, timeout=120)
        require(out.returncode == 0, f"text: the tokenizers yardstick failed: {out.stderr}")
        lib = json.loads(out.stdout)
        yard = (f"{1e6 * lib['s'] / len(lib['ids']):.2f} us/token, ids equal: "
                f"{lib['ids'] == ids}")
    print(f"text host: the tokenizers library's encode on the same corpus: {yard}")
    return tok


def stream_text(items, tok) -> str:
    """What the frontend streams for these engine items: each item's ids
    pushed through IncrementalDecoder, as its Backend operator does."""
    from dynamo_tpu_torch.frontend.tokenizer import IncrementalDecoder

    inc = IncrementalDecoder(tok)
    out = [inc.push(x["token_ids"]) for x in items]
    return "".join(out) + inc.flush()


def launches_line(lines: list[str]) -> dict:
    got = [ln for ln in lines if ln.startswith("ENGINE_LAUNCHES ")]
    require(len(got) == 1, f"cli: no ENGINE_LAUNCHES line at exit: {lines[-5:]}")
    return json.loads(got[0][len("ENGINE_LAUNCHES "):])


def text_phase(card: str) -> dict:
    """Phase 17: real text. Returns this phase's launches by kernel."""
    import dataclasses
    import shutil
    import tempfile

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.frontend.tokenizer import MockTokenizer
    from dynamo_tpu_torch.guided import TokenVocab
    from dynamo_tpu_torch.models import loader

    spec = dataclasses.replace(ModelSpec.llama3_8b(), num_layers=CKPT_LAYERS)
    parent = ROOT / "build" / "checkpoints"  # git-ignored
    parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="text-", dir=parent))
    ckpt = tmp / "llama-3-8b-text"
    try:
        t0 = time.perf_counter()
        info = write_llama3_tokenizer(ckpt)
        write_s = time.perf_counter() - t0
        tok = text_host_costs(ckpt, card, spec.vocab_size)
        params = text_weights(spec)
        biased = brace_bias(params, tok)
        loader.save_params(spec, params, str(ckpt))
        del params
        print(f"text: tokenizer.json written in {write_s:.2f} s ({info['merges']} merges, "
              f"{info['corpus_pre_tokens']} corpus pre-tokens grown first); checkpoint "
              f"{spec.name} x {CKPT_LAYERS} layers beside it, {biased} tokens holding "
              f"'{{' biased by {TEXT_BRACE_BIAS}")

        prompts = [tok.encode(tok.apply_chat_template(c)) for c in TEXT_CHATS]
        mock = MockTokenizer()
        mock_n = [len(mock.encode(mock.apply_chat_template(c))) for c in TEXT_CHATS]
        spec2, loaded = loader.load_model_dir(str(ckpt), device=DEVICE)
        # the engine cli run --spec ngram builds: the same config and vocabulary
        engine = InferenceEngine(
            spec2, EngineConfig(pipeline_decode=True, spec_mode="ngram", spec_k_max=8),
            params=loaded, device=DEVICE,
            guided_vocab=TokenVocab.from_tokenizer(tok, spec2.vocab_size))
        engine.precompile()

        async def one_by_one(e):
            return [(await requests(e, [make_request(p, TEXT_TOKENS)]))[0][0]
                    for p in prompts]

        served = serve_phases(engine, [("text", one_by_one)])["text"]
        drop_engine(engine)
        del engine, loaded
        torch.cuda.empty_cache()
        want = [stream_text(items, tok) for items in served["res"]]
        want_ids = [[t for x in items for t in x["token_ids"]] for items in served["res"]]
        require(all(len(w) == TEXT_TOKENS for w in want_ids),
                f"text: in-process engine streams {list(map(len, want_ids))}")

        lines: list[str] = []
        cmd = [sys.executable, "-m", "dynamo_tpu_torch.cli", "run", "--in", "http",
               "--out", "engine", "--model-path", str(ckpt), "--port", "0",
               "--precompile", "--spec", "ngram"]
        name = ckpt.name
        with cli_process(cmd, lines) as (port, t_ready):

            async def post_all():
                res = []
                for chat in TEXT_CHATS:
                    res.append(await http_call(port, "POST", "/v1/chat/completions", {
                        "model": name, "messages": chat, "max_tokens": TEXT_TOKENS,
                        "temperature": 0.0, "ignore_eos": True, "stream": True,
                        "stream_options": {"include_usage": True}}))
                res.append(await http_call(port, "POST", "/v1/chat/completions", {
                    "model": name, "messages": TEXT_JSON_CHAT, "temperature": 0.0,
                    "max_tokens": TEXT_JSON_TOKENS,
                    "response_format": {"type": "json_object"}}))
                return res

            t0 = time.perf_counter()
            got = asyncio.run(post_all())
            wall = time.perf_counter() - t0
        texts, usage = [], []
        for (status, body, _t), p in zip(got[:-1], prompts):
            ev = sse_events(body) if status == 200 else []
            require(status == 200 and ev[-1] == "[DONE]", f"text chat: status {status}, "
                                                           f"{body[:300]!r}")
            texts.append("".join(c["choices"][0]["delta"].get("content") or ""
                                 for c in ev[:-1] if c.get("choices")))
            usage.append(ev[-2]["usage"])
        require([u["prompt_tokens"] for u in usage] == [len(p) for p in prompts],
                f"text: prompt_tokens {[u['prompt_tokens'] for u in usage]} vs the "
                f"tokenizer's {[len(p) for p in prompts]}")
        require(all(u["completion_tokens"] == TEXT_TOKENS for u in usage),
                f"text: completion tokens {usage}")
        same = [t == w for t, w in zip(texts, want)]
        require(all(same), f"text: served streams differ from the in-process engine's: "
                           f"{texts} vs {want}")
        status, body, _t = got[-1]
        js = json.loads(body) if status == 200 else {}
        content = js["choices"][0]["message"]["content"] if js else None
        require(status == 200 and js["choices"][0]["finish_reason"] == "stop",
                f"text json_object: status {status}, {body[:300]!r}")
        try:
            obj = json.loads(content)
        except ValueError:
            obj = None
        require(isinstance(obj, dict), f"text json_object: {content!r} does not parse")
        run1 = launches_line(lines)
        spec_stats = run1["spec"] or {}
        require(spec_stats.get("verifies", 0) > 0 and run1["launches"]["kv_write"] > 0,
                f"text --spec ngram: no verify ran: {run1}")
        print(f"text cli: {' '.join(cmd[1:])}: DYNAMO_HTTP after {t_ready:.1f} s; "
              f"{len(TEXT_CHATS)} streamed chats x {TEXT_TOKENS} tokens and one json_object "
              f"chat in {wall:.3f} s, one at a time; texts equal to the in-process spec "
              f"engine's streamed through IncrementalDecoder ({sum(same)}/{len(same)}), "
              f"e.g. {texts[0]!r}; json_object {content!r} parses ({js['usage']}); "
              f"prompt tokens {[len(p) for p in prompts]} (BPE) vs "
              f"{mock_n} under the mock tokenizer; ENGINE_LAUNCHES {run1}")

        lines2: list[str] = []
        cmd2 = [sys.executable, "-m", "dynamo_tpu_torch.cli", "run", "--in", "http",
                "--out", "engine", "--model-path", str(ckpt), "--port", "0",
                "--guided", "off"]
        with cli_process(cmd2, lines2) as (port, t_ready2):

            async def post_two():
                return [await http_call(port, "POST", "/v1/chat/completions", {
                    "model": name, "messages": TEXT_CHATS[0], "max_tokens": TEXT_TOKENS,
                    "temperature": 0.0, "ignore_eos": True}),
                    await http_call(port, "POST", "/v1/chat/completions", {
                        "model": name, "messages": TEXT_JSON_CHAT,
                        "max_tokens": TEXT_JSON_TOKENS,
                        "response_format": {"type": "json_object"}})]

            (s1, b1, _), (s2, b2, _) = asyncio.run(post_two())
        run2 = launches_line(lines2)
        require(s1 == 200 and json.loads(b1)["usage"]["completion_tokens"] == TEXT_TOKENS,
                f"text --guided off: free chat {s1} {b1[:200]!r}")
        require(s2 != 200 and b"guided" in b2,
                f"text --guided off: the json_object request was served: {s2} {b2[:200]!r}")
        require(run2["launches"]["fused_decode_attention"] > 0 and run2["spec"] is None,
                f"text --guided off: {run2}")
        print(f"text cli --guided off: DYNAMO_HTTP after {t_ready2:.1f} s; a free chat "
              f"served, the json_object chat refused ({s2}: {b2[:120]!r}); spec off; "
              f"ENGINE_LAUNCHES {run2}")
        return {"kv_write/verify": run1["launches"]["kv_write"],
                "fused_decode": run1["launches"]["fused_decode_attention"]
                + run2["launches"]["fused_decode_attention"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
    step_graph_check(engine, prompts, unfused=True)
    unfused_fp8 = unfused_check(engine, prompts)
    drop_engine(engine)
    del engine

    # speculative decoding on the same weights, then on peaked ones
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    (kernels["kv_write/verify"], kernels["kv_write/fp8-verify"], spec_kv_launches,
     spec_kv_fp8_launches) = spec_phase(spec, cfg, params, flush)
    del flush

    # the overload plane on the same weights: priority, preemption, quotas
    overload_launches = overload_phase(spec, cfg, params, prompts)

    # guided decoding on the same weights: masked graphs, a mixed serve,
    # guided x spec
    guided_launches, guided_kv_launches = guided_phase(spec, cfg, params, prompts)

    # the same weights served over HTTP by the one-process stack
    http_launches, http_stats = http_serve(spec, dict(cfg, kv_dtype="bf16"), params,
                                           prompts, default_out, bf16_tokens)
    del params
    torch.cuda.empty_cache()
    # the same stack from the command line, in a process of its own
    cli_check(spec.name)
    # hub, two workers and frontend, each a process of its own
    process_launches = process_phase(spec, cfg, prompts, bf16_tokens, http_stats)

    # MoE and checkpoints: gpt-oss-120b at full width, the llama checkpoint
    # round trip (every llama engine is freed by now)
    t15 = time.perf_counter()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    moe_launches, kernels["fused_decode/gpt-oss"] = moe_phase(cfg, flush)
    del flush
    checkpoint_phase()
    print(f"phase 15: {time.perf_counter() - t15:.1f} s")

    # MLA: deepseek-r1 at full width on bf16 and fp8 latent pools, the
    # latent attention's yardstick, the DeepSeek checkpoint round trip
    t16 = time.perf_counter()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    mla_phase(cfg, flush, card)
    del flush
    mla_checkpoint_check(card)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s")

    # real text: a llama-3-format tokenizer beside a llama-3-8b checkpoint,
    # served through cli run --model-path --spec ngram over HTTP
    t17 = time.perf_counter()
    text_launches = text_phase(card)
    print(f"phase 17: {time.perf_counter() - t17:.1f} s")

    launches = {"fused_decode": serve_launches["fused_decode"] + http_launches
                + process_launches + overload_launches + guided_launches
                + text_launches["fused_decode"],
                "paged_attention_v3": unfused[0], "kv_write": unfused[2],
                "kv_write/verify": spec_kv_launches + guided_kv_launches
                + text_launches["kv_write/verify"],
                "fused_decode/fp8": serve_fp8["fused_decode/fp8"],
                "paged_attention_v3/fp8": unfused_fp8[1],
                "kv_write/fp8": unfused_fp8[3],
                "kv_write/fp8-verify": spec_kv_fp8_launches,
                "fused_decode/gpt-oss": moe_launches}
    sources = {
        "fused_decode": ("dynamo_tpu_torch/csrc/fused_decode.cu",
                         "dynamo_tpu/ops/pallas/fused_decode.py:58"),
        "paged_attention_v3": ("dynamo_tpu_torch/csrc/paged_attention_v3.cu",
                               "dynamo_tpu/ops/pallas/paged_attention_v3.py:76"),
        "kv_write": ("dynamo_tpu_torch/csrc/kv_write.cu",
                     "dynamo_tpu/ops/pallas/kv_write.py:39"),
        # the same kernel at a speculative verify's shape: N x W rows per
        # layer, siblings on shared pages (the reference's write_new_kv call
        # in verify_forward, dynamo_tpu/models/llama.py:716)
        "kv_write/verify": ("dynamo_tpu_torch/csrc/kv_write.cu",
                            "dynamo_tpu/ops/pallas/kv_write.py:39"),
        # the kernels' quantized branches: in-register dequant, and (fused)
        # the requantizing read-modify-write of the destination page
        "fused_decode/fp8": ("dynamo_tpu_torch/csrc/fused_decode.cu",
                             "dynamo_tpu/ops/pallas/fused_decode.py:275"),
        "paged_attention_v3/fp8": ("dynamo_tpu_torch/csrc/paged_attention_v3.cu",
                                   "dynamo_tpu/ops/pallas/paged_attention_v3.py:197"),
        # kv_write's fp8 form: the requantizing append that the kernel's
        # dispatcher sends a QuantPool to (write_new_kv's quantized route),
        # at the unfused decode shape and at a verify's, where the reference
        # lands it one position per call (dynamo_tpu/models/llama.py:710)
        "kv_write/fp8": ("dynamo_tpu_torch/csrc/kv_write.cu",
                         "dynamo_tpu/ops/pallas/kv_write.py:219"),
        "kv_write/fp8-verify": ("dynamo_tpu_torch/csrc/kv_write.cu",
                                "dynamo_tpu/ops/pallas/kv_write.py:219"),
        # the same kernel at gpt-oss-120b's shape (KH 8, G 8, D 64, window
        # 128 on its sliding layers, sinks), launched by phase 15's serves
        "fused_decode/gpt-oss": ("dynamo_tpu_torch/csrc/fused_decode.cu",
                                 "dynamo_tpu/ops/pallas/fused_decode.py:58"),
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
