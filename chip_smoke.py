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
   (b) while it serves, in processes of their own: ``cli bench`` closed
   loop (BENCH_CLOSED: rungs 1 and 8, 16 requests each; gates: 0 errors,
   16 requests per rung, TTFT p50 <= p99, output tok/s higher at 8 than at
   1), ``cli bench`` open loop (BENCH_OPEN, Poisson; gates: 0 errors and
   as many requests as ``loadgen.arrival_times`` schedules for the same
   arguments) and ``cli profile`` (PROFILE_GRID, --max-kv-tokens the
   server's pool; gates: prefill.npz and decode.npz written under the
   git-ignored build/profile_sla/, and the port's interpolators read them
   to finite positive TTFT and throughput); after SIGTERM the server's
   ENGINE_LAUNCHES must show fused_decode once per layer per step. Then,
   the server gone, ``python -m dynamo_tpu_torch.profiling.profile_engine``
   (PROFILE_ENGINE: llama-1b-bench, 64 slots, 16 streams; gates:
   model_steps, requests_done and phases non-empty, 0 graph captures in
   the measured window, its ENGINE_LAUNCHES fused_decode once per layer
   per step), and fused_decode and paged_attention_v3 held against their
   plain versions at that engine's step shape (B 64 of which 16 live, KH
   8, G 2, 13 pages per sequence) and timed there. Prints each rung's and
   the open loop's JSON line, the profile's grids, the dispatch plus
   readmission share of the profile window;
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
   and the poll). (g) The frontend runs with ``--grpc-port 0`` (it prints
   DYNAMO_GRPC=), and before the drain this process drives its KServe
   gRPC surface with GrpcClient, a minimal client on the port's own
   HTTP/2 frames, HPACK and KServe messages (the script needs no grpc
   package; where grpc is installed, the unary call also goes through
   grpc.aio and must give the same bytes): ServerLive, ServerReady,
   ModelReady and ModelMetadata; the 8 prompts as concurrent greedy
   ModelStreamInfer input_ids streams of 32 tokens on cleared caches
   (each ends with triton_final_response; their output_ids equal the TCP
   set's, or are near-argmax under the reference forward; both workers'
   fused_decode launches over the set, read through the admin
   cache_status before and after, 32 per decode step); a unary
   text_input ModelInfer of GRPC_TOKENS tokens; an openai_request chat
   stream whose last message alone carries triton_final_response; a
   stream cancelled with RST_STREAM after its 5th chunk, whose pages the
   worker frees within GRPC_FREE_S; a 50 ms deadline ending
   DEADLINE_EXCEEDED, its pages freed likewise. Printed, not gated: the
   gRPC set's TTFT and ITL beside the HTTP set's, the host cost of
   encoding and framing one stream message. Each set of 8 is timed on
   cleared prefix caches and printed beside phase 9's. Then the survivor, the frontend and the hub
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

18. KVBM (after 14, on the phase-4 weights, before 9): an engine with
   phase 4's config but KVBM_PAGES pages of G1 and a KvBlockManager whose
   G2 holds wave 2 and 3/4 of wave 1 and whose G3 (under build/kvbm/,
   removed at the end) holds the rest: (a) wave 1, phase 4's 8 prompts, 32
   greedy tokens each, every G2 block bitwise equal to its device page; (b)
   wave 2, KVBM_WAVE2 other prompts of 384..448 tokens, after which no
   wave-1 block is left in G1; (c) wave 3, wave 1 again in reverse order:
   hits in G2 and G3,
   each request's onboarded tokens, the onboarded pages bitwise equal to
   their tier blocks, every stream equal to its wave-1 stream up to the
   first reference near-tie (near-argmax both); 32 fused_decode launches
   per decode step and 0 dropped offload batches throughout; (d) a
   KVBM_SINGLE-token prompt alone, TTFT onboarded from G2 against
   recomputed; host ms per onboarded block split into tier get + checksum,
   stack, H2D and insert; the drained batches' gather and D2H device times
   and lag; (e) a new engine and manager on the same G3 (index reloaded)
   serve one wave-1 prompt from G3; (f) the same waves on fp8 pools
   (packed blocks bitwise, a NaN scale re-offered into G2 is a miss and the
   prompt re-prefills); (g) deepseek-r1's latent blocks, bf16 and per-row
   fp8, extract -> insert -> extract bitwise with the inert v slot. Each
   measured line carries the card's name and power limit.

19. disaggregation (after 11, once its workers are gone; phase 4's weights
   drawn again): (a) a prefill and a decode worker in this process on the
   in-memory hub, sharing the weights, the decode worker with
   always_remote_prefill: phase 4's 8 prompts, 32 greedy tokens each,
   through the decode worker's front door; every request ends "length"
   after 32 tokens, the decode engine runs no prefill forward and the
   prefill engine no decode step, the decode pool's sealed prompt pages
   are bitwise equal to the exported blocks, fused_decode launches 32 times
   per decode step, every stream equals phase 4's up to the first
   reference near-tie (near-argmax both), every pull takes the in-process
   route; TTFT against phase 4's, the gather ms per export, the step
   thread's ms per resume and its split by piece, the bytes moved, the
   decode dispatch-to-host while the prefill engine still ran and after;
   (b) the same on fp8 pools
   (packed blocks bitwise, against phase 8's streams); (c) ``cli hub``, a
   ``--mode prefill`` and a ``--mode decode --always-remote-prefill``
   worker (--precompile, phase 1's config) and ``cli frontend``: the 8
   prompts as streamed completions ([DONE], "length", 32 tokens) and over
   the TCP data plane (near-argmax), every pull on the CUDA IPC route with
   0 route fallbacks; the decode worker again with
   DYNAMO_DEVICE_TRANSFER=0, every pull on TCP; GB/s and TTFT by route
   beside phase 11's, the resumes' split by piece, the decode workers'
   dispatch-to-host (all bursts and those with a resume in between)
   beside phase 11's workers'; the admin faults op's disagg.pull error and corrupt
   rules each fall back to a local prefill whose stream equals the clean
   one up to the first near-tie; the prefill worker ran 0 decode steps,
   the decode workers 32 fused_decode launches per step; (d) deepseek-r1's
   latent blocks (4 layers), bf16 and per-row fp8: extract -> export ->
   TCP pull -> insert -> extract bitwise, the int8 v slot under v_dtype.
20. observability (a, b and d after phase 9 on phase 4's weights; c after
   phase 19): (a) a llama-3-8b engine (phase 4's config, profile=True, decode
   graphs precompiled, then reset_profile_window()) serves phase 4's default
   set with a trace file set (tracing.set_trace_file) and an
   EngineCollector attached. Gates: every request's flight-recorder
   timeline is admit -> first_token -> finish "length" with 32 tokens;
   dispatch.compile counts 0 graph captures; dynamo_engine_dispatches_total
   after sample() equals the profile's dispatch.dispatches;
   dynamo_engine_burst_tokens' sum equals the decode tokens streamed (each
   request's first token lands from its prefill's sample); fused_decode
   launches 32 times per decode step; every worker-side span of a request
   (worker.request, engine.queue_wait, engine.prefill, engine.decode)
   carries its timeline's trace id. Prints the profile's phases (seconds,
   calls, share of the serve's wall), packed_prefill beside the TTFT, the
   spans' means, and one packed prefill of the 8 prompts under
   torch.profiler (host wall against device busy); (b) the splits: phase
   13's preempting overload cell (interactive TTFT as engine.queue_wait +
   engine.prefill from the spans, the preempt phase) and phase 14's guided
   mixed serve (guided.mask, build_batch, dispatch and process per step),
   each profiled and gated only by its own stream and launch checks; (c)
   ``cli hub``, one ``cli worker --precompile --health-port 0`` and ``cli
   frontend``, each with DYN_TRACE_FILE of its own, the frontend with
   DYN_AUDIT_PATH; a stdlib client streams the 8 prompts, each with a
   traceparent of its own. Gates: every request's spans, across the files,
   share its trace id, and worker.request's parent is the frontend's
   transport.call; GET /debug/timeline?request_id= returns its events; the
   worker's /metrics shows dynamo_engine_step_seconds_count and
   dynamo_engine_dispatches_total above 0; the audit file holds 8 records of
   32 output tokens; fused_decode 32 per logged step; (d) the default serve
   on (a)'s engine with profiling and tracing off, on, on, off: TTFT, tok/s
   and decode dispatch-to-host (no gate: serves move 25-50% between calls).
   The span, audit and profile files land under build/observability/.
21. multimodal and embeddings (after phase 20 (a, b, d), on phase 4's
   weights): (a) four PNGs the script writes with zlib (solid red and
   blue, a gradient, seeded noise; 375-640 px, none 336) decoded and
   CLIP-preprocessed on the host by multimodal/image.py: finite [3, 336,
   336]; (b) the seeded CLIP ViT-L/14-336 tower in f32 (TF32 off) with the
   encode worker's 1,024 -> 1,024 -> 4,096 projector: ms per image at
   batch 1 and 4 (CUDA events), its rows on the card against the same
   tower on the CPU within MM_TOWER_TOL of their largest magnitude; (c)
   the EPD serve through the port's entry points on one event loop
   (in-memory hub, launch_encode_worker on the tower, launch_engine_worker
   with 576 placeholders per image, a 2,048-token chunk cap and 128 pages
   per sequence, ModelWatcher, HttpFrontend): chats with one and two
   images over HTTP, each TTFT split into frontend + encode hop (the
   encoder's share), queue and prefill from the engine's timeline, beside
   a completion of the same ids as text; 4 concurrent image chats' tok/s.
   Gates: fused_decode 32 per decode step of the image-conditioned
   streams, the same image twice gives the same stream (through the
   frontend pipeline) and hits its cached pages while another image
   misses, the placeholders sit at the card's positions, and the image
   prompt's first-token logits (one prefill with the rows injected, on
   scratch pools) differ from the same ids as text with the served first
   token near-argmax; (d) a --model-type embeddings worker on the same
   weights answers /v1/embeddings for 1 and 8 inputs: unit norms within
   EMB_NORM_TOL, the batch equal to the inputs one by one within
   EMB_EQ_TOL, ms per input; (e) JPEG, GIF and video: the committed
   fixtures of tests/torch_mm_fixtures (a 640x480 baseline 4:2:0 JPEG with
   an ICC profile and restart markers, a 500x375 progressive 4:2:2 one, a
   333x251 grey one, a 320x240 12-frame GIF) decoded on the host, each
   held to the manifest's sha256 of Pillow's RGB array; the GIF sampled
   into 8 frames whose PNG bytes equal the manifest's when this zlib is
   the manifest's (else each frame's pixels do); on an engine worker whose
   chunk cap and top bucket hold one video prompt (5,120 tokens, 320 pages
   per sequence), the JPEG chat through HTTP gives the tower rows and
   greedy tokens of the same chat with the PNG encode_png makes of its
   pixels, and the GIF video chat (8 x 576 placeholder rows) streams with
   fused_decode at 32 launches per step; host ms of each decode and of the
   sampling printed beside the card's name and power limit; (f) WebP, APNG
   and MPO on the same encode and engine workers: the fixtures (a lossy
   640x480 WebP, a lossless 200x150 one with alpha, a 12-frame animated
   WebP and a 12-frame APNG of a moving half-clear disc, a 2-frame MPO)
   decoded on the host and held to the manifest as (e)'s are, the animated
   ones and the MPO sampled into 8 frames (ms per decoded frame printed);
   the lossy WebP chat and the MPO chat (frame 0) give the tower rows and
   greedy tokens of their PNG twins; the animated WebP and the APNG video
   chats stream 8 x 576 placeholder rows; fused_decode 32 per step.
22. tensor parallelism (after phase 17, every engine freed): fused_decode
   at a tp rank's shapes (KH 4 / G 4 and KH 2 / G 8, bf16 and fp8 pools)
   against its plain version, timed beside SDPA and its bound, kv_write
   timed at the same KV heads; (a) llama-3-8b at full width, cut to
   TP8_LAYERS layers, over 2 gloo ranks on this card (spawned processes: the group's bootstrap,
   make_mesh, the rank's shard of the seeded init, the engine behind an
   SPMD leader, a follower shell replaying its descriptors; graphs off by
   its config, as gloo's collectives go through host memory), serving
   phase 4's prompts: the prefill logits within TP_LOGIT_TOL of a one-rank
   engine's on the same weights, the greedy streams equal to its up to
   the first near-tie, each rank's sealed pages within TP_POOL_TOL of the
   matching KV-head slice of its pools (and each gate above its
   tolerance on a planted fault: the prefill with layer 0's w_down
   all-reduce skipped on every rank, each rank's pages against its
   neighbour's heads), fused_decode once per layer per step on every
   rank; per-rank memory, step times and the collectives'
   share (two processes time-slice one card: not tp timings); (b) the
   same at llama-3-70b's width (d 8192, 64/8 heads, FFN 28,672, vocab
   128,256) cut to TP70_LAYERS layers over 4 gloo ranks; (c) tp=1 through
   the distributed path on NCCL (a group of one): the collectives captured
   in the decode and verify graphs, phase 5's and phase 12's graph checks
   (replay bitwise equal to eager), a serve equal to phase 4's streams;
   (d) ``cli hub`` with a ``--mirror leader`` and a ``--mirror follower``
   worker (llama-3-8b at full width cut to MIRROR_LAYERS layers, by
   ``--spec-json``) serving phase 4's prompts over TCP: the follower's pages
   bitwise equal to the leader's (kv_digest); a SIGKILLed follower's
   replacement rejoins through ``__sync__`` and equals the leader again
   after the next serve; descriptor bytes and host us per publish; (e)
   with two cards, (a) under NCCL across them with graphs on, else a line
   saying it was not possible; (f) ``cli worker --tp 2`` (the cut
   llama-3-8b by ``--spec-json``; gloo, both ranks
   on this card, graphs off by ``--no-cuda-graphs``) starting its rank 1
   itself, serving phase 4's prompts over TCP, both ranks answering
   kv_digest over the same pages, and draining with its rank on SIGTERM. Every rank's launches join the kernels
   line (fused_decode/tp2, fused_decode/tp4 at the ranks' shapes).

23. expert parallelism (after phase 22, every engine freed): fused_decode
   at gpt-oss-120b's tp=2 rank shape (KH 4, G 8, D 64, window 128 + sinks,
   bf16 and fp8 pools) against its plain version, timed beside SDPA and
   its bound; then three gloo groups on this card, each after a one-rank
   reference on the same seeded weights (input embedding x 64, eager
   steps; its results kept on the host and the card freed before the
   ranks start): (a) gpt-oss-120b at full width, 4 layers, over ep=2 x
   tp=2, (b) deepseek-r1 at full width, 4 layers (layer 3 holds all 256
   experts), over ep=2 x tp=2, (c) gpt-oss-120b at full width, 2 layers,
   over ep=4 x tp=1 (attention replicated). Each rank joins the group
   (make_mesh(ep, tp)), draws its shard of the seeded init one rank at a
   time, runs phase 15's (16's) prompt alone through a prefill, and serves
   phase 4's first 4 prompts as an SPMD leader or follower. Gates: the
   prefill logits within TP_LOGIT_TOL of one rank's, its dropped slots
   equal to one rank's on every rank, the streams equal up to the
   reference's first near-tie, each rank's pages within TP_POOL_TOL of one
   rank's (its KV heads; MLA's whole latent rows): every layer of the
   prompt alone, layer 0 of the serve's sealed pages (deeper layers follow
   the routing, which a rounding can flip; their worst is printed), the ep
   replicas of each tp coordinate bitwise equal (MLA: all four ranks), fused_decode
   once per layer per step on every rank of (a) and (c) (MLA runs none);
   for (a) and (b) two planted faults read above TP_LOGIT_TOL (the first
   MoE layer's expert-group all-reduce skipped; each rank's experts fed
   its neighbour ep rank's rows). Prints weights per rank, memory and the
   collectives per group. The launches join the kernels line
   (fused_decode/gpt-oss-tp2 for (a), fused_decode/gpt-oss for (c)).

24. pipeline, sequence and data parallelism (after phase 23):
   paged_attention_v3 and kv_write at a pipeline stage's shape (B 4, KH 4,
   G 4, D 128) against their plain versions, timed beside SDPA / two
   index_copy_ calls and their bounds; one-rank references on the same
   seeded weights (llama-3-8b and llama-3-70b's width cut to 4 layers:
   prefill_forward of phase 4's prompts, then greedy decode_forward steps;
   one-rank engines for (d)); then one 4-rank gloo group on this card runs
   (a) llama-3-8b at full width, cut to PP8_LAYERS layers, over pp=2 x
   tp=2: pp_prefill of phase 4's 8 prompts one by one, 32 greedy
   pp_decode_steps at B 8 (microbatches of 4), (b) the same over pp=2 x
   dp=2, (c) llama-3-70b's width, 4 layers, over pp=4 (8 steps), each rank
   drawing its stage of the seeded init; gates: prefill and first decode
   step logits within TP_LOGIT_TOL of one rank's, streams equal up to the
   first near-tie, prompt 0's pages within TP_POOL_TOL of the one-rank
   pools' matching layers and KV heads, kv_write and paged_attention_v3
   once per layer per tick (2 pp - 1 ticks) per step on every rank, (b)'s
   dp replicas' pools bitwise equal; (d) llama-3-8b at full width cut to
   SP_LAYERS layers over sp=2 x tp=2 through InferenceEngine (leader and
   followers): the 2,048-token prompt's ring prefill logits within
   TP_LOGIT_TOL of one rank's, then that prompt and phase 4's 8 (every cold one by ring
   prefill) on bf16 and on fp8 pools, streams equal to one rank's engine up
   to the first near-tie, bf16 pages by block hash within TP_POOL_TOL, the
   sp replicas' pools bitwise equal; (e) ``cli worker`` with an EngineConfig
   of dp=2 (llama-3-8b at full width, 4 layers): the replicas' pools
   bitwise equal. Prints weights per rank, the collectives per step and
   group with bytes, and its walls marked NOT pp/sp timings. The launches
   join the kernels line (kv_write/pp, paged_attention_v3/pp for (a)-(c);
   fused_decode/tp2 for (d); fused_decode for (e)).

25. disaggregated serving under tensor parallelism and the gateway (after
   phase 24): llama-3-8b at full width, cut to TP8_LAYERS layers, phase 4's
   config; a hub in this process and six spawned gloo ranks on this card: a
   prefill worker group of tp=2 (``launch_engine_worker(mode="prefill")``
   on rank 0, its rank 1 exporting from a transfer source of its own; the
   leader also advertised for its mirror), a decode worker group of tp=2
   (``mode="decode"``, every prompt prefilled remotely) and the prefill
   group's mirror of tp=2 (rank 0 following the leader and relaying to its
   rank 1); in this process a one-rank decode worker on the same seeded
   weights. (a) phase 4's 8 prompts through the tp=2 decode worker's front
   door: every resume by shard (rank 1 pulls its own at the leader's
   intake, op kv_prefetch), each decode rank's installed pages bitwise
   equal to its prefill twin's export (sha256 per page, hashed after the
   serve, outside the timed spans), 0 route and pull fallbacks,
   fused_decode once per layer per step on both decode ranks, streams
   equal to phase 22 (a)'s aggregated tp=2 group up to the first
   near-tie; prints the per-shard CUDA IPC pulls' ms and GB/s and the step
   thread's kv_export and kv_resume ms per rank; (b) 3 prompts
   through the one-rank decode worker: whole TCP pulls whose blocks are
   bitwise the two shards joined on the heads axis, their ms and GB/s;
   (c) an embedding request on the tp=2 group within EMB25_TOL of one
   rank's vector; (d) the mirror ranks' pages bitwise equal to their
   prefill-group twins' after the serve, and after the mirror's rank 0
   lost its stream and rejoined through the sync and 2 more prompts; (e)
   the EPP (gateway/epp.py) in front of both decode workers: a warm prompt
   picked to its prefix's worker with the GIE header, the pickline pick
   equal to the HTTP pick, pick p50 / p99 us for both over EPP_PICKS picks;
   (f) a one-rank export of a P25_F_TOKENS-token prompt (a prefill engine
   in this process) resumed by the tp=2 decode group in mode scatter: the
   leader pulls the whole blocks and sends rank 1 its heads over the
   group, each rank's install bitwise its heads of the export, the stream
   equal to one rank's up to the first near-tie, kv_resume ms per rank.
   Its timings are NOT tp timings (six processes time-slice one card). The
   decode ranks' launches join fused_decode/tp2, the one-rank worker's
   fused_decode.

26. the scaling plane (after phase 25): ``cli hub``, ``cli frontend``,
   ``cli operator --backend process`` (its workers' output under the
   git-ignored build/scaling/workers/) and ``cli planner``, each a process;
   a DynamoGraphDeployment with one ``decode`` service whose command is
   ``-m dynamo_tpu_torch.engine.worker`` serving llama-3-8b at full width
   cut to TP8_LAYERS layers (``--spec-json``, ``--precompile``, on this
   card), 1 replica; the planner with ``--load-predictor constant
   --no-correction``, a SCALE_INTERVAL_S interval, ``--min-endpoint 1``,
   ``--max-chip-budget`` SCALE_BUDGET (its prefill replica holds one chip
   of the budget, so 2 would cap decode at 1) and a profile written from
   phase 4's readings (tok/s per chip, dispatch-to-host as the ITL, TTFT,
   the packed prefill's tok/s). Streamed token-id completions through the
   frontend in groups of SCALE_GROUP at SCALE_LOAD x the profile's tok/s:
   burst 1 until the planner writes decode 2 and the operator's second
   worker registers, burst 2 for SCALE_BURST2_INTERVALS intervals, then a
   trickle of one request per interval (the planner skips an interval with
   no completed request, as the reference's) until it writes decode 1 and
   the operator SIGTERMs the second worker, which drains. Gates: every
   stream of every set ends "length" with its full token count; the
   desired key's revisions and the operator's status go 1 -> 2 -> 1; each
   worker's own ForwardPassMetrics (kv_metrics.dynamo/backend) show
   running requests with step_time_ms > 0, the scaled-up worker's during
   burst 2; each worker's ENGINE_LAUNCHES has fused_decode once per layer
   per step. Then ``AutoscaleController`` in this process, FleetTelemetry on
   the same hub and K8sBackend on the same DGD: SCALE_AS_STREAMS concurrent
   streams make its signal from the worker's metrics, its plan (2 workers)
   goes to the planner key, the operator converges it and the new worker
   registers. Prints the decisions and their intervals, desired-to-ready
   and drain times, each worker's peak running requests and step ms, TTFT
   and ITL per set; two workers time-slice the card, so not a capacity
   gain. The workers' launches join fused_decode.

27. the replicated and the durable hub (after phase 26): (a) three ``cli
   hub-replica`` processes (``--lease-s`` HUB27_LEASE_S, data dirs under
   the git-ignored build/hub27/), ``cli frontend`` and ``cli worker``
   serving llama-3-8b at full width cut to TP8_LAYERS layers (as phase
   26's workers, ``--precompile``, on this card), each given the whole
   address list with the elected leader first (so both hold their hub
   connection to the replica that dies). Streamed token-id completions of SERVE_TOKENS tokens, two
   at a time, through the frontend; after HUB27_BEFORE have finished the
   leader replica is SIGKILLed while streams run; a writer in this process
   puts a key every HUB27_WRITE_S through the port's RemoteHub all phase
   long; the killed replica restarts on its address and data dir and
   catches up; HUB27_AFTER more streams after that. Gates: every stream
   ends "length" after SERVE_TOKENS tokens; every write acked; one leader
   per term in the replicas' statuses; the frontend's /health counts the
   worker's instance at every poll and no delete of its key is seen;
   ``sim.cluster.check_cluster_invariants`` holds on the three data dirs
   with the worker's registration inside the committed prefix; the
   worker's ENGINE_LAUNCHES has fused_decode once per layer per step.
   Prints kill to new leader, the writer's longest gap between acks,
   restart to caught up, the client failover counters (this process's and
   the frontend's), TTFT and ITL of the streams before, during and after
   the election. (b) ``cli hub --data-dir build/hub27/single`` with ``cli
   mocker`` and ``cli frontend``: the hub SIGKILLed and restarted on its
   port and dir must answer with the same boot_id, the model card and the
   instance key (no write to them in its WAL since the restart), and the
   frontend must serve a chat after it. No kernel of its own: the worker
   of (a) is the card's part, and its launches join fused_decode.

Phases run in the order 1-8, 12, 13, 14, 18, 9, 20 (a, b, d), 21, 10, 11,
19, 20 (c), 15, 16, 17, 22, 23, 24, 25, 26, 27.
``python3 chip_smoke.py --phase10`` (``--phase21``) runs the build and
phase 10 with (b) (phase 21) alone: no kernel table, no final line.

Prints, before the last line, the card line and one JSON object with every
kernel's measurements; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import asyncio
import base64
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
# phase 10 (b): cli bench's closed and open loops, cli profile's grid and
# profile_engine's rung, each in a process of its own (TOOL_S at most)
BENCH_CLOSED = ("--concurrency", "1,8", "--num-requests", "16", "--isl", "256",
                "--osl", "32", "--warmup", "2", "--seed", "0")
BENCH_OPEN = dict(arrival="poisson", rate=4.0, duration=10.0, isl=256, osl=32, seed=0)
PROFILE_GRID = ("--isl-grid", "64,512", "--concurrency-grid", "1,8", "--context-grid",
                "128,512", "--osl", "16", "--requests-per-point", "2")
PROFILE_ENGINE = ("--concurrency", "16", "--secs", "5", "--warm-secs", "3")
TOOL_S = 180
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
# phase 11 (g), the frontend's KServe gRPC surface: the chat and unary
# requests' tokens, the cancelled stream's chunk, the deadline, and the
# limit for the worker to free a cancelled or timed-out request's pages
GRPC_TOKENS = 16
GRPC_CANCEL_AFTER = 5
GRPC_DEADLINE_MS = 50
GRPC_FREE_S = 2.0
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
# phase 18 (KVBM): G1 of KVBM_PAGES pages, so that wave 2's KVBM_WAVE2
# prompts of 384..448 tokens evict every page of wave 1; G3 under KVBM_DIR
# (removed at the end); a KVBM_SINGLE-token prompt served alone, onboarded
# and recomputed KVBM_AB times each
KVBM_PAGES = 256
KVBM_WAVE2 = 12
KVBM_SINGLE = 512
KVBM_AB = 2
KVBM_DIR = ROOT / "build" / "kvbm"
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


def new_engine(spec, cfg, label, params=None, kvbm=None):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.core import InferenceEngine

    t0 = time.perf_counter()
    engine = InferenceEngine(spec, EngineConfig(**cfg), params=params, device=DEVICE,
                             kvbm=kvbm)
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


# ------------------------------------------------------------ KVBM


def kvbm_wave2_prompts(vocab: int):
    """Wave 2 of phase 18: KVBM_WAVE2 prompts of 384..448 tokens, none
    sharing a block with phase 4's prompts. Their pages (with 32 tokens
    each) outnumber KVBM_PAGES, so every wave-1 page leaves G1, while the 8
    that decode at once fit (8 streams that each hold ~31 pages and need 2
    more stall one another in a 256-page pool)."""
    rng = np.random.default_rng(1818)
    lens = rng.integers(384, 449, size=KVBM_WAVE2)
    return [rng.integers(3, vocab, int(n)).tolist() for n in lens]


def kvbm_hashes(prompt, page: int = 16) -> list[int]:
    from dynamo_tpu_torch.tokens import TokenBlockSequence

    return TokenBlockSequence.from_tokens(prompt, page).sequence_hashes()


def kvbm_budgets(waves, block_bytes: int) -> tuple[int, int, int, int]:
    """(G2 bytes, G3 bytes, wave-1 blocks, wave-2 blocks): G2 holds wave 2
    and three quarters of wave 1, so wave 3 finds wave 1's oldest quarter
    in G3, and its newest blocks still in G2 after the G3 hits' promotions
    have pushed a quarter more down.
    Blocks per prompt: the distinct sealed blocks of prompt + 31 decoded
    tokens (estimated by the prompt's own hashes plus its decode blocks)."""
    counts = []
    for prompts in waves:
        seen = set()
        extra = 0
        for p in prompts:
            seen.update(kvbm_hashes(p))
            extra += (len(p) + SERVE_TOKENS - 1) // 16 - len(p) // 16
        counts.append(len(seen) + extra)
    w1, w2 = counts
    return (w2 + 3 * w1 // 4) * block_bytes, 2 * (w1 + w2) * block_bytes, w1, w2


def kvbm_manager(kv_dir: Path, g2: int, g3: int):
    from dynamo_tpu_torch.kvbm import KvbmConfig, KvBlockManager

    return KvBlockManager(KvbmConfig(host_bytes=g2, disk_bytes=g3, disk_dir=str(kv_dir)))


async def kvbm_serve(engine, prompts, n=SERVE_TOKENS):
    """All ``prompts`` at once, greedy, ``n`` tokens each; then the offload
    flushed. Returns the streams, TTFTs (host clock from each submit), the
    request ids, the wall, and the tiers' counters and bytes after."""
    from dynamo_tpu_torch.runtime.context import Context

    t0 = time.perf_counter()
    ctxs = [Context() for _ in prompts]

    async def one(i):
        t_sub, first, toks, last = time.perf_counter(), None, [], None
        async for item in engine.generate(make_request(prompts[i], n), ctxs[i]):
            if item["token_ids"] and first is None:
                first = time.perf_counter() - t_sub
            toks += item["token_ids"]
            last = item
        require(last["finish_reason"] == "length" and len(toks) == n,
                f"kvbm request {i}: {len(toks)} tokens, finish {last['finish_reason']} "
                f"{last.get('error', '')}")
        return toks, first

    out = await asyncio.gather(*(one(i) for i in range(len(prompts))))
    wall = time.perf_counter() - t0
    await asyncio.to_thread(engine.offload.flush, 120.0)
    return {"tokens": [o[0] for o in out], "ttft": [o[1] for o in out], "wall": wall,
            "ids": [c.id for c in ctxs], "stats": engine.kvbm.stats.to_dict(),
            "tier_bytes": engine.kvbm.tier_bytes(), "dropped": engine.offload.dropped,
            "batches": len(engine.offload.batches)}


def kvbm_tier_block(kvbm, sh: int):
    """A block's bytes in G2, else G3, without touching the hit counters."""
    blk = kvbm.host.get(sh)
    if blk is None and kvbm.disk is not None:
        blk = kvbm.disk.get(sh)
    return blk


def kvbm_device_equal(engine, kvbm, shs, pages) -> int:
    """Each tier block of ``shs`` bitwise equal to ``extract_pages`` of its
    device page (packed bytes on fp8). Returns the blocks compared."""
    from dynamo_tpu_torch.kvbm.offload import block_numpy

    ids = torch.tensor(pages, device=DEVICE)
    kb, vb = engine.fam.extract_pages(engine.k_pages, engine.v_pages, ids)
    kb, vb = block_numpy(kb.cpu()), block_numpy(vb.cpu())
    n = 0
    for i, sh in enumerate(shs):
        blk = kvbm_tier_block(kvbm, sh)
        require(blk is not None, f"kvbm: block {sh:016x} in no tier")
        require(np.array_equal(blk[0], kb[:, i]) and np.array_equal(blk[1], vb[:, i]),
                f"kvbm: tier block {sh:016x} differs from its device page")
        n += 1
    return n


async def kvbm_clear_g1(engine) -> None:
    """The admin cache clear, honoured by the step thread; returns once G1
    holds no cached page."""
    engine.request_clear_cache()
    for _ in range(2000):
        if not engine._clear_cache_requested and engine.allocator.evictable_pages == 0:
            return
        await asyncio.sleep(0.005)
    raise SmokeError("kvbm: G1 clear not honoured")


def kvbm_batches_line(batches, label, card) -> None:
    """The offload's drained batches: gather and D2H device times (CUDA
    events on the compute and the copy stream), bytes, and the lag from the
    drain to the last offer (host clock)."""
    if not (batches and all(b["gather_ms"] is not None for b in batches)):
        require(False, f"kvbm {label}: no timed offload batch")
        return
    mib = [b["bytes"] / 2**20 for b in batches]
    g = [b["gather_ms"] for b in batches]
    c = [b["copy_ms"] for b in batches]
    lag = [1e3 * b["lag_s"] for b in batches]
    big = max(range(len(batches)), key=lambda i: mib[i])
    rate = sum(b["bytes"] for b in batches) / (sum(g) + sum(c)) / 1e6
    print(f"kvbm {label} offload: {len(batches)} drained batches, {sum(mib):.1f} MiB; "
          f"extract (gather) mean {sum(g) / len(g):.3f} ms, D2H mean {sum(c) / len(c):.3f} ms, "
          f"{rate:.2f} GB/s over both; largest batch {mib[big]:.1f} MiB in {g[big]:.3f} + "
          f"{c[big]:.3f} ms = {batches[big]['bytes'] / (g[big] + c[big]) / 1e6:.2f} GB/s; "
          f"lag drain-to-offer mean {sum(lag) / len(lag):.1f} ms, max {max(lag):.1f} ms "
          f"(host) [{card}]")


def kvbm_onboard_split(engine, kvbm, shs, g3, card, label) -> None:
    """Host ms per onboarded block, split into the tier get with its
    checksum verify (``shs`` from G2; ``g3``, other blocks, from G3), the
    stack, the H2D copy and the in-place insert (host clock, synchronised),
    on the engine's own pools; the inserted pages read back bitwise."""
    from dynamo_tpu_torch.kvbm.offload import block_tensor

    n = len(shs)
    t = {"get": [], "get_g3": [], "stack": [], "h2d": [], "insert": []}
    for _ in range(3):
        t0 = time.perf_counter()
        blocks = kvbm.get_consecutive(shs)
        t1 = time.perf_counter()
        require(len(blocks) == n, f"kvbm {label}: {len(blocks)} of {n} blocks in the tiers")
        ks = np.stack([b[0] for b in blocks], axis=1)
        vs = np.stack([b[1] for b in blocks], axis=1)
        t2 = time.perf_counter()
        kd, vd = block_tensor(ks).to(DEVICE), block_tensor(vs).to(DEVICE)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        pages = [engine.allocator.alloc_page() for _ in range(n)]
        ids = torch.tensor(pages, device=DEVICE)
        t4 = time.perf_counter()
        engine.fam.insert_pages(engine.k_pages, engine.v_pages, ids, kd, vd)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        back = engine.fam.extract_pages(engine.k_pages, engine.v_pages, ids)
        require(all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                    for a, b in zip(back, (kd, vd))),
                f"kvbm {label}: inserted pages differ from the tier blocks")
        engine.allocator.release(pages)
        t6 = time.perf_counter()
        for sh in g3:
            require(kvbm.disk.get(sh) is not None, f"kvbm {label}: G3 read failed")
        t7 = time.perf_counter()
        for k, v in (("get", t1 - t0), ("stack", t2 - t1), ("h2d", t3 - t2),
                     ("insert", t5 - t4)):
            t[k].append(1e3 * v / n)
        if g3:
            t["get_g3"].append(1e3 * (t7 - t6) / len(g3))
    mib = (ks[:, 0].nbytes + vs[:, 0].nbytes) / 2**20
    g3_ms = f"{min(t['get_g3']):.3f}" if t["get_g3"] else "not measured (no block in G3)"
    total = sum(min(t[k]) for k in ("get", "stack", "h2d", "insert"))
    print(f"kvbm {label} onboard, host ms per block ({n} blocks of {mib:.3f} MiB, best of 3): "
          f"G2 get + checksum {min(t['get']):.3f}, stack {min(t['stack']):.3f}, H2D "
          f"{min(t['h2d']):.3f}, insert {min(t['insert']):.3f}; {total:.3f} in all "
          f"({mib / total * 1.048576:.2f} GB/s); G3 get + checksum {g3_ms} [{card}]")


def kvbm_g3_blocks(kvbm, prompts, n: int = 32) -> list[int]:
    """Up to ``n`` wave-1 blocks held in G3."""
    return [sh for p in prompts for sh in kvbm_hashes(p) if sh in kvbm.disk][:n]


def kvbm_mla_roundtrip(card) -> None:
    """deepseek-r1's latent cache at full width (2 layers, page 16), bf16
    and per-row fp8: extract -> insert into other pages -> extract is
    bitwise, the pools keep their storage, the v slot is the reference's
    inert int8 [1, n]."""
    from dynamo_tpu_torch.models.family import MlaFamily

    spec, fam = deepseek_spec(2), MlaFamily()
    g = torch.Generator(device=DEVICE).manual_seed(18)
    src, dst = [3, 9, 17, 30], [1, 2, 5, 31]
    for kv in ("bf16", "fp8"):
        cache, v = fam.init_cache(spec, 33, 16, device=DEVICE, kv_dtype=kv)
        if kv == "fp8":
            cache.vals.view(torch.uint8).copy_(torch.randint(
                0, 0x7F, cache.vals.shape, generator=g, device=DEVICE, dtype=torch.uint8))
            cache.scale.copy_(torch.rand(cache.scale.shape, generator=g, device=DEVICE))
            ptr = cache.vals.data_ptr()
        else:
            cache.copy_(torch.randn(cache.shape, generator=g, device=DEVICE))
            ptr = cache.data_ptr()
        kb, vb = fam.extract_pages(cache, v, torch.tensor(src, device=DEVICE))
        require(vb.dtype == torch.int8 and tuple(vb.shape) == (1, len(src)),
                f"kvbm mla {kv}: v slot {tuple(vb.shape)} {vb.dtype}")
        fam.insert_pages(cache, v, torch.tensor(dst, device=DEVICE), kb, vb)
        again, _ = fam.extract_pages(cache, v, torch.tensor(dst, device=DEVICE))
        require((cache.vals if kv == "fp8" else cache).data_ptr() == ptr,
                f"kvbm mla {kv}: the insert moved the cache")
        require(torch.equal(again.view(torch.uint8), kb.view(torch.uint8)),
                f"kvbm mla {kv}: extract -> insert -> extract is not bitwise")
        print(f"kvbm mla {kv}: deepseek-r1 latent blocks {tuple(kb.shape)} {kb.dtype} "
              f"({kb[:, 0].nbytes} B per block), v slot {tuple(vb.shape)} int8; extract -> "
              f"insert -> extract bitwise, in place [{card}]")


def kvbm_engine(spec, cfg, params, kvbm, label):
    return new_engine(spec, dict(cfg, num_pages=KVBM_PAGES), label, params=params, kvbm=kvbm)


def kvbm_waves(spec, cfg, params, prompts, wave2, kv_dir, kv_dtype, card,
               single=None) -> dict:
    """Waves 1-3 (and, with ``single``, the prompt alone onboarded vs
    recomputed) on one KVBM engine of ``kv_dtype``; the checks on the
    tiers' bytes run between the waves, the engine idle."""
    import shutil

    shutil.rmtree(kv_dir, ignore_errors=True)
    label = f"kvbm {kv_dtype}"
    want = kvbm_block_bytes(spec, kv_dtype)
    g2, g3, w1, w2 = kvbm_budgets((prompts, wave2), want)
    kvbm = kvbm_manager(kv_dir, g2, g3)
    engine = kvbm_engine(spec, dict(cfg, kv_dtype=kv_dtype), params, kvbm, label)
    block_bytes = engine.pool_bytes // (KVBM_PAGES + 1)  # one page of both pools
    require(block_bytes == want, f"{label}: block {block_bytes} B, expected {want}")
    print(f"{label}: G1 {KVBM_PAGES} pages, block {block_bytes} B; G2 {g2 / 2**20:.0f} MiB "
          f"({g2 // block_bytes} blocks = wave 2's ~{w2} + 3/4 of wave 1's ~{w1}), G3 "
          f"{g3 / 2**20:.0f} MiB under {kv_dir.relative_to(ROOT)}")
    res: dict = {"engine": engine, "kvbm": kvbm, "block_bytes": block_bytes}

    async def wave1(engine):
        out = await kvbm_serve(engine, prompts)
        n = 0
        for p in prompts:
            shs = kvbm_hashes(p)
            pages = engine.allocator.match_prefix(shs)
            n += kvbm_device_equal(engine, kvbm, shs[:len(pages)], pages)
        out["compared"] = n
        return out

    async def wave2_(engine):
        out = await kvbm_serve(engine, wave2)
        left = sum(len(engine.allocator.match_prefix(kvbm_hashes(p))) for p in prompts)
        require(left == 0, f"{label}: {left} wave-1 blocks still in G1 after wave 2")
        return out

    async def wave3(engine):
        # in reverse order: in wave 1's order each G3 hit's promotion would
        # push the next prompt's blocks out of G2 (an LRU walked in its own
        # order), and every hit would come from G3
        out = await kvbm_serve(engine, prompts[::-1])
        for k in ("tokens", "ttft", "ids"):
            out[k] = out[k][::-1]
        by_id = {rid: (first, n) for rid, first, n in engine.onboards}
        out["onboarded"] = [by_id.get(rid, (0, 0)) for rid in out["ids"]]
        n = 0
        for p, (first, cnt) in zip(prompts, out["onboarded"]):
            shs = kvbm_hashes(p)[first: first + cnt]
            pages = engine.allocator.match_prefix(kvbm_hashes(p))[first: first + cnt]
            require(len(pages) == cnt, f"{label}: onboarded pages left G1")
            n += kvbm_device_equal(engine, kvbm, shs, pages)
        out["compared"] = n
        return out

    phases = [("wave1", wave1), ("wave2", wave2_), ("wave3", wave3)]
    if kv_dtype == "fp8":
        phases.append(("corrupt", lambda e: kvbm_corrupt(e, kvbm, prompts)))
    if single is not None:
        phases.append(("single", lambda e: kvbm_single(e, kvbm, single)))
    res["out"] = serve_phases(engine, phases)
    return res


def kvbm_block_bytes(spec, kv_dtype: str) -> int:
    """Bytes of one page of both pools: K and V, values and (fp8) scales."""
    elems = spec.num_layers * spec.num_kv_heads * 16 * spec.head_dim
    if kv_dtype == "fp8":
        return 2 * (elems + spec.num_layers * spec.num_kv_heads * 2)
    return 2 * elems * 2


async def kvbm_corrupt(engine, kvbm, prompts):
    """A wave-1 block re-offered with NaN bits in its scale tail (its
    checksum stamped, so only the scale check sees it): the onboard
    evicts it, counts a miss and the prompt re-prefills."""
    from dynamo_tpu_torch.ops.quant import packed_block_ok

    i = next(i for i, p in enumerate(prompts) if kvbm_hashes(p)[0] in kvbm.host)
    sh = kvbm_hashes(prompts[i])[0]
    await kvbm_clear_g1(engine)
    k, v = kvbm.host.get(sh)
    bad = np.array(k, copy=True)
    bad[0, -2:] = np.array([0xC0, 0x7F], np.uint8)  # bf16 NaN, little-endian
    kvbm.host.remove(sh)
    kvbm.offer(sh, bad, v)
    misses = kvbm.stats.onboard_misses
    out = await kvbm_serve(engine, [prompts[i]])
    again = kvbm.host.get(sh)
    n, tail = bad.shape[-1], 2 * engine.k_pages.scale.shape[-1]
    out.update(prompt=i, misses=kvbm.stats.onboard_misses - misses,
               resealed=again is not None and packed_block_ok(again, n, tail),
               onboarded=[(f, c) for rid, f, c in engine.onboards if rid == out["ids"][0]])
    return out


async def kvbm_single(engine, kvbm, prompt):
    """One KVBM_SINGLE-token prompt alone, 2 tokens: TTFT onboarded from G2
    (G1 cleared) against TTFT recomputed (G1 cleared and its blocks
    removed from G2 and G3), KVBM_AB times each, in turns."""
    shs = kvbm_hashes(prompt)
    await kvbm_serve(engine, [prompt], 2)  # its blocks into G2
    ttft = {"onboard": [], "recompute": []}
    for mode in ("onboard", "recompute", "recompute", "onboard")[: 2 * KVBM_AB]:
        await kvbm_clear_g1(engine)
        if mode == "recompute":
            for sh in shs:
                kvbm.host.remove(sh)
                kvbm.disk.remove(sh)
        else:
            require(all(sh in kvbm.host for sh in shs[:(len(prompt) - 1) // 16]),
                    "kvbm single: the prompt's blocks are not all in G2")
        out = await kvbm_serve(engine, [prompt], 2)
        ttft[mode].append(out["ttft"][0])
    return ttft


def kvbm_report(spec, params, prompts, r, kv_dtype, card, phase4_disp_ms) -> int:
    """Checks and lines of one engine's waves. Returns its fused_decode
    launches."""
    out, L = r["out"], spec.num_layers
    label = f"kvbm {kv_dtype}"
    fp8 = kv_dtype == "fp8"
    launches = 0
    for name, o in out.items():
        counts, steps = o["counts"], o["steps"]
        require(counts["fused_decode"] == L * steps == L * o["replays"],
                f"{label} {name}: fused_decode {counts['fused_decode']} over {steps} steps, "
                f"{o['replays']} replays")
        require(counts["fused_decode/fp8"] == (counts["fused_decode"] if fp8 else 0),
                f"{label} {name}: fused_decode in fp8 form {counts['fused_decode/fp8']}")
        launches += counts["fused_decode"]
    w1, w2, w3 = (out[k]["res"] for k in ("wave1", "wave2", "wave3"))
    d3 = {k: w3["stats"][k] - w2["stats"][k] for k in w3["stats"]}
    require(d3["onboard_hits_host"] > 0 and d3["onboard_hits_disk"] > 0,
            f"{label} wave 3: hits {d3}")
    require(w3["dropped"] == 0, f"{label}: {w3['dropped']} offload batches dropped")
    agree = []
    for i, p in enumerate(prompts):
        same, tie = equal_to_first_near_tie(spec, params, p, w3["tokens"][i], w1["tokens"][i])
        require(same >= tie, f"{label} wave 3 request {i}: parts from wave 1 at token {same}, "
                             f"before the first reference near-tie at {tie}")
        agree.append((same, tie))
    onboarded = [16 * c for _f, c in w3["onboarded"]]
    require(sum(onboarded) > 0, f"{label} wave 3 onboarded nothing")
    for w, name in ((w1, "wave 1"), (w2, "wave 2"), (w3, "wave 3")):
        o = out[name.replace(" ", "")]
        disp = 1e3 * sum(o["times"]) / max(len(o["times"]), 1)
        print(f"{label} {name}: {len(w['tokens'])} requests x {SERVE_TOKENS} tokens in "
              f"{w['wall']:.3f} s; TTFT mean {1e3 * sum(w['ttft']) / len(w['ttft']):.1f} ms, "
              f"max {1e3 * max(w['ttft']):.1f} ms; dispatch-to-host mean {disp:.2f} ms over "
              f"{len(o['times'])} dispatches; kvbm {w['stats']}; tier_bytes {w['tier_bytes']}; "
              f"offload dropped {w['dropped']} [{card}]")
    disp1 = 1e3 * sum(out["wave1"]["times"]) / len(out["wave1"]["times"])
    print(f"{label}: wave 1 dispatch-to-host mean {disp1:.2f} ms with KVBM against phase 4's "
          f"{phase4_disp_ms:.2f} ms without (the same 8 prompts) [{card}]")
    print(f"{label} wave 3: onboarded tokens per request {onboarded} (G2 hits "
          f"{d3['onboard_hits_host']}, G3 hits {d3['onboard_hits_disk']}, misses "
          f"{d3['onboard_misses']}); streams equal to wave 1's up to (first difference, "
          f"first near-tie) {agree}; tier blocks bitwise equal to their device pages: "
          f"{w1['compared']} after wave 1, {w3['compared']} onboarded after wave 3 [{card}]")
    engine = r["engine"]
    kvbm_batches_line(list(engine.offload.batches)[: w1["batches"]], f"{kv_dtype} wave 1", card)
    if fp8:
        c = out["corrupt"]["res"]
        require(c["misses"] >= 1 and c["resealed"] and not c["onboarded"],
                f"{label} corrupt scale: misses {c['misses']}, resealed {c['resealed']}, "
                f"onboarded {c['onboarded']}")
        same, tie = equal_to_first_near_tie(spec, params, prompts[c["prompt"]],
                                            c["tokens"][0], w1["tokens"][c["prompt"]])
        require(same >= tie, f"{label} corrupt scale: the re-prefilled stream parts at {same}")
        print(f"{label} corrupt scale: request {c['prompt']}'s first block re-offered with a NaN "
              f"scale: 1 miss, evicted, re-prefilled (TTFT {1e3 * c['ttft'][0]:.1f} ms), "
              f"re-offloaded finite; stream equal to wave 1's up to ({same}, {tie}) [{card}]")
    if "single" in out:
        s = out["single"]["res"]
        print(f"kvbm single {KVBM_SINGLE}-token prompt alone: TTFT onboarded from G2 "
              f"{', '.join(f'{1e3 * x:.1f}' for x in s['onboard'])} ms against recomputed "
              f"(G1, G2 and G3 cleared of it) {', '.join(f'{1e3 * x:.1f}' for x in s['recompute'])}"
              f" ms [{card}]")
    return launches


def kvbm_restart(spec, cfg, params, prompts, w1_tokens, kv_dir, g2, g3, card) -> int:
    """A new engine and a new KvBlockManager on the same G3 directory (its
    index reloaded) serve one wave-1 prompt alone: it must onboard from G3.
    Returns its fused_decode launches."""
    kvbm = kvbm_manager(kv_dir, g2, g3)
    require(len(kvbm.disk) > 0, "kvbm restart: the G3 index reloaded empty")
    i = max((i for i, p in enumerate(prompts) if kvbm_hashes(p)[0] in kvbm.disk),
            key=lambda i: len(prompts[i]))
    engine = kvbm_engine(spec, dict(cfg, kv_dtype="bf16"), params, kvbm, "kvbm restart")
    out = serve_phases(engine, [("restart", lambda e: kvbm_serve(e, [prompts[i]]))])["restart"]
    drop_engine(engine)
    del engine
    L, o = spec.num_layers, out["res"]
    require(out["counts"]["fused_decode"] == L * out["steps"] == L * out["replays"],
            f"kvbm restart: fused_decode {out['counts']['fused_decode']} over {out['steps']} steps")
    require(o["stats"]["onboard_hits_disk"] > 0, f"kvbm restart: no G3 hit ({o['stats']})")
    same, tie = equal_to_first_near_tie(spec, params, prompts[i], o["tokens"][0], w1_tokens[i])
    require(same >= tie, f"kvbm restart: the stream parts from wave 1's at {same}")
    print(f"kvbm restart: a new engine and manager on the same G3 ({len(kvbm.disk)} blocks "
          f"reloaded from its index) served request {i} ({len(prompts[i])} tokens) alone: G3 "
          f"hits {o['stats']['onboard_hits_disk']}, TTFT {1e3 * o['ttft'][0]:.1f} ms; stream "
          f"equal to wave 1's up to ({same}, {tie}) [{card}]")
    return out["counts"]["fused_decode"]


def kvbm_phase(spec, cfg, params, prompts, card, phase4_disp_ms) -> tuple[int, int]:
    """Phase 18: the KVBM tiers on the phase-4 weights. Returns (bf16
    fused_decode launches, fp8-form launches)."""
    import shutil

    t0 = time.perf_counter()
    wave2 = kvbm_wave2_prompts(spec.vocab_size)
    rng = np.random.default_rng(1819)
    single = rng.integers(3, spec.vocab_size, KVBM_SINGLE).tolist()
    launches = {}
    try:
        bdir = KVBM_DIR / "bf16"
        r = kvbm_waves(spec, cfg, params, prompts, wave2, bdir, "bf16", card, single=single)
        launches["bf16"] = kvbm_report(spec, params, prompts, r, "bf16", card, phase4_disp_ms)
        kvbm_onboard_split(r["engine"], r["kvbm"], kvbm_hashes(single)[:31],
                           kvbm_g3_blocks(r["kvbm"], prompts), card, "bf16")
        g2, g3 = r["kvbm"].host.capacity_bytes, r["kvbm"].disk.capacity_bytes
        w1_tokens = r["out"]["wave1"]["res"]["tokens"]
        drop_engine(r["engine"])
        r = None
        launches["bf16"] += kvbm_restart(spec, cfg, params, prompts, w1_tokens, bdir, g2, g3,
                                         card)
        r = kvbm_waves(spec, cfg, params, prompts, wave2, KVBM_DIR / "fp8", "fp8", card)
        launches["fp8"] = kvbm_report(spec, params, prompts, r, "fp8", card, phase4_disp_ms)
        c = r["out"]["corrupt"]["res"]["prompt"]  # its blocks: re-offloaded to G2 last
        kvbm_onboard_split(r["engine"], r["kvbm"],
                           kvbm_hashes(prompts[c])[: (len(prompts[c]) - 1) // 16],
                           kvbm_g3_blocks(r["kvbm"], prompts), card, "fp8")
        drop_engine(r["engine"])
        r = None
        kvbm_mla_roundtrip(card)
    finally:
        shutil.rmtree(KVBM_DIR, ignore_errors=True)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s")
    return launches["bf16"], launches["fp8"]


async def http_call(port, method, path, body=None, raw=None, drop_after=None,
                    on_chunk=None, headers=None):
    """One HTTP/1.1 request on a connection of its own (stdlib only).
    Returns (status, body bytes, seconds from the send to each body chunk).
    A chunked (SSE) body is read chunk by chunk; with ``drop_after`` the
    client goes away after that many chunks; ``on_chunk(n)`` is awaited
    after the n-th chunk. ``headers`` adds request headers."""
    data = raw if raw is not None else b"" if body is None else json.dumps(body).encode()
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        t0 = time.perf_counter()
        writer.write(f"{method} {path} HTTP/1.1\r\nHost: localhost\r\nConnection: close\r\n"
                     f"Content-Type: application/json\r\nContent-Length: {len(data)}\r\n"
                     f"{extra}\r\n".encode() + data)
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


class GrpcClient:
    """A minimal gRPC client on the port's HTTP/2 frames (grpc/h2.py), HPACK
    (grpc/hpack.py) and KServe messages (grpc/kserve.py), so that phase 11
    needs no grpc package: one connection, calls concurrent on it. It ACKs
    SETTINGS and PINGs, returns every DATA byte with WINDOW_UPDATEs, and
    records a GOAWAY. A request must fit the server's initial window."""

    def __init__(self):
        from dynamo_tpu_torch.grpc import hpack

        self.encoder, self.decoder = hpack.Encoder(), hpack.Decoder()
        self.streams: dict[int, asyncio.Queue] = {}
        self.next_id = 1
        self.goaway: tuple[int, int] | None = None  # (last stream id, error code)

    async def connect(self, port: int, host: str = "127.0.0.1") -> "GrpcClient":
        from dynamo_tpu_torch.grpc import h2

        self.reader, self.writer = await asyncio.open_connection(host, port)
        self.writer.write(h2.PREFACE + h2.frame(h2.SETTINGS, 0, 0))
        self.pump = asyncio.get_running_loop().create_task(self._pump())
        return self

    async def close(self) -> None:
        self.writer.close()
        self.pump.cancel()
        await asyncio.gather(self.pump, return_exceptions=True)

    async def _pump(self) -> None:
        import struct

        from dynamo_tpu_torch.grpc import h2

        block = bytearray()
        try:
            while True:
                ftype, flags, sid, payload = await h2.read_frame(self.reader, 1 << 24)
                q = self.streams.get(sid)
                if ftype == h2.SETTINGS and not flags & h2.ACK:
                    self.writer.write(h2.frame(h2.SETTINGS, h2.ACK, 0))
                elif ftype == h2.PING and not flags & h2.ACK:
                    self.writer.write(h2.frame(h2.PING, h2.ACK, 0, payload))
                elif ftype == h2.GOAWAY:
                    self.goaway = struct.unpack_from(">II", payload)
                elif ftype in (h2.HEADERS, h2.CONTINUATION):
                    if ftype == h2.HEADERS:
                        block = bytearray(h2.strip_padding(flags, payload, priority=True))
                        end = flags & h2.END_STREAM
                    else:
                        block += payload
                    if flags & h2.END_HEADERS:
                        headers = self.decoder.decode(bytes(block))
                        if q is not None:
                            q.put_nowait(("headers", headers, time.perf_counter()))
                            if end:
                                q.put_nowait(("end", None, time.perf_counter()))
                elif ftype == h2.DATA:
                    if payload:
                        inc = struct.pack(">I", len(payload))
                        self.writer.write(h2.frame(h2.WINDOW_UPDATE, 0, 0, inc)
                                          + h2.frame(h2.WINDOW_UPDATE, 0, sid, inc))
                    if q is not None:
                        q.put_nowait(("data", h2.strip_padding(flags, payload),
                                      time.perf_counter()))
                        if flags & h2.END_STREAM:
                            q.put_nowait(("end", None, time.perf_counter()))
                elif ftype == h2.RST_STREAM and q is not None:
                    q.put_nowait(("reset", struct.unpack(">I", payload)[0],
                                  time.perf_counter()))
        except (asyncio.IncompleteReadError, ConnectionError):
            for q in self.streams.values():
                q.put_nowait(("reset", -1, time.perf_counter()))

    async def call(self, method: str, request: bytes, *, timeout_ms: int | None = None,
                   cancel_after: int | None = None, on_message=None) -> dict:
        """One call to ``/inference.GRPCInferenceService/<method>``. Returns
        {"messages": [bytes], "times": [s from the send to each message],
        "status": int, "details": str, "trailers": {k: v}, "reset": code or
        None}. With ``cancel_after`` the call sends RST_STREAM (CANCEL)
        after that many messages; ``on_message(n)`` is awaited after the
        n-th. ``timeout_ms`` goes to the server as ``grpc-timeout`` and is
        kept here as well (status 4, DEADLINE_EXCEEDED, once it passes)."""
        import struct

        from dynamo_tpu_torch.grpc import h2
        from dynamo_tpu_torch.grpc.server import frame_message, percent_decode

        sid = self.next_id
        self.next_id += 2
        q: asyncio.Queue = asyncio.Queue()
        self.streams[sid] = q
        headers = [(":method", "POST"), (":scheme", "http"),
                   (":path", f"/inference.GRPCInferenceService/{method}"),
                   (":authority", "localhost"), ("te", "trailers"),
                   ("content-type", "application/grpc")]
        if timeout_ms is not None:
            headers.append(("grpc-timeout", f"{int(timeout_ms)}m"))
        body = frame_message(request)
        require(len(body) < 65535, f"grpc request of {len(body)} bytes")
        t0 = time.perf_counter()
        self.writer.write(h2.header_frames(sid, self.encoder.encode(headers), False, 16384)
                          + h2.frame(h2.DATA, h2.END_STREAM, sid, body))
        out = {"messages": [], "times": [], "status": None, "details": "", "trailers": {},
               "reset": None}
        buf = bytearray()
        # the caller's deadline is its own too, as grpc's client keeps it: past
        # it the call is cancelled and ends DEADLINE_EXCEEDED
        until = None if timeout_ms is None else t0 + timeout_ms / 1e3
        try:
            while True:
                try:
                    kind, value, t = await asyncio.wait_for(
                        q.get(), None if until is None else max(until - time.perf_counter(), 0))
                except TimeoutError:
                    self.writer.write(h2.frame(h2.RST_STREAM, 0, sid,
                                               struct.pack(">I", h2.CANCEL)))
                    out.update(status=4, details="Deadline Exceeded", reset=h2.CANCEL)
                    return out
                if kind == "headers":
                    hd = dict(value)
                    if "grpc-status" in hd:
                        out["status"] = int(hd["grpc-status"])
                        out["details"] = percent_decode(hd.get("grpc-message", ""))
                        out["trailers"] = {k: v for k, v in value if not k.startswith(":")}
                elif kind == "data":
                    buf += value
                    while len(buf) >= 5 and len(buf) >= 5 + struct.unpack_from(">I", buf, 1)[0]:
                        n = struct.unpack_from(">I", buf, 1)[0]
                        out["messages"].append(bytes(buf[5:5 + n]))
                        out["times"].append(t - t0)
                        del buf[:5 + n]
                        if on_message is not None:
                            await on_message(len(out["messages"]))
                        if cancel_after is not None and len(out["messages"]) >= cancel_after:
                            self.writer.write(h2.frame(h2.RST_STREAM, 0, sid,
                                                       struct.pack(">I", h2.CANCEL)))
                            out["reset"] = h2.CANCEL
                            return out
                elif kind == "reset":
                    out["reset"] = value
                    return out
                else:
                    return out
        finally:
            self.streams.pop(sid, None)


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


def cli_check(model: str, device: str | None = None) -> tuple[int, float]:
    """Phase 10: ``python3 -m dynamo_tpu_torch.cli run --in http --out
    engine`` in a process of its own (random weights, graphs captured
    first) must print DYNAMO_HTTP=host:port and stream a chat completion
    of CLI_TOKENS tokens ending with data: [DONE]; then (b)'s tools run
    against it (cli_tools_check). The process is ended before this returns;
    its ENGINE_LAUNCHES must show fused_decode once per layer per step.
    Returns those launches and the seconds of (b) up to the process's end."""
    from dynamo_tpu_torch.engine.config import ModelSpec

    cmd = [sys.executable, "-m", "dynamo_tpu_torch.cli", "run", "--in", "http", "--out",
           "engine", "--model", model, "--port", "0", "--precompile"]
    if device:
        cmd += ["--device", device]
    lines: list[str] = []
    with cli_process(cmd, lines) as (port, t_ready):
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
        t_b = time.perf_counter()
        cli_tools_check(port, model)
    t_b = time.perf_counter() - t_b
    log = launches_line(lines)
    L = ModelSpec.preset(model).num_layers
    fused, steps = log["launches"].get("fused_decode_attention", 0), log["steps"]
    require(steps > 0 and fused == L * steps,
            f"cli: fused_decode {fused} != {L} x {steps} steps (ENGINE_LAUNCHES)")
    print(f"phase 10 server: fused_decode {fused} = {L} x {steps} steps, {log['replays']} "
          f"graph replays (ENGINE_LAUNCHES, the chat and (b)'s tools)")
    return fused, t_b


def tool_run(*args: str, timeout: float = TOOL_S) -> subprocess.CompletedProcess:
    """``python3 -m <args>`` in a process of its own, run to its end; an
    exit code other than 0 fails."""
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)
    require(proc.returncode == 0, f"{' '.join(args[:2])}: exit code {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    return proc


def json_lines(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def cli_tools_check(port: int, model: str) -> None:
    """Phase 10 (b) against the cli run server on ``port``: cli bench's
    closed and open loops and cli profile, each in a process of its own."""
    from types import SimpleNamespace

    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.planner import DecodeInterpolator, PrefillInterpolator
    from dynamo_tpu_torch.profiling.loadgen import arrival_times

    url = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    rungs = json_lines(tool_run("dynamo_tpu_torch.cli", "bench", "--url", url, "--model",
                                model, *BENCH_CLOSED).stdout)
    require([r["concurrency"] for r in rungs] == [1, 8], f"cli bench: rungs {rungs}")
    for r in rungs:
        ttft = r["ttft_ms"]
        require(r["errors"] == 0 and r["requests"] == 16 and ttft["p50"] is not None
                and ttft["p50"] <= ttft["p99"], f"cli bench rung: {r}")
        print(f"phase 10 (b) cli bench rung {r['concurrency']}: {json.dumps(r)}")
    require(rungs[1]["output_tok_per_s"] > rungs[0]["output_tok_per_s"],
            f"cli bench: output tok/s at 8 {rungs[1]['output_tok_per_s']} not above "
            f"at 1 {rungs[0]['output_tok_per_s']}")
    t1 = time.perf_counter()
    o = BENCH_OPEN
    want = len(arrival_times(SimpleNamespace(trace=None, sin_amp=2.0, sin_period=20.0, **o)))
    (opened,) = json_lines(tool_run(
        "dynamo_tpu_torch.cli", "bench", "--url", url, "--model", model, "--arrival",
        o["arrival"], "--rate", str(o["rate"]), "--duration", str(o["duration"]), "--isl",
        str(o["isl"]), "--osl", str(o["osl"]), "--seed", str(o["seed"])).stdout)
    require(opened["errors"] == 0 and opened["requests"] == want,
            f"cli bench open loop: {opened}, {want} requests scheduled")
    print(f"phase 10 (b) cli bench open loop: {json.dumps(opened)}")
    t2 = time.perf_counter()
    out = ROOT / "build" / "profile_sla"
    for name in ("prefill.npz", "decode.npz"):
        (out / name).unlink(missing_ok=True)
    ecfg = EngineConfig()  # the cli run server's pool
    pool_tokens = ecfg.num_pages * ecfg.page_size
    said = json_lines(tool_run("dynamo_tpu_torch.cli", "profile", "--url", url, "--model",
                               model, "--out", str(out), *PROFILE_GRID, "--max-kv-tokens",
                               str(pool_tokens)).stdout)
    require((out / "prefill.npz").is_file() and (out / "decode.npz").is_file(),
            f"cli profile: no npz files in {out}: {said}")
    pre, dec = PrefillInterpolator(str(out)), DecodeInterpolator(str(out))
    read = {"ttft_s@256": pre.interpolate_ttft(256),
            "prefill_thpt@256": pre.interpolate_thpt_per_chip(256),
            "decode_thpt@c4,256": dec.interpolate_thpt_per_chip(4, 256),
            "best_decode_thpt@0.05s,128": dec.find_best_throughput_per_chip(0.05, 128)[0]}
    require(all(np.isfinite(v) and v > 0 for v in read.values()),
            f"cli profile: interpolators read {read}")
    with np.load(out / "prefill.npz") as p, np.load(out / "decode.npz") as d:
        grids = {k: np.round(z[k], 6).tolist() for z in (p, d) for k in z.files}
    print(f"phase 10 (b) cli profile: {json.dumps(said)}; grids {json.dumps(grids)}; "
          f"read back {json.dumps({k: round(v, 6) for k, v in read.items()})}")
    print(f"phase 10 (b) tools: closed loop {t1 - t0:.1f} s, open loop {t2 - t1:.1f} s, "
          f"profile {time.perf_counter() - t2:.1f} s")


def profile_engine_check(card: str) -> tuple[int, dict]:
    """Phase 10 (b), the server gone: profile_engine on the card (PROFILE_ENGINE),
    then its step shape's kernel row. Returns its fused_decode launches and
    the row."""
    proc = tool_run("dynamo_tpu_torch.profiling.profile_engine", *PROFILE_ENGINE)
    rep = json.loads(proc.stdout)
    disp, over = rep["dispatch"], rep["overhead"]
    require(rep["model_steps"] > 0 and rep["requests_done"] > 0 and rep["phases"],
            f"profile_engine: {json.dumps(rep)[:2000]}")
    require(disp["compile_events"] == 0,
            f"profile_engine: {disp['compile_events']} graph captures in the window")
    log = launches_line(proc.stderr.splitlines())
    fused, steps = log["launches"].get("fused_decode_attention", 0), log["steps"]
    require(steps > 0 and fused == 16 * steps,
            f"profile_engine: fused_decode {fused} != 16 x {steps} steps")
    phases = {k: v for k, v in rep["phases"].items() if v["secs"] or v["calls"]}
    print(f"phase 10 (b) profile_engine [{card}]: window {rep['window_s']} s, "
          f"{rep['model_steps']} steps, {rep['requests_done']} requests, "
          f"dispatch + readmission {over['dispatch_plus_readmit_frac_of_window']} of the "
          f"window (dispatch {over['dispatch_s']} s, readmission {over['readmit_s']} s), "
          f"dispatches per step {disp['dispatches_per_step']}, d2h wait "
          f"{disp['d2h_wait_s']} s, 0 captures; readmission "
          f"{json.dumps(rep['readmission'])}; phases {json.dumps(phases)}; fused_decode "
          f"{fused} = 16 x {steps} steps since its warm-up (ENGINE_LAUNCHES)")
    return fused, bench_kernel_row(card)


def bench_kernel_row(card: str) -> dict:
    """fused_decode and paged_attention_v3 against their plain versions at
    profile_engine's step shape (llama-1b-bench: 64 slots, 16 live at
    129..174 tokens, KH 8, G 2, D 128, 13 pages per sequence), and
    fused_decode timed there beside its plain version, SDPA and the bound."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    lens = tuple(129 + 3 * i for i in range(16)) + (1,) * 48
    over = dict(B=64, KH=8, G=2, P=13)
    t = kernel_inputs(torch.bfloat16, seq_lens=lens, **over)
    err, _ = check_attention(t, "llama-1b-bench B 64 KH 8 G 2", 0, None)
    times = time_attention_at(t, flush, False, seq_lens=lens, **over)
    print(f"time llama-1b-bench B 64 KH 8 G 2 [{card}]: fused_decode {times['ms']:.4f} ms, "
          f"plain {times['plain_ms']:.4f} ms, SDPA {times['library_ms']:.4f} ms, bound "
          f"{times['bound_ms']:.6f} ms ({times['bound_by']})")
    del t, flush
    return {"max_abs_err": err, **times}


def cli_phase(model: str, card: str) -> tuple[int, int, dict]:
    """Phase 10 and (b): the cli run server's fused_decode launches,
    profile_engine's, and the kernel row at profile_engine's shape."""
    t0 = time.perf_counter()
    cli_launches, t_b = cli_check(model)
    t1 = time.perf_counter()
    bench_launches, row = profile_engine_check(card)
    t_b += time.perf_counter() - t1
    print(f"phase 10: {time.perf_counter() - t0:.1f} s, (b) {t_b:.1f} s")
    return cli_launches, bench_launches, row


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

    def __init__(self, *args, env=None):
        import queue
        import threading

        self.name = args[0]
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.cli", *args], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=None if env is None else {**os.environ, **env})
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

    def pump(self) -> list[str]:
        """Every line read so far (the queued ones moved to ``seen``)."""
        while not self.lines.empty():
            line = self.lines.get_nowait()
            if line is None:
                break
            self.seen.append(line)
        return self.seen

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
    fused_decode launches, which must be 32 per logged step, and the
    two-worker frontend set's client TTFT (mean, max; s)."""

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
        front = Child("frontend", "--hub", hub, "--port", "0", "--host", "127.0.0.1",
                      "--grpc-port", "0")
        children.append(front)
        port = int(front.wait_line("DYNAMO_HTTP=", 60).rsplit(":", 1)[1])
        grpc_port = int(front.wait_line("DYNAMO_GRPC=", 60).rsplit(":", 1)[1])
        for w in workers:
            w.status_port = int(w.wait_line("SYSTEM_STATUS_PORT=", PROC_START_S)
                                .split("=", 1)[1])
            w.wait_line("ENGINE_READY", PROC_START_S)
            line = next(ln for ln in w.seen if "engine worker " in ln)
            w.lease = int(re.search(r"engine worker ([0-9a-f]+) up", line).group(1), 16) >> 16
        t_ready = time.perf_counter() - t0
        out = asyncio.run(_drive_processes(spec, prompts, hub, port, workers, front,
                                           grpc_port))
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
    # the gRPC streams: equal to the TCP set's up to the first near-tie, each
    # one that differs near-argmax under the same reference forward
    g = out["grpc"]
    grpc_same = sum(g["ids"][i] == tcp_tokens[i] for i in range(n))
    grpc_checks = [near_argmax_check(spec, params, prompts[i], g["ids"][i])
                   for i in range(n) if g["ids"][i] != tcp_tokens[i]]
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
          f"{[x['replays'] for x in logs]}); decode dispatch-to-host per worker (pipelined, "
          f"[dispatches, mean ms]) {[x['dispatch_ms'] for x in logs]}")
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
    require(g["steps"] > 0 and (DEVICE != "cuda" or g["fused"] == L * g["steps"]),
            f"processes grpc: fused_decode launched {g['fused']} times over {g['steps']} "
            "decode steps")

    def itl(streams):
        return sum((t[-1] - t[0]) / (SERVE_TOKENS - 1) for _, _, t in streams) / n

    print(f"processes: grpc (g) clients: {', '.join(g['clients'])}; ServerLive, ServerReady, "
          f"ModelReady and ModelMetadata answered; {n} concurrent ModelStreamInfer input_ids "
          f"streams x {SERVE_TOKENS} tokens on cleared caches: {grpc_same}/{n} equal the TCP "
          f"set's token ids"
          + (f" (the others near-argmax, worst gap {max(x for _, x in grpc_checks):.3f})"
             if grpc_checks else "")
          + f"; fused_decode {g['fused']} = {L} x {g['steps']} decode steps over both workers")
    grpc_rates = rates("grpc ModelStreamInfer -> 2 worker processes", g["wall"],
                       sum(g["ttft"]) / n, max(g["ttft"]))
    http_rates = rates("frontend -> 2 worker processes again", out["again_wall"],
                       sum(again_ttft) / n, max(again_ttft))
    print(f"processes: grpc (g) {grpc_rates}, ITL mean {1e3 * sum(g['itl']) / n:.2f} ms; the "
          f"HTTP set's ({http_rates}, ITL mean {1e3 * itl(out['again']):.2f} ms)")
    print(f"processes: grpc (g) unary ModelInfer text_input: {GRPC_TOKENS} tokens in "
          f"{1e3 * g['unary_s']:.1f} ms, text_output {g['unary_text'][:40]!r}; openai_request "
          f"chat stream: {g['chat'][0]} messages, triton_final_response on the last only, "
          f"{g['chat'][1][:40]!r}; cancel after chunk {GRPC_CANCEL_AFTER} (RST_STREAM): "
          f"{g['cancel'][0]} pages held, back to 0 after {g['cancel'][1]:.3f} s; "
          f"{GRPC_DEADLINE_MS} ms deadline: DEADLINE_EXCEEDED ({g['deadline'][0]!r}), pages "
          f"freed after {g['deadline'][1]:.3f} s")
    print(f"processes: grpc (g) host cost per stream message ({g['message_bytes']} bytes): "
          f"KServe encode {g['encode_us']:.2f} us, gRPC + HTTP/2 DATA framing "
          f"{g['frame_us']:.2f} us; phase 11 (g) took {g['secs']:.2f} s")
    return fused, (sum(ttft) / n, max(ttft), [x["dispatch_ms"] for x in logs])


async def _drive_processes(spec, prompts, hub, port, workers, front, grpc_port):
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
        # (g) the same frontend process's KServe gRPC surface
        out["grpc"] = await _grpc_set(name, prompts, grpc_port, cache_status, clear_caches)

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



async def _grpc_set(name, prompts, grpc_port, cache_status, clear_caches) -> dict:
    """Phase 11 (g): the frontend process's KServe gRPC surface through
    GrpcClient (and, where grpc is installed, (c) through grpc.aio too):
    (a) the probes; (b) the 8 prompts as concurrent greedy input_ids
    streams of SERVE_TOKENS tokens on cleared caches, with both workers'
    fused_decode launches and decode steps read before and after; (c) one
    unary text_input ModelInfer; (d) one openai_request chat stream; (e) a
    stream cancelled after its GRPC_CANCEL_AFTER-th chunk; (f) a
    GRPC_DEADLINE_MS deadline. Gates what only this process sees; the
    token ids go back to process_phase for the reference checks."""
    import importlib
    import importlib.util

    from dynamo_tpu_torch.grpc import h2
    from dynamo_tpu_torch.grpc import kserve as pb
    from dynamo_tpu_torch.grpc.server import frame_message
    from dynamo_tpu_torch.grpc.service import _text_output_response

    t_set = time.perf_counter()
    out: dict = {"clients": ["minimal (grpc/h2.py, hpack.py, kserve.py)"]}
    temp0 = pb.InferParameter(double_param=0.0)

    def params(n):
        return {"max_tokens": pb.InferParameter(int64_param=n),
                "ignore_eos": pb.InferParameter(bool_param=True), "temperature": temp0}

    def ids_request(p, n, rid):
        return pb.ModelInferRequest(model_name=name, id=rid, parameters=params(n), inputs=[
            pb.InferInputTensor(name="input_ids", datatype="INT32", shape=[len(p)],
                                contents=pb.InferTensorContents(int_contents=list(p)))])

    def stream_items(r, label):
        require(r["status"] == 0 and r["reset"] is None,
                f"grpc {label}: status {r['status']} {r['details']!r}, reset {r['reset']}")
        msgs = [pb.ModelStreamInferResponse.from_bytes(m) for m in r["messages"]]
        bad = [m.error_message for m in msgs if m.error_message]
        require(not bad, f"grpc {label}: error messages {bad[:2]}")
        return [m.infer_response for m in msgs]

    def final(resp) -> bool:
        p = resp.parameters.get("triton_final_response")
        return bool(p and p.bool_param)

    async def free_within(limit: float, label: str) -> float:
        t0 = time.perf_counter()
        while any(s["active_pages"] for s in (await cache_status()).values()):
            require(time.perf_counter() - t0 < limit,
                    f"grpc {label}: the worker still holds its pages after {limit} s")
            await asyncio.sleep(0.02)
        return time.perf_counter() - t0

    client = await GrpcClient().connect(grpc_port)
    try:
        # (a) probes
        probes = {}
        for method, req, cls in (
                ("ServerLive", pb.ServerLiveRequest(), pb.ServerLiveResponse),
                ("ServerReady", pb.ServerReadyRequest(), pb.ServerReadyResponse),
                ("ModelReady", pb.ModelReadyRequest(name=name), pb.ModelReadyResponse),
                ("ModelMetadata", pb.ModelMetadataRequest(name=name),
                 pb.ModelMetadataResponse)):
            r = await client.call(method, req.to_bytes())
            require(r["status"] == 0 and len(r["messages"]) == 1,
                    f"grpc {method}: status {r['status']} {r['details']!r}")
            probes[method] = cls.from_bytes(r["messages"][0])
        meta = probes["ModelMetadata"]
        require(probes["ServerLive"].live and probes["ServerReady"].ready
                and probes["ModelReady"].ready and meta.name == name
                and [t.name for t in meta.inputs] == ["text_input", "input_ids",
                                                      "openai_request", "streaming"],
                f"grpc probes: {probes}")

        # (b) the 8 prompts as concurrent input_ids streams
        await clear_caches()
        before = await cache_status()
        t0 = time.perf_counter()
        streams = await asyncio.gather(*(
            client.call("ModelStreamInfer", ids_request(p, SERVE_TOKENS, f"g{i}").to_bytes())
            for i, p in enumerate(prompts)))
        out["wall"] = time.perf_counter() - t0
        after = await cache_status()
        out["ids"], out["ttft"], out["itl"] = [], [], []
        for i, r in enumerate(streams):
            resps = stream_items(r, f"stream {i}")
            toks = [t for x in resps for o in x.outputs if o.name == "output_ids"
                    for t in o.contents.int_contents]
            require(len(toks) == SERVE_TOKENS and final(resps[-1])
                    and not any(final(x) for x in resps[:-1]),
                    f"grpc stream {i}: {len(toks)} tokens, finals "
                    f"{[final(x) for x in resps]}")
            out["ids"].append(toks)
            out["ttft"].append(r["times"][0])
            out["itl"].append((r["times"][-1] - r["times"][0]) / (SERVE_TOKENS - 1))
        require(sorted(before) == sorted(after), f"grpc: workers {before} -> {after}")
        out["fused"] = sum(after[w]["launches"].get("fused_decode_attention", 0)
                           - before[w]["launches"].get("fused_decode_attention", 0)
                           for w in after)
        out["steps"] = sum(after[w]["steps"] - before[w]["steps"] for w in after)

        # (c) one unary text_input ModelInfer, each client on cleared caches
        text_req = pb.ModelInferRequest(model_name=name, id="smoke-c", parameters=params(
            GRPC_TOKENS), inputs=[pb.InferInputTensor(
                name="text_input", datatype="BYTES", shape=[1],
                contents=pb.InferTensorContents(bytes_contents=[b"Hello there"]))]).to_bytes()
        await clear_caches()
        r = await client.call("ModelInfer", text_req)
        require(r["status"] == 0 and len(r["messages"]) == 1,
                f"grpc unary: status {r['status']} {r['details']!r}")
        unary = pb.ModelInferResponse.from_bytes(r["messages"][0])
        outputs = {o.name: o for o in unary.outputs}
        tokens = unary.parameters.get("output_tokens")
        require("text_output" in outputs and tokens and tokens.int64_param == GRPC_TOKENS
                and final(unary), f"grpc unary: {unary}")
        out["unary_text"] = outputs["text_output"].contents.bytes_contents[0]
        out["unary_s"] = r["times"][0]
        if importlib.util.find_spec("grpc") is not None:
            grpc = importlib.import_module("grpc")
            await clear_caches()
            async with grpc.aio.insecure_channel(f"127.0.0.1:{grpc_port}") as chan:
                got = await chan.unary_unary(
                    "/inference.GRPCInferenceService/ModelInfer")(text_req)
            require(got == r["messages"][0],
                    f"grpc unary: grpc.aio's response {got!r} differs from "
                    f"{r['messages'][0]!r}")
            out["clients"].append(f"grpc.aio {grpc.__version__}")

        # (d) one openai_request chat through ModelStreamInfer
        body = {"messages": [{"role": "user", "content": "Hello there"}],
                "max_tokens": GRPC_TOKENS, "ignore_eos": True, "temperature": 0.0,
                "stream": True, "stream_options": {"include_usage": True}}
        chat_req = pb.ModelInferRequest(model_name=name, inputs=[pb.InferInputTensor(
            name="openai_request", datatype="BYTES", shape=[1],
            contents=pb.InferTensorContents(bytes_contents=[json.dumps(body).encode()]))])
        r = await client.call("ModelStreamInfer", chat_req.to_bytes())
        resps = stream_items(r, "openai chat")
        chunks = [json.loads(x.outputs[0].contents.bytes_contents[0]) for x in resps]
        usage = chunks[-1].get("usage") or {}
        require(len(chunks) > 1 and final(resps[-1])
                and not any(final(x) for x in resps[:-1])
                and all(c["object"] == "chat.completion.chunk" for c in chunks)
                and usage.get("completion_tokens") == GRPC_TOKENS,
                f"grpc openai chat: {chunks[-2:]}")
        out["chat"] = (len(chunks), "".join(
            c["choices"][0]["delta"].get("content") or "" for c in chunks if c["choices"]))

        # (e) a stream cancelled after its GRPC_CANCEL_AFTER-th chunk
        held = {}

        async def on_message(k):
            if k == GRPC_CANCEL_AFTER:
                held["pages"] = sum(s["active_pages"] for s in (await cache_status()).values())

        r = await client.call("ModelStreamInfer", ids_request(prompts[0], 4 * SERVE_TOKENS,
                                                               "cancel").to_bytes(),
                              cancel_after=GRPC_CANCEL_AFTER, on_message=on_message)
        require(r["reset"] == h2.CANCEL and len(r["messages"]) == GRPC_CANCEL_AFTER
                and held.get("pages", 0) > 0,
                f"grpc cancel: {len(r['messages'])} messages, reset {r['reset']}, "
                f"pages held at the cancel {held.get('pages')}")
        out["cancel"] = (held["pages"], await free_within(GRPC_FREE_S, "cancel"))

        # (f) a GRPC_DEADLINE_MS deadline
        r = await client.call("ModelInfer", ids_request(prompts[1], 8 * SERVE_TOKENS,
                                                        "deadline").to_bytes(),
                              timeout_ms=GRPC_DEADLINE_MS)
        require(r["status"] == 4, f"grpc deadline: status {r['status']} {r['details']!r}")
        out["deadline"] = (r["details"], await free_within(GRPC_FREE_S, "deadline"))
    finally:
        await client.close()

    # host cost of one stream message: the KServe encode, then its gRPC and
    # HTTP/2 framing
    resp = pb.ModelStreamInferResponse(infer_response=_text_output_response(
        name, "chatcmpl-0123456789abcdef01234567", "abc", tokens=1, token_ids=[12345]))
    reps = 2000
    t0 = time.perf_counter()
    for _ in range(reps):
        data = resp.to_bytes()
    t1 = time.perf_counter()
    for _ in range(reps):
        h2.frame(h2.DATA, 0, 1, frame_message(data))
    t2 = time.perf_counter()
    out["encode_us"], out["frame_us"] = 1e6 * (t1 - t0) / reps, 1e6 * (t2 - t1) / reps
    out["message_bytes"] = len(data)
    out["secs"] = time.perf_counter() - t_set
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


def gpt_oss_spec(layers: int = MOE_LAYERS):
    """gpt-oss-120b at full width, ``layers`` deep."""
    import dataclasses

    from dynamo_tpu_torch.engine.config import ModelSpec

    full = ModelSpec.gpt_oss_120b()
    return dataclasses.replace(full, num_layers=layers, layer_types=full.layer_types[:layers])


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

    def counted(spec_, lp, x, *, capacity_factor=1.25, return_dropped=False, **kw):
        out, d = real(spec_, lp, x, capacity_factor=no_drop, return_dropped=True, **kw)
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

    def split(spec_, lp, x, *, capacity_factor=1.25, return_dropped=False, **kw):
        a, d = real(spec_, lp, x[:n], capacity_factor=capacity_factor, return_dropped=True,
                    **kw)
        b, db = real(spec_, lp, x[n:], capacity_factor=no_drop, return_dropped=True, **kw)
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

    def counted(spec_, lp, x, *, capacity_factor=1.25, return_dropped=False, **kw):
        out, d = real(spec_, lp, x, capacity_factor=capacity_factor, return_dropped=True,
                      **kw)
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


# ----------------------------------------------------------- disaggregation

def disagg_blocks_equal(dec, prompt, k, v) -> bool:
    """The decode engine's sealed pages of ``prompt`` against the exported
    blocks ``k``, ``v`` (their full blocks), bitwise."""
    from dynamo_tpu_torch.tokens import TokenBlockSequence

    pages = dec.allocator.match_prefix(
        TokenBlockSequence.from_tokens(prompt, dec.config.page_size).sequence_hashes())
    n = len(prompt) // dec.config.page_size
    if len(pages) != n:
        return False
    kd, vd = dec.fam.extract_pages(dec.k_pages, dec.v_pages,
                                   torch.tensor(pages, device=dec.device))
    return torch.equal(kd, k[:, :n]) and torch.equal(vd, v[:, :n])


def disagg_serve(spec, cfg, params, prompts, kv_dtype, want, base_ttft_ms, card) -> int:
    """Phase 19 (a)/(b): a prefill and a decode worker in this process on
    the in-memory hub, sharing ``params``, the decode worker with
    ``always_remote_prefill`` and its graphs captured; the 8 prompts, 32
    greedy tokens each, through the decode worker's front door. Returns the
    fused_decode launches (all of the drive's: the prefill side launches
    none)."""
    from dynamo_tpu_torch.disagg.transfer import PULLS
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.worker import launch_engine_worker
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub import InMemoryHub

    label = f"disagg {kv_dtype}"
    L = spec.num_layers

    async def drive():
        drt = DistributedRuntime(InMemoryHub())
        ecfg = EngineConfig(**cfg, kv_dtype=kv_dtype)
        pre, _ = await launch_engine_worker(drt, model=spec.name, spec=spec, params=params,
                                            device=DEVICE, engine_config=ecfg,
                                            mode="prefill")
        dec, _ = await launch_engine_worker(drt, model=spec.name, spec=spec, params=params,
                                            device=DEVICE, engine_config=ecfg,
                                            mode="decode", always_remote_prefill=True,
                                            precompile=True)
        exported = {}  # num_tokens -> (k, v) copies of the export
        export = pre.transfer_source.export

        def keep(kb, vb, **kw):
            exported[kw["num_tokens"]] = (kb.clone(), vb.clone())
            return export(kb, vb, **kw)

        pre.transfer_source.export = keep
        try:
            await dec.frontdoor.wait_for_prefill_pool()
            pulls0 = PULLS.snapshot()
            marks0 = (dec.steps, dec._graphs.replays, dec.prefill_forwards,
                      len(dec.decode_step_times), pre.steps)
            # each decode burst's (dispatch, tokens on the host) on the
            # host clock: the bursts that shared the card with a prefill
            # forward of the prefill engine, and the others
            spans = []
            process = dec._process_burst

            def timed(pending, _process=process):
                _process(pending)
                spans.append((pending["t0"], pending["t0"] + dec.decode_step_times[-1]))

            dec._process_burst = timed
            zero_counts()
            t0 = time.perf_counter()

            first_token = asyncio.Event()
            handoffs = []  # host time of each relayed first token (its export done)

            async def one(i):
                t_sub, stamps, items = time.perf_counter(), [], []
                async for item in dec.frontdoor.generate(make_request(prompts[i]), Context()):
                    if item["token_ids"] and len(stamps) < 2:
                        stamps.append(time.perf_counter() - t_sub)
                        if len(stamps) == 1:
                            handoffs.append(time.perf_counter())
                        if i == 0:
                            first_token.set()
                    items.append(item)
                return items, stamps

            # as phase 4: the second sharer arrives once the first one's
            # prompt is sealed (on both engines: its resume installs only
            # the pages beyond the shared prefix)
            tasks = {i: asyncio.ensure_future(one(i)) for i in range(len(prompts)) if i != 1}
            await first_token.wait()
            tasks[1] = asyncio.ensure_future(one(1))
            res = [await tasks[i] for i in range(len(prompts))]
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = read_counts()
            pulls = PULLS.snapshot()
            out = {"res": res, "wall": wall, "counts": counts,
                   "steps": dec.steps - marks0[0], "replays": dec._graphs.replays - marks0[1],
                   "prefills": dec.prefill_forwards - marks0[2],
                   "times": list(dec.decode_step_times)[marks0[3]:],
                   "pre_steps": pre.steps - marks0[4],
                   "pulls": {r: pulls["pulls"][r] - pulls0["pulls"][r] for r in pulls["pulls"]},
                   "route_fallbacks": pulls["route_fallbacks"] - pulls0["route_fallbacks"],
                   "fallbacks": dec.disagg_fallbacks,
                   "equal": [disagg_blocks_equal(dec, p, *exported[len(p)]) for p in prompts],
                   "exports": list(pre.export_times), "resumes": list(dec.resume_times),
                   "spans": spans, "last_handoff": max(handoffs),
                   "active": (pre.allocator.active_pages, dec.allocator.active_pages)}
            return out
        finally:
            await dec.close()
            await pre.close()
            await drt.close()
            for eng in (dec, pre):
                eng.release_graphs()
                eng.params = eng.k_pages = eng.v_pages = None

    o = asyncio.run(drive())
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    fp8 = kv_dtype == "fp8"
    tokens, ttft, gaps = [], [], []
    for i, (items, stamps) in enumerate(o["res"]):
        toks = [t for x in items for t in x["token_ids"]]
        require(items[-1]["finish_reason"] == "length" and len(toks) == SERVE_TOKENS,
                f"{label} request {i}: {len(toks)} tokens, finish {items[-1]['finish_reason']}")
        tokens.append(toks)
        ttft.append(stamps[0])
        gaps.append(stamps[1] - stamps[0])
    require(o["prefills"] == 0, f"{label}: the decode engine ran {o['prefills']} prefills")
    require(o["pre_steps"] == 0, f"{label}: the prefill engine ran {o['pre_steps']} steps")
    require(o["pulls"] == {"local": len(prompts), "device": 0, "tcp": 0}
            and o["route_fallbacks"] == 0 and o["fallbacks"] == 0,
            f"{label}: pulls {o['pulls']}, route fallbacks {o['route_fallbacks']}, "
            f"fallbacks {o['fallbacks']}")
    require(all(o["equal"]), f"{label}: installed pages equal to the exports: {o['equal']}")
    fused = o["counts"]["fused_decode"]
    require(fused == L * o["steps"] and o["replays"] == o["steps"],
            f"{label}: fused_decode {fused} over {o['steps']} steps, {o['replays']} replays")
    require(o["counts"]["fused_decode/fp8"] == (fused if fp8 else 0),
            f"{label}: {o['counts']['fused_decode/fp8']} fp8-form launches")
    require(o["active"] == (0, 0), f"{label}: active pages after {o['active']}")
    agree = []
    for i, p in enumerate(prompts):
        same, tie = equal_to_first_near_tie(spec, params, p, tokens[i], want[i])
        require(same >= tie, f"{label} request {i}: parts from the aggregated stream at "
                             f"token {same}, before the first reference near-tie at {tie}")
        agree.append((same, tie))
    gathers = [t[0].elapsed_time(t[1]) for t, _ms, _b in o["exports"] if t is not None]
    export_host = [ms for _t, ms, _b in o["exports"]]
    nbytes = sum(b for _t, _ms, b in o["exports"])
    resumes = [ms for ms, _n, _split in o["resumes"]]
    split = resume_split(o["resumes"])
    disp = 1e3 * sum(o["times"]) / max(len(o["times"]), 1)
    shared = [b - a for a, b in o["spans"] if a < o["last_handoff"]]
    alone = [b - a for a, b in o["spans"] if a >= o["last_handoff"]]
    n_tok = sum(len(t) for t in tokens)
    print(f"{label}: {len(prompts)} requests through the decode worker's front door, "
          f"{n_tok} tokens in {o['wall']:.3f} s = {n_tok / o['wall']:.1f} tok/s; TTFT mean "
          f"{1e3 * sum(ttft) / len(ttft):.1f} ms, max {1e3 * max(ttft):.1f} ms (aggregated, "
          f"the same prompts on one engine: mean {base_ttft_ms:.1f} ms); first to second token "
          f"(pull, resume, first decode step) mean {1e3 * sum(gaps) / len(gaps):.1f} ms, max "
          f"{1e3 * max(gaps):.1f} ms; decode "
          f"dispatch-to-host mean {disp:.2f} ms over {len(o['times'])} dispatches; "
          f"fused_decode {fused} = {L} x {o['steps']} steps, replays {o['replays']}; "
          f"prefill forwards on the decode engine 0, decode steps on the prefill engine 0; "
          f"pulls {o['pulls']} [{card}]")
    print(f"{label}: per export the device span around the gather "
          f"{sum(gathers) / max(len(gathers), 1):.3f} ms (max {max(gathers, default=0.0):.3f}; "
          f"one process: the decode engine's work on the shared stream falls inside it), "
          f"the step thread "
          f"{sum(export_host) / len(export_host):.3f} ms of host time (gather enqueue + "
          f"export); per resume the step thread {sum(resumes) / len(resumes):.3f} ms "
          f"(max {max(resumes):.3f}; mean by piece {split}); {nbytes} bytes moved "
          f"({nbytes / 2**20:.1f} MiB); installed pages bitwise equal to the exports "
          f"({'packed fp8 blocks' if fp8 else 'bf16'}); streams equal to the aggregated "
          f"ones up to (first difference, first near-tie) {agree} [{card}]")
    print(f"{label}: decode dispatch-to-host (this engine is not pipelined: a resume runs "
          f"between bursts) of the bursts dispatched before the last first token was "
          f"relayed (the prefill engine's forwards on the same card) mean "
          f"{1e3 * sum(shared) / max(len(shared), 1):.2f} ms over {len(shared)}, after it "
          f"{1e3 * sum(alone) / max(len(alone), 1):.2f} ms over {len(alone)} [{card}]")
    return fused


def resume_split(resumes) -> dict:
    """Mean host ms by piece of ``resume_times`` entries (total, pages,
    {piece: ms})."""
    if not resumes:
        return {}
    keys = resumes[0][2]
    return {k: round(sum(r[2][k] for r in resumes) / len(resumes), 3) for k in keys}


def disagg_pull_stats(status: dict, route: str) -> dict:
    """A route's pulls from a worker's ``cache_status`` disagg records: the
    bytes over the time some pull was in flight (the union of their
    intervals: they overlap, and gaps between arrivals are not pull time),
    and the mean split of one pull (ms)."""
    recs = [r for r in status["records"] if r["route"] == route]
    nbytes = sum(r["bytes"] for r in recs)
    busy, end = 0.0, None
    for r in sorted(recs, key=lambda r: r["start"]):
        if end is None or r["start"] > end:
            busy += r["end"] - r["start"]
            end = r["end"]
        elif r["end"] > end:
            busy += r["end"] - end
            end = r["end"]
    keys = ("control", "open", "copy", "checksum", "total")
    return {"n": len(recs), "bytes": nbytes, "span_ms": 1e3 * busy,
            "gbs": nbytes / max(busy, 1e-9) / 1e9,
            **{k: sum(r.get(k, 0.0) for r in recs) / max(len(recs), 1) for k in keys}}


async def _disagg_drive(spec, prompts, hub, port, respawn):
    """Phase 19 (c)'s traffic on this process's loop: the 8 prompts through
    the frontend (device route), over the TCP data plane (their token ids),
    then on a decode worker with DYNAMO_DEVICE_TRANSFER=0 (``respawn``), and
    the faults on that worker."""
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub_client import RemoteHub
    from dynamo_tpu_torch.runtime.push import PushRouter, RouterMode

    drt = DistributedRuntime(await RemoteHub.connect(hub), RuntimeConfig(hub_address=hub))
    out: dict = {}

    async def admin(component, payload):
        client = await drt.namespace("dynamo").component(component).endpoint(
            "admin").client().start()
        try:
            (inst,) = await client.wait_for_instances(1, timeout=30)
            async for item in client.call_instance(inst.instance_id, payload, Context()):
                return item
        finally:
            await client.close()

    async def clear():
        for comp in ("prefill", "backend"):
            await admin(comp, {"op": "clear_kv_blocks"})
        t = time.perf_counter()
        for comp in ("prefill", "backend"):
            while (await admin(comp, {"op": "cache_status"}))["cached_pages"]:
                require(time.perf_counter() - t < 10, "disagg processes: caches not cleared")
                await asyncio.sleep(0.02)

    async def until_model():
        t = time.perf_counter()
        while True:
            status, body, _ = await http_call(port, "GET", "/v1/models")
            keys = await drt.hub.get_prefix("v1/instances/dynamo/backend/generate/")
            if status == 200 and [m["id"] for m in json.loads(body)["data"]] == [spec.name] \
                    and len(keys) == 1:
                return
            require(time.perf_counter() - t < 60, "disagg processes: no decode worker listed")
            await asyncio.sleep(0.1)

    async def frontend_set():
        t = time.perf_counter()
        streams = await asyncio.gather(*(http_call(port, "POST", "/v1/completions", {
            "model": spec.name, "prompt": p, "max_tokens": SERVE_TOKENS, "ignore_eos": True,
            "stream": True, "stream_options": {"include_usage": True}}) for p in prompts))
        return streams, (t, time.perf_counter())

    async def tcp_tokens(ps):
        router = await PushRouter.from_endpoint(
            drt.namespace("dynamo").component("backend").endpoint("generate"),
            RouterMode.ROUND_ROBIN)
        try:
            await router.client.wait_for_instances(1, timeout=30)

            async def one(p):
                return [t async for item in router.generate(make_request(p), Context())
                        for t in item["token_ids"]]

            return await asyncio.gather(*(one(p) for p in ps))
        finally:
            await router.client.close()

    try:
        await until_model()
        # the token ids first: they also warm both workers before the timed
        # sets (a worker's first traffic pays its first-use costs)
        await clear()
        out["tokens"] = await tcp_tokens(prompts)
        await clear()
        out["device"], out["device_span"] = await frontend_set()
        out["device_status"] = (await admin("backend", {"op": "cache_status"}))["disagg"]
        # the same decode worker again with DYNAMO_DEVICE_TRANSFER=0, warmed
        # by one request
        out["launches_a"] = await asyncio.to_thread(respawn)
        await until_model()
        await clear()
        await tcp_tokens(prompts[:1])
        await clear()
        out["tcp"], out["tcp_span"] = await frontend_set()
        out["tcp_status"] = (await admin("backend", {"op": "cache_status"}))["disagg"]
        out["pre_status"] = (await admin("prefill", {"op": "cache_status"}))["disagg"]
        k = 0
        await clear()
        (out["clean"],) = await tcp_tokens([prompts[k]])
        for fault in ("disagg.pull:error@1x1", "disagg.pull:corrupt=1x1"):
            await clear()
            snap = await admin("backend", {"op": "faults", "spec": fault})
            require(snap["ok"], f"disagg processes: faults op {snap}")
            (out[fault],) = await tcp_tokens([prompts[k]])
            out[fault + " trips"] = (await admin("backend", {"op": "faults"}))["trips"]
            await admin("backend", {"op": "faults", "spec": ""})
        out["fault_status"] = (await admin("backend", {"op": "cache_status"}))["disagg"]
    finally:
        await drt.close()
    return out


def disagg_processes(spec, cfg, prompts, p11_ttft, card, device=None) -> int:
    """Phase 19 (c): ``cli hub``, ``cli worker --mode prefill --precompile``,
    ``cli worker --mode decode --always-remote-prefill --precompile`` (phase
    1's config, the seeded weights), ``cli frontend``; then the decode worker
    again with DYNAMO_DEVICE_TRANSFER=0 and the disagg.pull faults. Returns
    the decode workers' fused_decode launches."""
    from dynamo_tpu_torch.models.family import get_family

    import gc

    gc.collect()
    torch.cuda.empty_cache()
    dev = ["--device", device] if device else []
    flags = ["--page-size", str(cfg["page_size"]), "--num-pages", str(cfg["num_pages"]),
             "--max-pages-per-seq", str(cfg["max_pages_per_seq"]),
             "--max-decode-slots", str(cfg["max_decode_slots"]), "--precompile", *dev]
    children: list[Child] = []
    L, n = spec.num_layers, len(prompts)
    t0 = time.perf_counter()

    def decode_worker(env=None):
        w = Child("worker", "--hub", hub, "--model", spec.name, "--mode", "decode",
                  "--always-remote-prefill", *flags, env=env)
        children.append(w)
        w.wait_line("ENGINE_READY", PROC_START_S)
        return w

    logs = []

    def respawn():
        require(dec.stop() == 0, f"decode worker exited non-zero: {dec.seen[-8:]}")
        logs.append(json.loads(dec.logged("ENGINE_LAUNCHES ").split(" ", 1)[1]))
        return logs[-1]

    try:
        hub_proc = Child("hub", "--port", "0")
        children.append(hub_proc)
        hub = hub_proc.wait_line("DYNAMO_HUB=", 60).split("=", 1)[1]
        pre = Child("worker", "--hub", hub, "--model", spec.name, "--mode", "prefill", *flags)
        children.append(pre)
        front = Child("frontend", "--hub", hub, "--port", "0", "--host", "127.0.0.1")
        children.append(front)
        port = int(front.wait_line("DYNAMO_HTTP=", 60).rsplit(":", 1)[1])
        pre.wait_line("ENGINE_READY", PROC_START_S)
        dec = decode_worker()
        t_ready = time.perf_counter() - t0

        def respawn_tcp():
            nonlocal dec
            launches = respawn()
            dec = decode_worker({"DYNAMO_DEVICE_TRANSFER": "0"})
            return launches

        out = asyncio.run(_disagg_drive(spec, prompts, hub, port, respawn_tcp))
        respawn()
        require(pre.stop() == 0, f"prefill worker exited non-zero: {pre.seen[-8:]}")
        pre_log = json.loads(pre.logged("ENGINE_LAUNCHES ").split(" ", 1)[1])
        for child in (front, hub_proc):
            require(child.stop() == 0, f"{child.name} exited non-zero: {child.seen[-8:]}")
    finally:
        for child in children:
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait(30)

    def frontend_ttft(streams, label):
        """Client TTFT per stream, and the gap from the first chunk (the
        relayed remote token) to the second (the pull, resume and first
        decode step behind it)."""
        ttft, gaps = [], []
        for i, (status, body, times) in enumerate(streams):
            ev = sse_events(body) if status == 200 else []
            chunks = [e for e in ev[:-1] if e.get("choices")]
            usage = ev[-2].get("usage") if len(ev) >= 2 else None
            require(status == 200 and ev[-1] == "[DONE]" and chunks
                    and chunks[-1]["choices"][0]["finish_reason"] == "length"
                    and usage and usage["completion_tokens"] == SERVE_TOKENS,
                    f"disagg processes {label} stream {i}: status {status}, last {ev[-3:]}")
            ttft.append(times[0])
            gaps.append(times[1] - times[0])
        return ttft, gaps

    dev_ttft, dev_gap = frontend_ttft(out["device"], "device")
    tcp_ttft, tcp_gap = frontend_ttft(out["tcp"], "tcp")
    ds, ts, fs = out["device_status"], out["tcp_status"], out["fault_status"]
    require(ds["pulls"] == {"local": 0, "device": 2 * n, "tcp": 0}
            and ds["route_fallbacks"] == 0 and ds["fallbacks"] == 0,
            f"disagg processes: the device-route worker's pulls {ds['pulls']}, route "
            f"fallbacks {ds['route_fallbacks']}, fallbacks {ds['fallbacks']}")
    require(ts["pulls"] == {"local": 0, "device": 0, "tcp": n + 1}
            and ts["route_fallbacks"] == 0 and ts["fallbacks"] == 0,
            f"disagg processes: the DYNAMO_DEVICE_TRANSFER=0 worker's pulls {ts['pulls']}, "
            f"route fallbacks {ts['route_fallbacks']}, fallbacks {ts['fallbacks']}")
    require(fs["fallbacks"] == 2, f"disagg processes: {fs['fallbacks']} fallbacks after the "
                                  "error and corrupt faults (want 2)")
    require(out["disagg.pull:error@1x1 trips"].get("disagg.pull:error") == 1
            and out["disagg.pull:corrupt=1x1 trips"].get("disagg.pull:corrupt") == 1,
            f"disagg processes: fault trips {out['disagg.pull:error@1x1 trips']} "
            f"{out['disagg.pull:corrupt=1x1 trips']}")
    require(all(len(t) == SERVE_TOKENS for t in out["tokens"]),
            f"disagg processes: data-plane streams of {[len(t) for t in out['tokens']]} tokens")
    require(pre_log["steps"] == 0, f"disagg processes: the prefill worker ran "
                                   f"{pre_log['steps']} decode steps")
    fused = 0
    for x in logs:
        f = x["launches"].get("fused_decode_attention", 0)
        require(x["steps"] > 0 and (DEVICE != "cuda" or (f == L * x["steps"]
                                                          and x["replays"] == x["steps"])),
                f"disagg processes: a decode worker's launches {x}")
        fused += f
    # the streams under the reference forward, on the same seeded weights,
    # drawn here now that the workers are gone
    params = get_family(spec).init_params(spec, 0, device=DEVICE)
    checks = [near_argmax_check(spec, params, prompts[i], out["tokens"][i]) for i in range(n)]
    faults = {}
    for fault in ("disagg.pull:error@1x1", "disagg.pull:corrupt=1x1"):
        same, tie = equal_to_first_near_tie(spec, params, prompts[0], out[fault],
                                            out["clean"])
        require(same >= tie, f"disagg processes {fault}: the fallback stream parts from the "
                             f"clean one at token {same}, before the near-tie at {tie}")
        faults[fault] = (same, tie)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # the timed sets' pulls: the last n records of each route
    ds["records"], ts["records"] = ds["records"][-n:], ts["records"][-n:]
    dv, tc = disagg_pull_stats(ds, "device"), disagg_pull_stats(ts, "tcp")
    ps = out["pre_status"]
    stage = ps["stage_ms"][-n:]
    resumes = [ms for ms, _pages, _split in (ds["resumes"] + ts["resumes"])]
    split = resume_split(ds["resumes"] + ts["resumes"])

    def ms(xs):
        return f"mean {1e3 * sum(xs) / len(xs):.1f} ms, max {1e3 * max(xs):.1f} ms"

    def wall(span):
        return span[1] - span[0]

    def set_bursts(status, span, ttft):
        """The timed set's decode bursts (the worker's monotonic clock is
        this process's ``perf_counter``), split at the set's last first
        chunk: before it the prefill worker still ran forwards on the card;
        and those with a resume between dispatch and read."""
        last_first = span[0] + max(ttft)
        inside = [(t0, t1, r) for t0, t1, r in status["spans"] if span[0] <= t0 <= span[1]]

        def mean(xs):
            return [len(xs), round(1e3 * sum(xs) / len(xs), 3) if xs else None]

        return {"before": mean([t1 - t0 for t0, t1, _r in inside if t0 < last_first]),
                "after": mean([t1 - t0 for t0, t1, _r in inside if t0 >= last_first]),
                "resume": mean([t1 - t0 for t0, t1, r in inside if r])}

    dev_b = set_bursts(ds, out["device_span"], dev_ttft)
    tcp_b = set_bursts(ts, out["tcp_span"], tcp_ttft)

    def ms_list(xs):
        return (f"mean {sum(xs) / len(xs):.3f} ms, max {max(xs):.3f} ms over {len(xs)}"
                if xs else "none")

    print(f"disagg processes: hub, prefill worker, decode worker ({spec.name}, --precompile) "
          f"and frontend ready in {t_ready:.1f} s; {n} concurrent streamed completions x "
          f"{SERVE_TOKENS} tokens through the frontend, each set on cleared caches: client "
          f"TTFT device route {ms(dev_ttft)} ({wall(out['device_span']):.3f} s), TCP route "
          f"{ms(tcp_ttft)} ({wall(out['tcp_span']):.3f} s); first to second chunk device route "
          f"{ms(dev_gap)}, TCP route {ms(tcp_gap)}; phase 11 aggregated (2 workers) "
          f"mean {1e3 * p11_ttft[0]:.1f} ms, max {1e3 * p11_ttft[1]:.1f} ms [{card}]")
    print(f"disagg processes: device route (CUDA IPC), the timed set's {dv['n']} pulls, "
          f"{dv['bytes']} bytes over {dv['span_ms']:.1f} ms with a pull in flight, "
          f"{dv['gbs']:.2f} GB/s; per "
          f"pull control {dv['control']:.3f} ms, handle opens {dv['open']:.3f} ms, on-card copy "
          f"{dv['copy']:.3f} ms, total {dv['total']:.3f} ms (the pulls overlap) [{card}]")
    print(f"disagg processes: the prefill worker's exports: gather {ms_list(ps['gather_ms'])} "
          f"of device time, step thread {ms_list(ps['export_ms'])} of host time; the decode "
          f"workers' resumes (step-thread host time) {ms_list(resumes)}, mean by piece "
          f"{split} [{card}]")
    print(f"disagg processes: decode dispatch-to-host ([dispatches, mean ms]; pipelined, as "
          f"every worker) per decode worker (device route, TCP route) "
          f"{[x['dispatch_ms'] for x in logs]}, of those a resume ran on the step thread "
          f"between dispatch and read {[x['resume_dispatch_ms'] for x in logs]}; phase 11's "
          f"aggregated workers {p11_ttft[2]}; in the timed sets, bursts dispatched before the "
          f"set's last first chunk (the prefill worker's forwards on the card), after it, and "
          f"with a resume inside: device route {dev_b}, TCP route {tcp_b} [{card}]")
    print(f"disagg processes: TCP route (DYNAMO_DEVICE_TRANSFER=0 on the decode worker), the "
          f"timed set's {tc['n']} pulls, {tc['bytes']} bytes over {tc['span_ms']:.1f} ms with a "
          f"pull in flight, "
          f"{tc['gbs']:.2f} GB/s; per pull control "
          f"(request + the source's D2H and stamp + header) {tc['control']:.3f} ms, body reads "
          f"{tc['copy']:.3f} ms, checksum {tc['checksum']:.3f} ms, total {tc['total']:.3f} ms; "
          f"of the control, the source's serve-time D2H + stamp (host clock) mean "
          f"{sum(stage) / max(len(stage), 1):.3f} ms [{card}]")
    print(f"disagg processes: 0 route fallbacks; decode workers' fused_decode {fused} over "
          f"{[x['steps'] for x in logs]} steps ({L} per step), prefill worker 0 decode steps; "
          f"the data-plane streams near-argmax (worst gap {max(g for _, g in checks):.3f}); "
          f"faults on the TCP-route worker: disagg.pull error and corrupt each fell back to a "
          f"local prefill (fallbacks {fs['fallbacks']}, the corrupt payload caught by its "
          f"checksum), streams equal to the clean run up to (first difference, first "
          f"near-tie) {faults} [{card}]")
    return fused


def disagg_latent_roundtrip(card) -> None:
    """Phase 19 (d): deepseek-r1's latent blocks at full width (4 layers,
    page 16), bf16 and per-row fp8: extract -> export (on the card) -> TCP
    pull -> insert into other pages -> extract is bitwise, the inert int8 v
    slot crossing under ``v_dtype``."""
    from dynamo_tpu_torch.disagg import transfer
    from dynamo_tpu_torch.kvbm.offload import block_tensor
    from dynamo_tpu_torch.models.family import MlaFamily

    spec, fam = deepseek_spec(MLA_LAYERS), MlaFamily()
    g = torch.Generator(device=DEVICE).manual_seed(19)
    src, dst = [3, 9, 17, 30], [1, 2, 5, 31]

    async def roundtrip(kb, vb):
        source = await transfer.KvTransferSource().start()
        transfer._LOCAL_SOURCES.pop(source.uid)  # the socket route
        try:
            params = source.export(kb, vb, num_tokens=4 * 16, page_size=16)
            params.pop("cuda_ipc", None)  # one process: the TCP route
            return await asyncio.to_thread(transfer.pull_kv_blocks, params)
        finally:
            await source.close()

    for kv in ("bf16", "fp8"):
        cache, v = fam.init_cache(spec, 33, 16, device=DEVICE, kv_dtype=kv)
        if kv == "fp8":
            cache.vals.view(torch.uint8).copy_(torch.randint(
                0, 0x7F, cache.vals.shape, generator=g, device=DEVICE, dtype=torch.uint8))
            cache.scale.copy_(torch.rand(cache.scale.shape, generator=g, device=DEVICE))
        else:
            cache.copy_(torch.randn(cache.shape, generator=g, device=DEVICE))
        kb, vb = fam.extract_pages(cache, v, torch.tensor(src, device=DEVICE))
        k2, v2, _meta = asyncio.run(roundtrip(kb, vb))
        require(v2.dtype == np.int8 and v2.shape == (1, len(src)),
                f"disagg mla {kv}: v slot {v2.shape} {v2.dtype}")
        fam.insert_pages(cache, v, torch.tensor(dst, device=DEVICE),
                         block_tensor(k2).to(DEVICE), block_tensor(v2).to(DEVICE))
        again, _ = fam.extract_pages(cache, v, torch.tensor(dst, device=DEVICE))
        require(torch.equal(again.view(torch.uint8), kb.view(torch.uint8)),
                f"disagg mla {kv}: extract -> export -> TCP -> insert -> extract not bitwise")
        print(f"disagg mla {kv}: deepseek-r1 ({MLA_LAYERS} layers) latent blocks "
              f"{tuple(kb.shape)} {kb.dtype} and the int8 v slot {tuple(vb.shape)} over TCP "
              f"(k {k2.dtype}, v {v2.dtype}); extract -> export -> pull -> insert -> extract "
              f"bitwise [{card}]")


def disagg_phase(spec, cfg, prompts, base, p11_ttft, card, device=None) -> tuple[int, int]:
    """Phase 19: disaggregated serving. ``base`` holds phase 4's and phase
    8's aggregated streams and TTFT ({kv: (tokens, TTFT ms)}). Returns the
    fused_decode launches in bf16 form (in process and processes) and in
    fp8 form."""
    from dynamo_tpu_torch.models.family import get_family

    t0 = time.perf_counter()
    params = get_family(spec).init_params(spec, 0, device=DEVICE)
    bf16 = disagg_serve(spec, cfg, params, prompts, "bf16", *base["bf16"], card)
    fp8 = disagg_serve(spec, cfg, params, prompts, "fp8", *base["fp8"], card)
    del params
    bf16 += disagg_processes(spec, cfg, prompts, p11_ttft, card, device=device)
    disagg_latent_roundtrip(card)
    print(f"phase 19: {time.perf_counter() - t0:.1f} s")
    return bf16, fp8


# ------------------------------------------------------------ observability

# phase 20's span, audit and profile files (git-ignored)
OBS_DIR = ROOT / "build" / "observability"
OBS_CLIENT_SPAN = "b7ad6b7169203331"  # the stdlib client's span id (phase 20c)
OBS_WAIT_S = 15.0  # a span, audit record or sampled metric must land within this


def obs_spans(path: Path) -> list[dict]:
    """The JSONL span records of a trace file."""
    if not path.exists():
        return []
    return [json.loads(ln) for ln in path.read_text().splitlines() if ln.strip()]


def obs_request_spans(spans: list[dict], request_id: str) -> dict[str, dict]:
    """One request's worker-side spans by name: its worker.request and the
    engine.* spans under it."""
    wr = [s for s in spans if s["span"] == "worker.request"
          and s.get("request_id") == request_id]
    require(len(wr) == 1, f"observability: {len(wr)} worker.request spans for {request_id}")
    out = {"worker.request": wr[0]}
    for s in spans:
        if s["parent_span_id"] == wr[0]["span_id"]:
            out[s["span"]] = s
    return out


def obs_phase_lines(snap: dict, wall: float, label: str, card: str) -> None:
    """The profile's phases: seconds, calls, and share of the step thread's
    wall over ``wall`` (nested phases overlap their parents: process.d2h_sync
    and dispatch.d2h_wait lie inside process, readmit.d2h_wait inside the
    admission phases, the readmit.* spans cross cycles)."""
    rows = [f"{name} {rec['secs']:.4f} s x{rec['calls']} ({rec['secs'] / wall:.3f})"
            for name, rec in snap.items() if rec["secs"] or rec["calls"]]
    print(f"{label}: step-thread phases over {wall:.3f} s of serve wall [{card}]: "
          + "; ".join(rows))


def obs_metric(text: str, name: str, label: str | None = None) -> float:
    """One sample of a Prometheus text exposition (0 when absent), of the
    collector ``label`` when given."""
    sel = rf'\{{engine="{label}"\}}' if label is not None else r'\{engine="\d+"\}'
    m = re.search(rf"^{name}{sel} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


async def obs_stream(engine, req, tenant, priority, t0):
    """tenant_stream with the request's id: (items, seconds to its first
    token, seconds from ``t0`` to its end, request id)."""
    from dynamo_tpu_torch.runtime.context import PRIORITY_HEADER, TENANT_HEADER, Context

    t_sub = time.perf_counter()
    items, first = [], None
    ctx = Context(headers={TENANT_HEADER: tenant, PRIORITY_HEADER: priority})
    async for item in engine.generate(req, ctx):
        if item["token_ids"] and first is None:
            first = time.perf_counter() - t_sub
        items.append(item)
    return items, first, time.perf_counter() - t0, ctx.id


def obs_inprocess(spec, cfg, params, prompts, card) -> int:
    """Phase 20 (a) and (d): the default serve traced and profiled on a
    llama-3-8b engine, its gates, one packed prefill under torch.profiler,
    then the tracing-and-profiling overhead in interleaved serves on the
    same engine. Returns the fused_decode launches of its serves."""
    from dynamo_tpu_torch.engine import telemetry
    from dynamo_tpu_torch.runtime import tracing
    from dynamo_tpu_torch.runtime.flight import FLIGHT

    L, n = spec.num_layers, len(prompts)
    OBS_DIR.mkdir(parents=True, exist_ok=True)
    trace, scratch = OBS_DIR / "inprocess.jsonl", OBS_DIR / "overhead.jsonl"
    for f in (trace, scratch):
        f.unlink(missing_ok=True)
    engine = new_engine(spec, dict(cfg, kv_dtype="bf16", profile=True), "observability",
                        params=params)
    engine.reset_profile_window()  # the window starts after precompile's captures

    async def traced(e):
        FLIGHT.clear()
        tracing.set_trace_file(str(trace))
        col = telemetry.EngineCollector(e)  # its counters start at the window's 0
        t0 = time.perf_counter()
        res = await serve(e, prompts)
        wall = time.perf_counter() - t0
        col.sample()
        snap = e.profile_snapshot()
        tracing.set_trace_file(None)
        recent = FLIGHT.snapshot(n=n)["recent"]
        return {"serve": res, "wall": wall, "snap": snap,
                "render": telemetry.REGISTRY.render(), "label": col.label,
                "timelines": [FLIGHT.snapshot(t["request_id"])["timeline"] for t in recent]}

    def plain(on: bool):
        async def run(e):
            e._profiling = on
            tracing.set_trace_file(str(scratch) if on else None)
            try:
                return await serve(e, prompts)
            finally:
                tracing.set_trace_file(None)
                e._profiling = True
        return run

    order = [("off 1", False), ("on 1", True), ("on 2", True), ("off 2", False)]
    out = serve_phases(engine, [("traced", traced)] + [(k, plain(on)) for k, on in order])
    res, counts, steps = out["traced"]["res"], out["traced"]["counts"], out["traced"]["steps"]
    results, ttft, wall, _hit = res["serve"]
    snap = res["snap"]
    n_tok = sum(len(x["token_ids"]) for items in results.values() for x in items)
    # gates
    require(counts["fused_decode"] == L * steps == L * out["traced"]["replays"],
            f"observability: fused_decode {counts['fused_decode']} over {steps} steps")
    tls = res["timelines"]
    require(len(tls) == n, f"observability: {len(tls)} timelines for {n} requests")
    for tl in tls:
        names = [ev["name"] for ev in tl["events"]]
        require(names == ["admit", "first_token"] and tl["finish_reason"] == "length"
                and tl["generated"] == SERVE_TOKENS,
                f"observability: timeline {names}, finish {tl['finish_reason']}, "
                f"{tl['generated']} tokens")
    require(snap["dispatch.compile"]["calls"] == 0,
            f"observability: {snap['dispatch.compile']} graph captures after precompile()")
    disp = obs_metric(res["render"], "dynamo_engine_dispatches_total", res["label"])
    require(disp == snap["dispatch.dispatches"]["calls"] > 0,
            f"observability: dynamo_engine_dispatches_total {disp}, profile "
            f"{snap['dispatch.dispatches']}")
    burst_sum = obs_metric(res["render"], "dynamo_engine_burst_tokens_sum", res["label"])
    # each request's first token lands from its prefill's sample, not a burst
    require(burst_sum == n_tok - n,
            f"observability: burst tokens {burst_sum}, {n_tok - n} decode tokens streamed")
    spans = obs_spans(trace)
    for tl in tls:
        mine = obs_request_spans(spans, tl["request_id"])
        require(set(mine) == {"worker.request", "engine.queue_wait", "engine.prefill",
                              "engine.decode"}
                and all(s["trace_id"] == tl["trace_id"] for s in mine.values()),
                f"observability: spans of {tl['request_id']}: "
                f"{ {k: s['trace_id'] for k, s in mine.items()} }")
    pp = snap.get("packed_prefill", {"secs": 0.0, "calls": 0})
    ttft_ms = 1e3 * sum(ttft.values()) / len(ttft)
    print(f"observability serve [{card}]: {n} requests, {n_tok} tokens in {wall:.3f} s; "
          f"TTFT mean {ttft_ms:.1f} ms beside packed_prefill {1e3 * pp['secs']:.1f} ms over "
          f"{pp['calls']} calls ({1e3 * pp['secs'] / max(pp['calls'], 1):.1f} ms each); "
          f"dispatches {snap['dispatch.dispatches']['calls']} = "
          f"dynamo_engine_dispatches_total; graph captures after precompile 0; burst "
          f"tokens {burst_sum:.0f} + {n} first tokens = {n_tok} streamed; fused_decode "
          f"{counts['fused_decode']} = {L} x {steps}; {len(spans)} spans, every request's "
          f"worker.request, engine.queue_wait, engine.prefill and engine.decode on its "
          f"trace")
    obs_phase_lines(snap, res["wall"], "observability serve", card)
    split = {k: [obs_request_spans(spans, tl["request_id"])[k]["duration_ms"] for tl in tls]
             for k in ("engine.queue_wait", "engine.prefill", "engine.decode")}
    print(f"observability serve spans [{card}]: " + "; ".join(
        f"{k} mean {sum(v) / len(v):.1f} ms, max {max(v):.1f} ms" for k, v in split.items()))
    (OBS_DIR / "profile.json").write_text(json.dumps({"card": card, "profile": snap}))
    # one packed prefill of the 8 prompts (bucket of the longest), traced
    bts, _first, _lens = prefill_slots(engine, prompts)
    tokens = np.zeros((n, engine.config.bucket_for(max(len(p) for p in prompts))), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = p
    tok_d = torch.from_numpy(tokens).to(DEVICE)
    bts_d = torch.from_numpy(bts).to(DEVICE)
    lens = torch.tensor([len(p) for p in prompts])

    def packed():
        with torch.no_grad():
            engine.fam.prefill_batch(spec, engine.params, tok_d, bts_d,
                                     torch.zeros(n, dtype=torch.int64), engine.k_pages,
                                     engine.v_pages, lens)

    prof = profile_decode_step(packed, f"packed prefill ({n} prompts, bucket "
                                       f"{tokens.shape[1]}) [{card}]")
    if prof is not None:
        print(f"observability packed prefill [{card}]: host wall {prof['wall_ms']:.2f} ms "
              f"against device busy {prof['busy_ms']:.2f} ms "
              f"({prof['busy_ms'] / prof['wall_ms']:.3f} of the wall)")
    # (d) the overhead: the default serve with profiling and tracing off and
    # on, interleaved on the same engine
    for k, _on in order:
        o = out[k]
        rs, tt, w, _h = o["res"]
        nt = sum(len(x["token_ids"]) for items in rs.values() for x in items)
        require(o["counts"]["fused_decode"] == L * o["steps"],
                f"observability {k}: fused_decode {o['counts']['fused_decode']} over "
                f"{o['steps']} steps")
        print(f"observability overhead {k} (profiling and tracing {k.split()[0]}) [{card}]: "
              f"TTFT mean {1e3 * sum(tt.values()) / len(tt):.1f} ms, {nt / w:.1f} tok/s, "
              f"decode dispatch-to-host mean "
              f"{1e3 * sum(o['times']) / max(len(o['times']), 1):.2f} ms")
    drop_engine(engine)
    return sum(out[k]["counts"]["fused_decode"] for k in out)


def obs_overload(spec, cfg, params, prompts, card) -> int:
    """Phase 20 (b), the preempting overload cell of phase 13 profiled and
    traced: the interactive TTFT split into engine.queue_wait and
    engine.prefill, and the preempt phase. Returns fused_decode launches."""
    from dynamo_tpu_torch.runtime import tracing

    L = spec.num_layers
    inter, _pages = overload_prompts(spec.vocab_size)
    trace = OBS_DIR / "overload.jsonl"
    trace.unlink(missing_ok=True)

    async def drive(engine):
        tracing.set_trace_file(str(trace))
        t0 = time.perf_counter()
        batch = [asyncio.ensure_future(obs_stream(
            engine, make_request(p, OVERLOAD_BATCH_TOKENS), "bt", "batch", t0))
            for p in prompts]
        while (sum(s is not None and not s.first_pending for s in engine._slots)
               < len(prompts)):
            require(not any(b.done() for b in batch), "observability overload: a batch "
                                                      "stream ended before all held a slot")
            await asyncio.sleep(0.002)
        interactive = []
        for p in inter:
            interactive.append(asyncio.ensure_future(obs_stream(
                engine, make_request(p, OVERLOAD_INTERACTIVE_TOKENS), "it", "interactive",
                t0)))
            await asyncio.sleep(OVERLOAD_GAP_S)
        b_out = await asyncio.gather(*batch)
        i_out = await asyncio.gather(*interactive)
        tracing.set_trace_file(None)
        return {"batch": b_out, "inter": i_out, "wall": time.perf_counter() - t0,
                "snap": engine.profile_snapshot(), "preemptions": dict(engine.preemptions)}

    engine = new_engine(spec, dict(cfg, kv_dtype="bf16", pipeline_decode=True,
                                   pipeline_depth=2, decode_steps_per_dispatch=4,
                                   preemption=True, profile=True),
                        "observability overload", params=params)
    engine.reset_profile_window()
    out = serve_phases(engine, [("overload", drive)])["overload"]
    drop_engine(engine)
    counts, steps, res = out["counts"], out["steps"], out["res"]
    require(counts["fused_decode"] == L * steps,
            f"observability overload: fused_decode {counts['fused_decode']} over {steps}")
    for i, (items, _f, _e, _rid) in enumerate(res["batch"]):
        stream_tokens(items, OVERLOAD_BATCH_TOKENS, f"observability overload batch {i}")
    spans = obs_spans(trace)
    rows = []
    for i, (items, first, _e, rid) in enumerate(res["inter"]):
        stream_tokens(items, OVERLOAD_INTERACTIVE_TOKENS,
                      f"observability overload interactive {i}")
        mine = obs_request_spans(spans, rid)
        rows.append((1e3 * first, mine["engine.queue_wait"]["duration_ms"],
                     mine["engine.prefill"]["duration_ms"]))
    snap = res["snap"]
    pre = snap.get("preempt", {"secs": 0.0, "calls": 0})
    mean = [sum(r[k] for r in rows) / len(rows) for k in range(3)]
    print(f"observability overload [{card}]: interactive TTFT mean {mean[0]:.1f} ms = "
          f"engine.queue_wait {mean[1]:.1f} ms + engine.prefill {mean[2]:.1f} ms (+ the "
          f"stream's hops); per request (TTFT, queue_wait, prefill) ms "
          f"{[tuple(round(x, 1) for x in r) for r in rows]}; preempt {pre['secs']:.4f} s "
          f"over {pre['calls']} calls; preemptions {res['preemptions']}; {steps} decode "
          f"steps, fused_decode {counts['fused_decode']}")
    obs_phase_lines(snap, res["wall"], "observability overload", card)
    return counts["fused_decode"]


def obs_guided(spec, cfg, params, prompts, card) -> int:
    """Phase 20 (b), phase 14's guided mixed serve profiled: guided.mask,
    build_batch, dispatch and process per decode step. Returns fused_decode
    launches."""
    from dynamo_tpu_torch.frontend.tokenizer import MockTokenizer
    from dynamo_tpu_torch.guided import TokenVocab

    L = spec.num_layers
    vocab = TokenVocab.from_tokenizer(MockTokenizer(), spec.vocab_size)
    grammars = guided_grammars(vocab)
    kinds = ["json_schema", "json_schema", "json_object", "json_object", "regex", "regex",
             "free", "free"]
    reqs = guided_requests(prompts, grammars, kinds)
    engine = guided_engine(spec, dict(cfg, pipeline_decode=True, pipeline_depth=2,
                                      decode_steps_per_dispatch=4, profile=True),
                           params, vocab, "observability guided")
    engine.reset_profile_window()

    async def mixed(e):
        t0 = time.perf_counter()
        r = await requests(e, reqs)
        return r, time.perf_counter() - t0, e.profile_snapshot()

    out = serve_phases(engine, [("guided", mixed)])["guided"]
    drop_engine(engine)
    (items, _ttft, _w), wall, snap = out["res"]
    counts, steps = out["counts"], out["steps"]
    require(counts["fused_decode"] == L * steps,
            f"observability guided: fused_decode {counts['fused_decode']} over {steps}")
    require(all(it[-1]["finish_reason"] in ("stop", "length") for it in items),
            f"observability guided: finishes {[it[-1]['finish_reason'] for it in items]}")
    n_tok = sum(len(x["token_ids"]) for it in items for x in it)
    per = []
    for name in ("guided.mask", "build_batch", "dispatch", "process"):
        rec = snap.get(name, {"secs": 0.0, "calls": 0})
        per.append(f"{name} {rec['secs']:.4f} s x{rec['calls']} = "
                   f"{1e3 * rec['secs'] / max(steps, 1):.3f} ms per step")
    print(f"observability guided [{card}]: {n_tok} tokens in {wall:.3f} s over {steps} decode "
          f"steps; " + "; ".join(per))
    obs_phase_lines(snap, wall, "observability guided", card)
    return counts["fused_decode"]


async def _obs_drive(spec, prompts, port, worker, audit: Path, traces: dict) -> dict:
    """Phase 20 (c)'s traffic: 8 streamed completions from a stdlib client,
    each with a traceparent of its own, then the gates' reads."""
    name = spec.name
    t0 = time.perf_counter()
    while True:
        status, body, _ = await http_call(port, "GET", "/v1/models")
        if status == 200 and [m["id"] for m in json.loads(body)["data"]] == [name]:
            break
        require(time.perf_counter() - t0 < 60, "observability processes: no model listed")
        await asyncio.sleep(0.1)
    tids = [f"{0xd00 + i:032x}" for i in range(len(prompts))]
    t1 = time.perf_counter()
    streams = await asyncio.gather(*(http_call(port, "POST", "/v1/completions", {
        "model": name, "prompt": p, "max_tokens": SERVE_TOKENS, "ignore_eos": True,
        "stream": True, "stream_options": {"include_usage": True}},
        headers={"traceparent": f"00-{tid}-{OBS_CLIENT_SPAN}-01"})
        for p, tid in zip(prompts, tids)))
    wall = time.perf_counter() - t1
    ttft = []
    for i, (status, body, times) in enumerate(streams):
        ev = sse_events(body)
        usage = (ev[-2].get("usage") or {}) if len(ev) > 1 else {}
        require(status == 200 and ev[-1] == "[DONE]"
                and usage.get("completion_tokens") == SERVE_TOKENS,
                f"observability processes: stream {i} status {status}, usage {usage}")
        ttft.append(times[0])
    # the spans, audit records and sampled series land asynchronously
    deadline = time.perf_counter() + OBS_WAIT_S
    while True:
        wr = [s for s in obs_spans(traces["worker"]) if s["span"] == "worker.request"
              and s["trace_id"] in tids]
        recs = [json.loads(ln) for ln in audit.read_text().splitlines()] if audit.exists() else []
        _st, mbody, _t = await http_call(worker.status_port, "GET", "/metrics")
        text = mbody.decode()
        steps_n = obs_metric(text, "dynamo_engine_step_seconds_count")
        disp = obs_metric(text, "dynamo_engine_dispatches_total")
        if (len(wr) == len(prompts) and len(recs) >= len(prompts) and steps_n > 0
                and disp > 0):
            break
        require(time.perf_counter() < deadline,
                f"observability processes: {len(wr)} worker.request spans, {len(recs)} "
                f"audit records, step count {steps_n}, dispatches {disp}")
        await asyncio.sleep(0.2)
    rid = next(s for s in wr if s["trace_id"] == tids[0])["request_id"]
    status, body, _ = await http_call(port, "GET", f"/debug/timeline?request_id={rid}")
    require(status == 200, f"observability processes: /debug/timeline {status}")
    tl = json.loads(body)
    found = [w["timeline"] for comp in tl["results"].values() for w in comp.values()
             if isinstance(w, dict) and w.get("found")]
    return {"tids": tids, "ttft": ttft, "wall": wall, "audit": recs, "timeline": found,
            "metrics": (steps_n, disp), "rid": rid}


def obs_processes(spec, cfg, prompts, card, device=None) -> int:
    """Phase 20 (c): ``cli hub``, one ``cli worker --precompile`` and ``cli
    frontend`` over TCP, as phase 11 builds them, each with a trace file of
    its own and the frontend with an audit file. Returns the worker's
    fused_decode launches."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    L = spec.num_layers
    OBS_DIR.mkdir(parents=True, exist_ok=True)
    traces = {k: OBS_DIR / f"{k}.jsonl" for k in ("hub", "worker", "frontend")}
    audit = OBS_DIR / "audit.jsonl"
    for f in (*traces.values(), audit):
        f.unlink(missing_ok=True)
    dev = ["--device", device] if device else []
    flags = ["--page-size", str(cfg["page_size"]), "--num-pages", str(cfg["num_pages"]),
             "--max-pages-per-seq", str(cfg["max_pages_per_seq"]),
             "--max-decode-slots", str(cfg["max_decode_slots"])]
    children: list[Child] = []
    t0 = time.perf_counter()
    try:
        hub_proc = Child("hub", "--port", "0", env={"DYN_TRACE_FILE": str(traces["hub"])})
        children.append(hub_proc)
        hub = hub_proc.wait_line("DYNAMO_HUB=", 60).split("=", 1)[1]
        worker = Child("worker", "--hub", hub, "--model", spec.name, "--precompile",
                       "--health-port", "0", *flags, *dev,
                       env={"DYN_TRACE_FILE": str(traces["worker"])})
        children.append(worker)
        front = Child("frontend", "--hub", hub, "--port", "0", "--host", "127.0.0.1",
                      env={"DYN_TRACE_FILE": str(traces["frontend"]),
                           "DYN_AUDIT_PATH": str(audit)})
        children.append(front)
        port = int(front.wait_line("DYNAMO_HTTP=", 60).rsplit(":", 1)[1])
        worker.status_port = int(worker.wait_line("SYSTEM_STATUS_PORT=", PROC_START_S)
                                 .split("=", 1)[1])
        worker.wait_line("ENGINE_READY", PROC_START_S)
        t_ready = time.perf_counter() - t0
        out = asyncio.run(_obs_drive(spec, prompts, port, worker, audit, traces))
        for child in (worker, front, hub_proc):
            require(child.stop() == 0, f"{child.name} exited non-zero: {child.seen[-8:]}")
    finally:
        for child in children:
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait(30)
    log = json.loads(worker.logged("ENGINE_LAUNCHES ").split(" ", 1)[1])
    fused, steps = log["launches"].get("fused_decode_attention", 0), log["steps"]
    require(DEVICE != "cuda" or (fused == L * steps and steps > 0),
            f"observability processes: fused_decode {fused} over {steps} logged steps")
    fspans, wspans = obs_spans(traces["frontend"]), obs_spans(traces["worker"])
    splits = []
    for tid in out["tids"]:
        f = {s["span"]: s for s in fspans if s["trace_id"] == tid}
        w = [s for s in wspans if s["trace_id"] == tid]
        wr = [s for s in w if s["span"] == "worker.request"]
        require({"http.request", "http.preprocess", "transport.call"} <= set(f)
                and len(wr) == 1,
                f"observability processes: trace {tid}: frontend {sorted(f)}, "
                f"worker {sorted(s['span'] for s in w)}")
        require(f["http.request"]["parent_span_id"] == OBS_CLIENT_SPAN
                and f["transport.call"]["parent_span_id"] == f["http.request"]["span_id"]
                and wr[0]["parent_span_id"] == f["transport.call"]["span_id"],
                f"observability processes: trace {tid}: the worker.request is not the "
                "frontend transport.call's child")
        eng = {s["span"]: s for s in w if s["parent_span_id"] == wr[0]["span_id"]}
        require({"engine.queue_wait", "engine.prefill", "engine.decode"} <= set(eng),
                f"observability processes: trace {tid}: engine spans {sorted(eng)}")
        splits.append((f["http.request"]["duration_ms"], f["transport.call"]["duration_ms"],
                       wr[0]["duration_ms"], eng["engine.queue_wait"]["duration_ms"],
                       eng["engine.prefill"]["duration_ms"],
                       eng["engine.decode"]["duration_ms"]))
    require(len(out["timeline"]) == 1
            and [e["name"] for e in out["timeline"][0]["events"]] == ["admit", "first_token"]
            and out["timeline"][0]["finish_reason"] == "length",
            f"observability processes: /debug/timeline answered {out['timeline']}")
    recs = out["audit"]
    require(len(recs) == len(prompts) and all(
        r["status"] == 200 and r["output_tokens"] == SERVE_TOKENS for r in recs),
        f"observability processes: audit records {[(r['status'], r['output_tokens']) for r in recs]}")
    mean = [sum(s[k] for s in splits) / len(splits) for k in range(6)]
    hub_spans = len(obs_spans(traces["hub"]))
    print(f"observability processes [{card}]: hub, worker, frontend ready in {t_ready:.1f} s; "
          f"{len(prompts)} traced streams in {out['wall']:.3f} s, client TTFT mean "
          f"{1e3 * sum(out['ttft']) / len(out['ttft']):.1f} ms; every request one trace "
          f"across the files (frontend {len(fspans)} spans, worker {len(wspans)}, hub "
          f"{hub_spans}), worker.request under the frontend's transport.call; span means "
          f"ms: http.request {mean[0]:.1f}, transport.call {mean[1]:.1f}, worker.request "
          f"{mean[2]:.1f} = queue_wait {mean[3]:.1f} + prefill {mean[4]:.1f} + decode "
          f"{mean[5]:.1f}; /debug/timeline read {out['rid']}; worker /metrics "
          f"dynamo_engine_step_seconds_count {out['metrics'][0]:.0f}, "
          f"dynamo_engine_dispatches_total {out['metrics'][1]:.0f}; audit {len(recs)} "
          f"records of {SERVE_TOKENS} tokens; fused_decode {fused} = {L} x {steps}")
    return fused


def observability_phase(spec, cfg, params, prompts, card) -> int:
    """Phase 20 (a), (b) and (d) on phase 4's weights. Returns the
    fused_decode launches of its serves."""
    t0 = time.perf_counter()
    launches = obs_inprocess(spec, cfg, params, prompts, card)
    launches += obs_overload(spec, cfg, params, prompts, card)
    launches += obs_guided(spec, cfg, params, prompts, card)
    print(f"phase 20 (a, b, d): {time.perf_counter() - t0:.1f} s, fused_decode {launches}")
    return launches


# ------------------------------------------------------------ multimodal

MM_TOKENS = 576  # CLIP ViT-L/14-336: (336 / 14)^2 placeholder rows per image
MM_IMAGE_TOKEN = 128011  # a reserved id of llama-3's vocabulary
MM_SEED = 2121
# (kind, width, height, filtered): solid colours, a gradient and seeded
# noise, none 336; filtered rows rotate the five filter types (an RGB
# encoder's adaptive filtering mixes them), the others use None on every
# row (as libpng writes palette and low-depth images): the decoder's two
# paths
MM_PNGS = (("red", 500, 375, True), ("noise", 400, 300, True),
           ("gradient", 640, 480, True), ("blue", 375, 500, False))
# the tower's rows on the card against the same tower on the CPU (both f32,
# TF32 off): at most this share of the rows' largest magnitude
MM_TOWER_TOL = 1e-4
MM_REPS = 5
MM_TEXT = "Describe the picture in one sentence."
EMB_MODEL = "llama-3-8b-embed"
EMB_INPUTS = 8
EMB_NORM_TOL = 1e-3
# a batch's vectors against the same inputs one by one (the same forward at
# the same bucket on the same card)
EMB_EQ_TOL = 1e-5
# embed_forward and the injected prefill's logits on the card against the
# same calls on the CPU, both f32 (TF32 off), on llama-3-8b's first
# MM_CUT_LAYERS layers at full width: at most this share of the largest
# magnitude of the CPU's values
MM_CUT_LAYERS = 2
MM_CUT_TOL = 1e-4


def mm_png(kind: str, w: int, h: int, filtered: bool) -> bytes:
    """An RGB PNG written here with zlib, its rows filtered with the five
    filter types in turn (None, Sub, Up, Average, Paeth) when ``filtered``,
    else None on every row."""
    import struct
    import zlib

    if kind == "noise":
        px = np.random.default_rng(MM_SEED).integers(0, 256, (h, w, 3), dtype=np.uint8)
    elif kind == "gradient":
        gx, gy = np.meshgrid(np.linspace(0, 255, w), np.linspace(0, 255, h))
        px = np.stack([gx, gy, np.full_like(gx, 128)], axis=-1).astype(np.uint8)
    else:
        px = np.zeros((h, w, 3), np.uint8)
        px[..., 0 if kind == "red" else 2] = 255

    def chunk(name: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + name + body
                + struct.pack(">I", zlib.crc32(name + body)))

    cur = px.reshape(h, w * 3).astype(np.int16)
    up = np.concatenate([np.zeros((1, w * 3), np.int16), cur[:-1]])
    left = np.pad(cur, ((0, 0), (3, 0)))[:, :-3]
    upleft = np.pad(up, ((0, 0), (3, 0)))[:, :-3]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = (np.zeros_like(cur), left, up, (left + up) >> 1, paeth)
    ftype = np.arange(h) % 5 if filtered else np.zeros(h, np.int64)
    pred = np.choose(ftype[:, None], preds)
    rows = np.concatenate([ftype[:, None], (cur - pred) & 0xFF], axis=1).astype(np.uint8)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


def mm_tower(spec, pngs: dict, card: str):
    """Phase 21 (a) and (b): each PNG decoded and preprocessed on the host;
    the ViT-L/14-336 tower with its 1,024 -> 1,024 -> hidden projector (the
    encode worker's ``_build_vit``), seeded, timed at batch 1 and 4, and held
    against the same tower on the CPU. Returns the encoder."""
    from dataclasses import replace

    from dynamo_tpu_torch.multimodal import image, vit

    vspec = vit.VitSpec()
    vspec = replace(vspec, projector_hidden=vspec.hidden_size, llm_hidden=spec.hidden_size)
    S = vspec.image_size
    filtered = {kind: f for kind, _, _, f in MM_PNGS}
    pix = []
    for kind, data in pngs.items():
        t0 = time.perf_counter()
        p = image.preprocess_image(data, S)
        ms = 1e3 * (time.perf_counter() - t0)
        require(p.shape == (3, S, S) and p.dtype == np.float32 and np.isfinite(p).all(),
                f"multimodal: {kind} preprocessed to {p.shape} {p.dtype}")
        pix.append(p)
        rows = "filter types rotated" if filtered[kind] else "filter None"
        print(f"multimodal decode [{card}]: {kind} PNG of {len(data)} bytes ({rows}) -> "
              f"[3, {S}, {S}] in {ms:.1f} ms host")
    enc = vit.VitEncoder(vspec, device=DEVICE, generator=torch.Generator().manual_seed(MM_SEED))
    require(enc.tokens_per_image == MM_TOKENS and enc.hidden_size == spec.hidden_size,
            f"multimodal: tower gives {enc.tokens_per_image} x {enc.hidden_size} rows")
    batch = torch.from_numpy(np.stack(pix)).to(DEVICE)
    for n in (1, 4):
        x = batch[:n]
        enc.forward_pixels(x)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(MM_REPS):
            rows = enc.forward_pixels(x)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / MM_REPS
        require(rows.shape == (n * MM_TOKENS, spec.hidden_size)
                and torch.isfinite(rows).all().item(), f"multimodal: tower rows {rows.shape}")
        print(f"multimodal tower [{card}]: ViT-L/14-336 f32 + projector to {spec.hidden_size}, "
              f"batch {n}: {ms:.2f} ms ({ms / n:.2f} ms per image, device)")
    got = enc.forward_pixels(batch[:1]).cpu()
    cpu = vit.params_to(enc.params, "cpu")
    with torch.inference_mode():
        want = vit.project(cpu["projector"], vit.VisionTower(vspec, cpu)(batch[:1].cpu()))
    want = want.reshape(-1, want.shape[-1])
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    require(err <= MM_TOWER_TOL * scale,
            f"multimodal: card tower vs CPU tower max abs err {err:.3e} (rows up to {scale:.3e})")
    print(f"multimodal tower [{card}]: card vs CPU max abs err {err:.3e} of rows up to "
          f"{scale:.3e} (tolerance {MM_TOWER_TOL} of it)")
    return enc


def mm_logits_check(spec, params, prompt: list[int], positions: list[int], rows: np.ndarray,
                    first_token: int) -> float:
    """The image prompt's first-token logits (one prefill with the rows
    injected, on scratch pools) differ from the same ids with the
    placeholders left as text, and the served first token is near-argmax
    of them. Returns the largest logit difference."""
    from dynamo_tpu_torch.models import llama

    page = 16
    T = 1 << (len(prompt) - 1).bit_length()
    n_pages = T // page
    k, v = llama.init_cache(spec, n_pages + 1, page, device=DEVICE)
    bt = torch.arange(1, n_pages + 1, dtype=torch.int32, device=DEVICE)
    tokens = torch.zeros(T, dtype=torch.int64, device=DEVICE)
    tokens[: len(prompt)] = torch.tensor(prompt, device=DEVICE)
    with torch.inference_mode():
        mm, _ = llama.prefill_forward(
            spec, params, tokens, bt, 0, k, v, len(prompt),
            mm_embeds=torch.from_numpy(rows).to(DEVICE),
            mm_pos=torch.tensor(positions, device=DEVICE))
        text, _ = llama.prefill_forward(spec, params, tokens, bt, 0, k, v, len(prompt))
    del k, v
    require(torch.isfinite(mm).all().item() and torch.isfinite(text).all().item(),
            "multimodal: non-finite first-token logits")
    diff = (mm - text).abs().max().item()
    require(diff > 0.0, "multimodal: the injected rows left the first-token logits unchanged")
    gap = (mm.max() - mm[first_token]).item()
    require(gap <= NEAR_ARGMAX, f"multimodal: served first token {gap:.3f} below the max")
    return diff


def mm_cut_check(spec, params, prompt: list[int], positions: list[int], rows: np.ndarray,
                 card: str) -> None:
    """The values of ``embed_forward`` and of the multimodal injection on
    the card: llama-3-8b's first MM_CUT_LAYERS layers, its embedding, final
    norm and head at full width, in f32 on the card and on the CPU, run
    through the same calls on the same inputs (the image prompt with the
    red image's rows injected; its first 37 ids as an embedding input)."""
    from dataclasses import replace

    from dynamo_tpu_torch.models import llama

    cut = replace(spec, num_layers=MM_CUT_LAYERS, dtype="float32")
    page = 16
    T = -(-len(prompt) // page) * page
    n_emb = 37
    emb_ids = np.zeros(64, np.int64)
    emb_ids[:n_emb] = prompt[:n_emb]
    outs = {}
    for dev in (DEVICE, "cpu"):
        f32 = {"device": dev, "dtype": torch.float32}
        p = llama.LlamaParams(
            params.embed.to(**f32), params.final_norm.to(**f32),
            [{n: t.detach().to(**f32) for n, t in lp.named_parameters()}
             for lp in params.layers[:MM_CUT_LAYERS]],
            None if params.lm_head is None else params.lm_head.to(**f32))
        k, v = llama.init_cache(cut, T // page + 1, page, device=dev)
        bt = torch.arange(1, T // page + 1, dtype=torch.int32, device=dev)
        tokens = torch.zeros(T, dtype=torch.int64, device=dev)
        tokens[: len(prompt)] = torch.tensor(prompt, device=dev)
        with torch.inference_mode():
            logits, _ = llama.prefill_forward(
                cut, p, tokens, bt, 0, k, v, len(prompt),
                mm_embeds=torch.from_numpy(rows).to(dev),
                mm_pos=torch.tensor(positions, device=dev))
            emb = llama.embed_forward(cut, p, torch.from_numpy(emb_ids).to(dev), n_emb)
            if dev == DEVICE:  # the placeholders left as text
                text, _ = llama.prefill_forward(cut, p, tokens, bt, 0, k, v, len(prompt))
                outs["text"] = text.float().cpu()
        outs[dev] = [x.float().cpu() for x in (logits, emb)]
        del p, k, v
        torch.cuda.empty_cache()
    (got, got_emb), (want, want_emb) = outs[DEVICE], outs["cpu"]
    for name, g, w in (("injected prefill logits", got, want),
                       ("embed_forward", got_emb, want_emb)):
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        require(torch.isfinite(g).all().item() and err <= MM_CUT_TOL * scale,
                f"multimodal: card vs CPU {name} max abs err {err:.3e} (values up to "
                f"{scale:.3e})")
        print(f"multimodal values [{card}]: {name}, llama-3-8b's first {MM_CUT_LAYERS} "
              f"layers in f32, card vs CPU max abs err {err:.3e} of values up to {scale:.3e} "
              f"(tolerance {MM_CUT_TOL} of it)")
    # the check has teeth: the rows move the logits far past its tolerance
    moved = (got - outs["text"]).abs().max().item()
    require(moved > 100 * MM_CUT_TOL * want.abs().max().item(),
            f"multimodal: the rows moved the cut's logits by only {moved:.3e}")
    require(abs(torch.linalg.vector_norm(got_emb).item() - 1.0) <= EMB_NORM_TOL,
            "multimodal: the card's embedding is not of unit norm")
    print(f"multimodal values [{card}]: the rows moved the cut's logits by up to {moved:.3e}")


MM_FIXTURES = ROOT / "tests" / "torch_mm_fixtures"
MM_VIDEO_FRAMES = 8  # the encode worker's and the card's default
# the video engine: one prefill dispatch holds 8 x 576 placeholder rows and
# the chat around them (the prompt must fit one dispatch)
MM_VIDEO_TOKENS = 5120


def mm_fixture_decodes(card: str, names: tuple[str, ...]) -> dict:
    """Phase 21 (e) and (f), host side: each named fixture decoded (frame
    0) and held to the manifest; a file of several frames sampled into
    MM_VIDEO_FRAMES PNG frames held to the manifest's digests. Returns the
    files."""
    import hashlib
    import zlib

    from dynamo_tpu_torch.multimodal import encoder, image

    manifest = json.loads((MM_FIXTURES / "manifest.json").read_text())
    ours, theirs = zlib.ZLIB_RUNTIME_VERSION, manifest["versions"]["zlib"]
    files = {}
    for name in names:
        entry = manifest["files"][name]
        data = (MM_FIXTURES / name).read_bytes()
        require(hashlib.sha256(data).hexdigest() == entry["sha256"],
                f"multimodal formats: {name} is not the committed file")
        t0 = time.perf_counter()
        rgb, info = image.decode_image(data)
        ms = 1e3 * (time.perf_counter() - t0)
        digest = hashlib.sha256(rgb.tobytes()).hexdigest()
        require(digest == entry["rgb_sha256"] and list(rgb.shape) == entry["shape"],
                f"multimodal formats: {name} decoded to {rgb.shape} {digest[:12]}, Pillow's "
                f"{entry['shape']} {entry['rgb_sha256'][:12]}")
        print(f"multimodal formats [{card}]: {name} ({len(data)} bytes) -> {rgb.shape[1]}x"
              f"{rgb.shape[0]} RGB equal to Pillow's (sha256) in {ms:.1f} ms host"
              + (", ICC profile kept" if info.get("icc_profile") else ""))
        files[name] = data
        if "n_frames" not in entry:
            continue
        require(image.frame_count(data) == entry["n_frames"],
                f"multimodal formats: {name} counts {image.frame_count(data)} frames, "
                f"Pillow {entry['n_frames']}")
        n = entry["n_frames"]
        idx = sorted({round(i * (n - 1) / (MM_VIDEO_FRAMES - 1)) for i in range(MM_VIDEO_FRAMES)})
        t0 = time.perf_counter()
        for _ in image.frames(data, idx):
            pass
        decode_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        frames = encoder.sample_video_frames(data, MM_VIDEO_FRAMES)
        ms = 1e3 * (time.perf_counter() - t0)
        if ours == theirs:
            got = [hashlib.sha256(f).hexdigest() for f in frames]
            require(got == entry["frame_png_sha256"],
                    f"multimodal formats: {name}'s sampled PNG frames differ from the reference's")
            held = "PNG bytes equal to the reference's (sha256)"
        else:
            got = [hashlib.sha256(image.decode_png(f).tobytes()).hexdigest() for f in frames]
            require(got == entry["frame_rgb_sha256"],
                    f"multimodal formats: {name}'s sampled frames' pixels differ from Pillow's")
            same = sum(hashlib.sha256(f).hexdigest() == want
                       for f, want in zip(frames, entry["frame_png_sha256"]))
            held = (f"zlib {ours} here, {theirs} in the manifest: each frame's pixels equal "
                    f"to Pillow's (sha256), {same} of {len(frames)} frames' PNG bytes equal to "
                    "the manifest's")
        last = idx[-1] + 1  # decoded forward to the last sampled frame
        print(f"multimodal formats [{card}]: {name} ({n} frames) sampled into {len(frames)} PNG "
              f"frames in {ms:.1f} ms host (decode alone {decode_ms:.1f} ms over the {last} "
              f"frames decoded, {decode_ms / last:.1f} ms per frame); {held}")
    return files


# phase 21 (e)'s fixtures, and (f)'s: WebP (lossy, lossless with alpha,
# animated), APNG and MPO
MM_FILES_E = ("anim_320x240.gif", "grey_333x251.jpg", "photo_420_icc_rst.jpg",
              "photo_422_progressive.jpg")
MM_FILES_F = ("alpha_200x150_lossless.webp", "anim_160x120.png", "anim_160x120.webp",
              "photo_640x480.webp", "stereo_320x240.mpo")


def mm_formats_phase(spec, cfg, params, enc, card) -> int:
    """Phase 21 (e) and (f) on one encode worker and one engine worker sized
    for one video prompt, through the HTTP frontend: (e) the JPEG chat
    against its PNG twin and the GIF video chat; (f) a lossy WebP chat and
    an MPO chat (frame 0) each against its PNG twin, an animated WebP and
    an APNG video chat. Returns the fused_decode launches of both."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.worker import launch_engine_worker
    from dynamo_tpu_torch.frontend.http import HttpFrontend
    from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
    from dynamo_tpu_torch.multimodal import image
    from dynamo_tpu_torch.multimodal.worker import launch_encode_worker
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub import InMemoryHub

    t0 = time.perf_counter()
    name, L = spec.name, spec.num_layers
    files = mm_fixture_decodes(card, MM_FILES_E)
    print(f"phase 21 (e) host decodes: {time.perf_counter() - t0:.1f} s")
    tf0 = time.perf_counter()
    files.update(mm_fixture_decodes(card, MM_FILES_F))
    tf_host = time.perf_counter() - tf0

    def twin_of(data):
        rgb, info = image.decode_image(data)
        return image.encode_png(rgb, info.get("transparency"), info.get("icc_profile"))

    stills = {"jpeg": files["photo_420_icc_rst.jpg"], "webp": files["photo_640x480.webp"],
              "mpo": files["stereo_320x240.mpo"]}
    twins = {k: twin_of(v) for k, v in stills.items()}
    for k in stills:
        rows = [enc.forward_pixels(enc.pixels([b])).float().cpu() for b in (stills[k], twins[k])]
        require(torch.equal(*rows),
                f"multimodal formats: the {k} image's tower rows differ from its PNG twin's")
    mime = {"jpeg": "image/jpeg", "webp": "image/webp", "mpo": "image/jpeg"}

    def url(kind, data):
        return f"data:{kind};base64," + base64.b64encode(data).decode()

    def chat(part):
        return {"model": name, "max_tokens": SERVE_TOKENS, "ignore_eos": True,
                "temperature": 0.0,
                "messages": [{"role": "user", "content": [{"type": "text", "text": MM_TEXT},
                                                          part]}]}

    def image_chat(kind, data):
        return chat({"type": "image_url", "image_url": {"url": url(kind, data)}})

    def video_chat(kind, data):
        return chat({"type": "video_url", "video_url": {"url": url(kind, data)}})

    chats = {k: image_chat(mime[k], v) for k, v in stills.items()}
    twin_chats = {k: image_chat("image/png", v) for k, v in twins.items()}
    videos = {"gif": video_chat("image/gif", files["anim_320x240.gif"]),
              "webp": video_chat("image/webp", files["anim_160x120.webp"]),
              "apng": video_chat("image/png", files["anim_160x120.png"])}
    text_chat = {**chat({"type": "text", "text": "."}),
                 "messages": [{"role": "user", "content": MM_TEXT}]}
    buckets = tuple(b for b in (64, 128, 256, 512, 1024, 2048, 4096) if b < MM_VIDEO_TOKENS)
    encode_s: list[float] = []  # the encode worker's decode, sampling and tower
    rows_s: list[float] = []  # the engine's decode of the rows' payload
    tower_encode = enc.encode

    def timed_encode(images):
        t = time.perf_counter()
        try:
            return tower_encode(images)
        finally:
            encode_s.append(time.perf_counter() - t)

    enc.encode = timed_encode

    async def drive():
        drt = DistributedRuntime(InMemoryHub())
        await launch_encode_worker(drt, hidden_size=spec.hidden_size, encoder=enc,
                                   video_frames=MM_VIDEO_FRAMES)
        engine, _ = await launch_engine_worker(
            drt, model=name, spec=spec, params=params, device=DEVICE,
            engine_config=EngineConfig(**dict(
                cfg, max_pages_per_seq=MM_VIDEO_TOKENS // cfg["page_size"],
                max_prefill_chunk_tokens=MM_VIDEO_TOKENS,
                prefill_buckets=buckets + (MM_VIDEO_TOKENS,)), pipeline_decode=True),
            mm_tokens_per_image=MM_TOKENS, image_token_id=MM_IMAGE_TOKEN,
            mm_video_frames=MM_VIDEO_FRAMES)
        engine_decode = engine._decode_multimodal

        def timed_decode(req):
            t = time.perf_counter()
            try:
                return engine_decode(req)
            finally:
                rows_s.append(time.perf_counter() - t)

        engine._decode_multimodal = timed_decode
        watcher = await ModelWatcher(drt, ModelManager()).start()
        frontend = HttpFrontend(watcher.manager, host="127.0.0.1", port=0)
        out: dict = {}
        try:
            await watcher.wait_for_model(name, timeout=30)
            _, port = await frontend.start()
            pipe = watcher.manager.get(name)

            async def post(body):
                """(body, client wall s, encode s, rows decode s)."""
                t, e0, d0 = time.perf_counter(), len(encode_s), len(rows_s)
                status, raw, _ = await http_call(port, "POST", "/v1/chat/completions", body)
                resp = json.loads(raw)
                require(status == 200 and resp["usage"]["completion_tokens"] == SERVE_TOKENS,
                        f"multimodal formats: {status} {str(resp)[:300]}")
                return resp, time.perf_counter() - t, sum(encode_s[e0:]), sum(rows_s[d0:])

            async def tokens(body):
                items = [x async for x in pipe.generate(pipe.preprocessor.preprocess(body),
                                                        Context())]
                return [t for x in items for t in x.get("token_ids") or ()]

            async def part(stills_, videos_):
                """The chats of one part, its decode steps and launches."""
                zero_counts()
                s0, r0 = engine.steps, engine._graphs.replays
                res: dict = {"t0": time.perf_counter()}
                for k in stills_:
                    res[k] = await post(chats[k])
                    res[k + " twin"] = await post(twin_chats[k])
                    res[k + " streams"] = [await tokens(chats[k]), await tokens(twin_chats[k])]
                for k in videos_:
                    res[k + " video"] = await post(videos[k])
                res["text prompt"] = (await post(text_chat))[0]
                res["steps"] = engine.steps - s0
                res["replays"] = engine._graphs.replays - r0
                res["counts"] = read_counts()
                res["wall"] = time.perf_counter() - res["t0"]
                return res

            # warm-up: a text chat (the decode graphs' lazy capture)
            await post(text_chat)
            out["e"] = await part(("jpeg",), ("gif",))
            out["f"] = await part(("webp", "mpo"), ("webp", "apng"))
        finally:
            await frontend.stop()
            await watcher.close()
            await engine.close()
            await drt.close()
        return out

    try:
        out = asyncio.run(drive())
    finally:
        enc.encode = tower_encode
    launches = 0
    for label, res, stills_, videos_ in (("e", out["e"], ("jpeg",), ("gif",)),
                                         ("f", out["f"], ("webp", "mpo"), ("webp", "apng"))):
        steps, counts = res["steps"], res["counts"]
        require(counts["fused_decode"] == L * steps and steps > 0 and res["replays"] == steps,
                f"multimodal formats ({label}): fused_decode {counts['fused_decode']} over "
                f"{steps} steps, {res['replays']} replays")
        launches += counts["fused_decode"]
        for k in stills_:
            a, b = res[k + " streams"]
            require(len(a) == SERVE_TOKENS and a == b,
                    f"multimodal formats: the {k} chat's greedy stream differs from its PNG "
                    "twin's")
            require(res[k][0]["choices"][0]["message"]["content"]
                    == res[k + " twin"][0]["choices"][0]["message"]["content"],
                    f"multimodal formats: the {k} chat's text differs from its PNG twin's")
            for tag in (k, k + " twin"):
                _, w, e, d = res[tag]
                print(f"multimodal formats [{card}]: {tag} chat {1e3 * w:.1f} ms client wall "
                      f"({SERVE_TOKENS} tokens): encode {1e3 * e:.1f} ms (host decode, "
                      f"preprocess, tower), the engine's rows decode {1e3 * d:.1f} ms")
            print(f"multimodal formats [{card}]: the {k} chat's tower rows and its "
                  f"{SERVE_TOKENS} greedy tokens equal its PNG twin's")
        for k in videos_:
            video, wall, v_enc, v_rows = res[k + " video"]
            extra = video["usage"]["prompt_tokens"] - res["text prompt"]["usage"]["prompt_tokens"]
            require(extra == MM_VIDEO_FRAMES * MM_TOKENS,
                    f"multimodal formats: the {k} video chat adds {extra} prompt tokens")
            print(f"multimodal video [{card}]: {k} of {MM_VIDEO_FRAMES} sampled frames, "
                  f"{video['usage']['prompt_tokens']} prompt tokens ({extra} placeholder rows) in "
                  f"one prefill dispatch, {SERVE_TOKENS} tokens in {wall:.3f} s client wall: the "
                  f"tower's encode {1e3 * v_enc:.1f} ms ({MM_VIDEO_FRAMES} PNG frames decoded and "
                  f"preprocessed, the tower; the sampling before it not included), the rows "
                  f"decode {1e3 * v_rows:.1f} ms")
        print(f"multimodal formats [{card}]: phase 21 ({label}) chats {res['wall']:.1f} s, "
              f"{steps} decode steps, fused_decode {counts['fused_decode']} ({L} per step)")
    torch.cuda.empty_cache()
    print(f"phase 21 (f): host decodes {tf_host:.1f} s, chats {out['f']['wall']:.1f} s")
    print(f"phase 21 (e) and (f): {time.perf_counter() - t0:.1f} s")
    return launches


def multimodal_phase(spec, cfg, params, card) -> int:
    """Phase 21 at full width on phase 4's llama-3-8b weights: (a) the
    PNGs decoded on the host, (b) the ViT-L/14-336 tower on the card, (c)
    the EPD serve through the HTTP frontend (in-memory hub, the port's
    encode worker on the tower, an engine worker with 576 placeholders per
    image), (d) a --model-type embeddings worker on /v1/embeddings, (e)
    JPEG, GIF and a GIF video (mm_formats_phase). Returns the fused_decode
    launches of the image- and video-conditioned streams."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.worker import launch_engine_worker
    from dynamo_tpu_torch.frontend.http import HttpFrontend
    from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
    from dynamo_tpu_torch.multimodal.worker import launch_encode_worker
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.flight import FLIGHT
    from dynamo_tpu_torch.runtime.hub import InMemoryHub

    t21 = time.perf_counter()
    torch.cuda.empty_cache()
    name, L = spec.name, spec.num_layers
    pngs = {kind: mm_png(kind, w, h, f) for kind, w, h, f in MM_PNGS}
    enc = mm_tower(spec, pngs, card)
    urls = {k: "data:image/png;base64," + base64.b64encode(v).decode() for k, v in pngs.items()}
    encode_s: list[float] = []
    decode_s: list[float] = []  # the engine's decode of the rows' payload
    tower_encode = enc.encode

    def timed_encode(images):
        t0 = time.perf_counter()
        try:
            return tower_encode(images)
        finally:
            encode_s.append(time.perf_counter() - t0)

    enc.encode = timed_encode

    def chat_body(*kinds, stream=False):
        parts = [{"type": "text", "text": MM_TEXT}] + [
            {"type": "image_url", "image_url": {"url": urls[k]}} for k in kinds]
        return {"model": name, "max_tokens": SERVE_TOKENS, "ignore_eos": True,
                "temperature": 0.0, "stream": stream,
                "messages": [{"role": "user", "content": parts}]}

    async def drive():
        drt = DistributedRuntime(InMemoryHub())
        await launch_encode_worker(drt, hidden_size=spec.hidden_size, encoder=enc)
        # one dispatch per image prompt: the chunk cap and the top bucket
        # hold two images' 1,152 placeholders and the text
        engine, _ = await launch_engine_worker(
            drt, model=name, spec=spec, params=params, device=DEVICE,
            engine_config=EngineConfig(**dict(cfg, max_pages_per_seq=128,
                                              max_prefill_chunk_tokens=2048),
                                       pipeline_decode=True),
            mm_tokens_per_image=MM_TOKENS, image_token_id=MM_IMAGE_TOKEN)
        engine_decode = engine._decode_multimodal

        def timed_decode(req):
            t0 = time.perf_counter()
            try:
                return engine_decode(req)
            finally:
                decode_s.append(time.perf_counter() - t0)

        engine._decode_multimodal = timed_decode
        emb, _ = await launch_engine_worker(
            drt, component="embed", model_name=EMB_MODEL, model_type="embeddings",
            spec=spec, params=params, device=DEVICE,
            engine_config=EngineConfig(**dict(cfg, num_pages=128, max_decode_slots=1)))
        watcher = await ModelWatcher(drt, ModelManager()).start()
        frontend = HttpFrontend(watcher.manager, host="127.0.0.1", port=0)
        out: dict = {"engine": engine}
        try:
            for model in (name, EMB_MODEL):
                await watcher.wait_for_model(model, timeout=30)
            _, port = await frontend.start()
            pipe = watcher.manager.get(name)

            async def post(path, body, timeline=True):
                """(status, body, client wall, the engine's timeline of the
                request when ``timeline``, the send time)."""
                t_send = time.time_ns()
                if timeline:
                    FLIGHT.clear()
                status, raw, times = await http_call(port, "POST", path, body)
                tl = None
                for _ in range(100 if timeline and status == 200 else 0):
                    recent = FLIGHT.snapshot(n=1)["recent"]
                    if recent:
                        tl = FLIGHT.snapshot(recent[0]["request_id"])["timeline"]
                        break
                    await asyncio.sleep(0.01)
                return status, json.loads(raw), times[-1], tl, t_send

            async def tokens(body):
                items = [x async for x in pipe.generate(pipe.preprocessor.preprocess(body),
                                                        Context())]
                return [t for x in items for t in x.get("token_ids") or ()]

            # warm-up: a text chat and an image chat (the decode graph's
            # lazy capture and the tower's first launches)
            for body in ({**chat_body(), "messages": [{"role": "user", "content": MM_TEXT}]},
                         chat_body("gradient")):
                status, resp, *_ = await post("/v1/chat/completions", body)
                require(status == 200, f"multimodal warm-up: {status} {resp}")
            zero_counts()
            s0, r0 = engine.steps, engine._graphs.replays
            single = {}
            for label, kinds in (("red", ("red",)), ("red again", ("red",)),
                                 ("noise", ("noise",)), ("two images", ("gradient", "blue"))):
                c0, e0, d0 = engine.cached_prompt_tokens, len(encode_s), len(decode_s)
                status, resp, wall, tl, t_send = await post("/v1/chat/completions",
                                                            chat_body(*kinds))
                require(status == 200 and resp["usage"]["completion_tokens"] == SERVE_TOKENS
                        and resp["choices"][0]["finish_reason"] == "length",
                        f"multimodal chat {label}: {status} {resp}")
                single[label] = {"wall": wall, "tl": tl, "t_send": t_send,
                                 "hit": engine.cached_prompt_tokens - c0,
                                 "encode": sum(encode_s[e0:]),
                                 "rows decode": sum(decode_s[d0:]),
                                 "prompt": resp["usage"]["prompt_tokens"]}
            out["single"] = single
            out["streams"] = [await tokens(chat_body("red")), await tokens(chat_body("red")),
                              await tokens(chat_body("noise"))]
            t0 = time.perf_counter()
            conc = await asyncio.gather(*(post("/v1/chat/completions", chat_body(k), False)
                                          for k in ("noise", "gradient", "blue", "red")))
            out["concurrent"] = (time.perf_counter() - t0, conc)
            out["steps"], out["replays"] = engine.steps - s0, engine._graphs.replays - r0
            out["counts"] = read_counts()
            # the same token count as text (the placeholders left as ids)
            pre = pipe.preprocessor.preprocess(chat_body("red"))
            out["pre"] = pre
            status, resp, wall, tl, t_send = await post("/v1/completions", {
                "model": name, "prompt": pre["token_ids"], "max_tokens": SERVE_TOKENS,
                "ignore_eos": True, "temperature": 0.0})
            require(status == 200, f"multimodal text baseline: {status} {resp}")
            out["text"] = {"wall": wall, "tl": tl, "t_send": t_send}
            # (d) embeddings: one input, then a batch of eight, then the
            # eight one by one
            texts = [f"{MM_TEXT} Input {i}: " + "lorem ipsum " * (4 + 3 * i)
                     for i in range(EMB_INPUTS)]
            emb_out = {}
            for label, inp in (("one", texts[0]), ("batch", texts)):
                t0 = time.perf_counter()
                status, resp, *_ = await post("/v1/embeddings", {"model": EMB_MODEL,
                                                                 "input": inp}, False)
                emb_out[label] = (time.perf_counter() - t0, status, resp)
            ones = []
            for t in texts:
                status, resp, *_ = await post("/v1/embeddings", {"model": EMB_MODEL,
                                                                 "input": t}, False)
                require(status == 200, f"embeddings: {status} {resp}")
                ones.append(resp["data"][0]["embedding"])
            out["emb"], out["emb_ones"] = emb_out, ones
            out["emb_steps"] = emb.steps
        finally:
            await frontend.stop()
            await watcher.close()
            await emb.close()
            await engine.close()
            await drt.close()
        return out

    out = asyncio.run(drive())
    engine = out.pop("engine")
    steps, counts = out["steps"], out["counts"]
    # gates
    require(counts["fused_decode"] == L * steps and steps > 0 and out["replays"] == steps,
            f"multimodal: fused_decode {counts['fused_decode']} over {steps} steps, "
            f"{out['replays']} replays")
    s = out["single"]
    require(s["red again"]["hit"] > 0 and s["noise"]["hit"] == 0 and s["red"]["hit"] == 0,
            f"multimodal: cached prompt tokens {[(k, v['hit']) for k, v in s.items()]}")
    a, a2, b = out["streams"]
    require(len(a) == SERVE_TOKENS and a == a2, "multimodal: the same image gave another stream")
    require(s["two images"]["prompt"] - s["red"]["prompt"] == MM_TOKENS,
            f"multimodal: prompt tokens {s['two images']['prompt']} vs {s['red']['prompt']}")
    pre = out["pre"]
    pos = pre["multimodal"]["positions"]
    require(len(pos) == MM_TOKENS and all(pre["token_ids"][p] == MM_IMAGE_TOKEN for p in pos),
            "multimodal: placeholder positions")
    rows = enc.forward_pixels(enc.pixels([pngs["red"]])).float().cpu().numpy()
    diff = mm_logits_check(spec, params, pre["token_ids"], pos, rows, a[0])
    mm_cut_check(spec, params, pre["token_ids"], pos, rows, card)
    print(f"multimodal logits [{card}]: first-token logits with the red image's rows vs the "
          f"placeholders as text differ by up to {diff:.3f}; the served first token is "
          f"near-argmax; a different image {'changed' if b != a else 'kept'} the greedy stream")

    def split(x):
        tl = x["tl"]
        ev = {e["name"]: e["t"] for e in tl["events"]}
        arrive = (tl["started_unix_ns"] - x["t_send"]) / 1e9
        return 1e3 * (arrive + ev["first_token"]), 1e3 * arrive, 1e3 * ev["admit"], \
            1e3 * (ev["first_token"] - ev["admit"])

    for label, x in list(s.items()) + [("text, same ids", out["text"])]:
        ttft, arrive, queue, prefill = split(x)
        enc_ms, dec_ms = 1e3 * x.get("encode", 0.0), 1e3 * x.get("rows decode", 0.0)
        print(f"multimodal TTFT [{card}]: {label} ({x.get('prompt', len(pre['token_ids']))} "
              f"prompt tokens): {ttft:.1f} ms = frontend + encode hop + the engine's rows "
              f"decode {arrive:.1f} ms (encode {enc_ms:.1f} ms, {100 * enc_ms / ttft:.1f}% of "
              f"TTFT; rows decode {dec_ms:.1f} ms) + queue {queue:.1f} ms + prefill and first "
              f"token {prefill:.1f} ms; cached prompt tokens {x.get('hit', 0)}")
    wall, conc = out["concurrent"]
    n_tok = sum(r[1]["usage"]["completion_tokens"] for r in conc)
    require(all(r[0] == 200 for r in conc) and n_tok == 4 * SERVE_TOKENS,
            f"multimodal: concurrent chats {[r[0] for r in conc]}, {n_tok} tokens")
    print(f"multimodal serve [{card}]: 4 concurrent one-image chats, {n_tok} tokens in "
          f"{wall:.3f} s ({n_tok / wall:.1f} tok/s); {steps} decode steps, fused_decode "
          f"{counts['fused_decode']} ({L} per step)")
    emb_wall = {}
    for label, (w, status, resp) in out["emb"].items():
        vecs = np.array([d["embedding"] for d in resp["data"]], np.float64)
        n = 1 if label == "one" else EMB_INPUTS
        require(status == 200 and vecs.shape == (n, spec.hidden_size),
                f"embeddings {label}: {status} {vecs.shape}")
        norms = np.linalg.norm(vecs, axis=1)
        require(np.abs(norms - 1.0).max() <= EMB_NORM_TOL, f"embeddings {label}: norms {norms}")
        emb_wall[label] = (w, n, vecs)
    batch = emb_wall["batch"][2]
    eq = np.abs(batch - np.array(out["emb_ones"], np.float64)).max()
    require(eq <= EMB_EQ_TOL and out["emb_steps"] == 0,
            f"embeddings: batch vs one by one max abs diff {eq:.3e}")
    print(f"embeddings [{card}]: /v1/embeddings 1 input {1e3 * emb_wall['one'][0]:.1f} ms, "
          f"8 inputs {1e3 * emb_wall['batch'][0]:.1f} ms "
          f"({1e3 * emb_wall['batch'][0] / EMB_INPUTS:.1f} ms per input, client wall); unit "
          f"norm within {EMB_NORM_TOL}; batch vs one by one max abs diff {eq:.3e}")
    del engine
    torch.cuda.empty_cache()
    enc.encode = tower_encode
    launches = counts["fused_decode"] + mm_formats_phase(spec, cfg, params, enc, card)
    del enc
    torch.cuda.empty_cache()
    print(f"phase 21: {time.perf_counter() - t21:.1f} s, fused_decode {launches}")
    return launches


# ---------------------------------------------------- tensor parallelism

TP70_LAYERS = 4  # llama-3-70b at full width, cut to this many layers (phase 22 b)
# llama-3-8b at full width, cut to this many layers in phase 22 (a) and (e)
# and phase 25: the gates (per-layer launches and collectives, logits and
# pages against one rank) hold at any depth
TP8_LAYERS = 4
TP_POOL_PAGES = 64  # sealed pages per rank held against the one-rank pools
# a rank's pages against the matching KV-head slice of the one-rank pools:
# max |diff| / max |value| over those pages, per pool (bf16 rows whose
# inputs passed through all-reduced f32 sums in another order, rounded
# once more per layer)
TP_POOL_TOL = 5e-2
# prefill logits, max |diff| / max |logit|: llama-3-8b at tp=2 read
# 2.046e-2 on an H100 80GB HBM3 at 700 W (fused vs unfused reads 1.45e-2
# for one rounding moved per layer; tp moves two), so 5e-2 leaves room.
# Both gates hold a planted fault against their tolerance every run
# (tp_fault_logits, tp_check): it must read above it. On that card layer
# 0's w_down all-reduce skipped read 1.068 (tp=2) / 1.224 (tp=4), a rank's
# pages against its neighbour's heads >= 1.309, the sound pages <= 2.089e-2
TP_LOGIT_TOL = 5e-2
TP_TIMEOUT_S = 600  # a rank's limit on any collective wait


def tp8_spec():
    """llama-3-8b at full width, TP8_LAYERS deep."""
    import dataclasses

    from dynamo_tpu_torch.engine.config import ModelSpec

    return dataclasses.replace(ModelSpec.llama3_8b(), num_layers=TP8_LAYERS,
                               name=f"llama-3-8b[{TP8_LAYERS} layers]")


def tp70_spec():
    import dataclasses

    from dynamo_tpu_torch.engine.config import ModelSpec

    return dataclasses.replace(ModelSpec.llama3_70b(), num_layers=TP70_LAYERS,
                               name=f"llama-3-70b[{TP70_LAYERS} layers]")


def tp_prefill_logits(spec, params, prompt, device):
    """One prefill of ``prompt`` on scratch pools of this rank's heads: its
    last position's logits (every rank of a group gets the same)."""
    from dynamo_tpu_torch.models import llama

    mesh = getattr(params, "mesh", None)
    bucket = -(-len(prompt) // 16) * 16
    n_pages = bucket // 16
    k, v = llama.init_cache(spec, n_pages + 1, 16, device=device,
                            tp=mesh.tp if mesh is not None else 1)
    tok = torch.zeros(bucket, dtype=torch.int32, device=device)
    tok[: len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
    bt = torch.arange(1, n_pages + 1, dtype=torch.int32, device=device)
    with torch.no_grad():
        logits, _ = llama.prefill_forward(spec, params, tok, bt, 0, k, v, len(prompt))
    out = logits.float().cpu()
    del k, v
    return out


def tp_fault_logits(spec, params, prompt, device):
    """``tp_prefill_logits`` with a planted fault, the same on every rank
    (so the collectives still line up): layer 0's ``w_down`` partial goes
    on unreduced. The logits gate must reject it."""
    from dynamo_tpu_torch.models import llama

    real, calls = llama._mlp, []

    def unreduced(lp, x, mesh=None):
        calls.append(mesh)
        return real(lp, x, None if len(calls) == 1 else mesh)

    llama._mlp = unreduced
    try:
        return tp_prefill_logits(spec, params, prompt, device)
    finally:
        llama._mlp = real


def tp_pages(engine, ids):
    """Pages ``ids`` of the engine's pools, on the host as numpy (bf16 as
    uint16 bits: a queue between processes carries them by value): (ids,
    k, v)."""
    from dynamo_tpu_torch.kvbm.offload import block_numpy

    kb, vb = engine.fam.extract_pages(engine.k_pages, engine.v_pages,
                                      torch.tensor(ids, dtype=torch.int64, device=engine.device))
    return ids, block_numpy(kb.cpu()), block_numpy(vb.cpu())


async def tp_rank_serve(rank, n, job):
    """One rank of a phase-22 group: the port's entry points (the group's
    bootstrap, the mesh, this rank's shard of the seeded init, the engine
    and the SPMD plane); rank 0 serves the prompts, the others replay."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.parallel.mesh import make_mesh
    from dynamo_tpu_torch.parallel.spmd import SpmdFollower, SpmdLeader, StoreHub

    mesh = make_mesh(tp=n)
    dev = mesh.device
    spec = ModelSpec(**job["spec"])
    t0 = time.perf_counter()
    params = llama.init_params(spec, 0, device=dev, mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out = {"rank": rank, "device": str(dev), "init_s": time.perf_counter() - t0,
           "params_bytes": _allocated(dev)}
    prompt = job["prompts"][job["logit_prompt"]]
    logits = tp_prefill_logits(spec, params, prompt, dev)
    fault = tp_fault_logits(spec, params, prompt, dev)
    if rank == 0:
        out["logits"] = logits.numpy()
        out["fault_logits"] = fault.numpy()
    cfg = EngineConfig(**job["cfg"], tp=n, cuda_graphs=job["graphs"])
    group = f"phase22/{job['label']}"
    if rank == 0:
        leader = await SpmdLeader(StoreHub(), asyncio.get_running_loop(), group,
                                  strict=True).start()
        engine = InferenceEngine(spec, cfg, params=params, device=dev, mesh=mesh,
                                 spmd=leader)
        if job["graphs"]:
            engine.precompile()
        out["mem_bytes"] = _allocated(dev)
        out["pool_bytes"] = engine.pool_bytes
        zero_counts()
        stats0 = dict(mesh.stats)
        p0 = (leader.publish_count, leader.publish_bytes, leader.publish_secs)
        await engine.start()
        results, ttft, wall, hit = await serve(engine, job["prompts"])
        out["counts"] = read_counts()
        out["coll"] = {k: mesh.stats[k] - stats0[k] for k in stats0}
        out["publish"] = [a - b for a, b in zip(
            (leader.publish_count, leader.publish_bytes, leader.publish_secs), p0)]
        out.update(tokens={i: [t for x in items for t in x["token_ids"]]
                           for i, items in results.items()},
                   ttft=ttft, wall=wall, hit=hit, steps=engine.steps,
                   replays=engine._graphs.replays,
                   step_times=list(engine.decode_step_times))
        await engine.kv_digest()  # the followers record the same pages
        ids = engine.allocator.used_page_ids()[:TP_POOL_PAGES]
        out["hashes"] = [engine.allocator._page_hash.get(p) for p in ids]
        out["pages"] = tp_pages(engine, ids)
        await engine.close()
    else:
        engine = InferenceEngine(spec, cfg, params=params, device=dev, mesh=mesh)
        out["mem_bytes"] = _allocated(dev)
        zero_counts()
        stats0 = dict(mesh.stats)
        f = SpmdFollower(StoreHub(), group, engine, rejoin=False)
        await f.run()
        out["counts"] = read_counts()
        out["coll"] = {k: mesh.stats[k] - stats0[k] for k in stats0}
        out["ops"] = dict(f.ops)
        out["pages"] = tp_pages(engine, f.digest_pages[:TP_POOL_PAGES])
        engine.release_graphs()
    return out


def _allocated(dev) -> int:
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def tp_rank(rank, n, port, job, q):
    """A spawned rank: join the group (the job's backend and device), run
    ``tp_rank_serve`` (``ep_rank_serve`` for a job with an ``ep``), put its
    result (or the traceback) on ``q``."""
    import traceback

    try:
        sys.path.insert(0, str(ROOT))
        from dynamo_tpu_torch.ops.cuda import build
        from dynamo_tpu_torch.parallel.multihost import initialize_multihost, shutdown

        if torch.cuda.is_available():
            build.load_library()  # built by the parent
        initialize_multihost(f"127.0.0.1:{port}", n, rank, device=job["device"],
                             backend=job["backend"], timeout_s=TP_TIMEOUT_S)
        run = ep_rank_serve if "ep" in job else tp_rank_serve
        try:
            q.put((rank, asyncio.run(run(rank, n, job))))
        finally:
            shutdown()
    except BaseException:  # noqa: BLE001 - reported to the parent
        q.put((rank, {"error": traceback.format_exc()}))
    finally:
        q.close()
        q.join_thread()


def run_ranks(n: int, target, job, timeout: float = 900.0) -> list[dict]:
    """``target(rank, n, port, job, q)`` on ``n`` spawned processes (fresh
    interpreters, never forks of this CUDA process); results in rank
    order. Every process is joined or killed before this returns."""
    import socket

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=target, args=(r, n, port, job, q)) for r in range(n)]
    for p in procs:
        p.start()
    got: dict[int, dict] = {}
    try:
        deadline = time.perf_counter() + timeout
        while len(got) < n:
            import queue as _queue

            try:
                r, res = q.get(timeout=5.0)
            except _queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                require(not dead and time.perf_counter() < deadline,
                        f"ranks: exit codes {[p.exitcode for p in procs]}, "
                        f"{len(got)}/{n} results")
                continue
            require("error" not in res, f"rank {r} failed:\n{res.get('error')}")
            got[r] = res
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
                p.join(30)
    return [got[r] for r in range(n)]


def tp_reference(spec, cfg, prompts, label):
    """The one-rank engine on the same seeded weights: its streams, its
    prefill logits, its sealed pages by block hash, and the weights for the
    near-tie check. The engine's pools stay until ``drop_engine``."""
    from dynamo_tpu_torch.models import llama

    params = llama.init_params(spec, 0, device=DEVICE)
    engine = new_engine(spec, dict(cfg), f"{label} tp=1", params=params)
    out = serve_phases(engine, [("default", lambda e: serve(e, prompts))])
    results = out["default"]["res"][0]
    tokens = {i: [t for x in items for t in x["token_ids"]] for i, items in results.items()}
    logits = tp_prefill_logits(spec, params, prompts[0], DEVICE)
    return engine, params, tokens, logits


def tp_check(spec, prompts, ref, ranks, label, card) -> int:
    """Hold a group's serve against the one-rank reference: prefill logits
    within TP_LOGIT_TOL, streams equal up to the first near-tie, each
    rank's pages within TP_POOL_TOL of the one-rank pools' matching KV-head
    slice, fused_decode once per layer per decode step on every rank (no
    other kernel). Prints per-rank memory, step times and the collectives'
    share. Returns every rank's fused_decode launches."""
    from dynamo_tpu_torch.kvbm.offload import block_tensor

    engine, params, tokens, logits = ref
    lead = ranks[0]
    n, L = len(ranks), spec.num_layers
    scale = logits.abs().max().item()
    lerr = (torch.from_numpy(lead["logits"]) - logits).abs().max().item() / scale
    ferr = (torch.from_numpy(lead["fault_logits"]) - logits).abs().max().item() / scale
    require(lerr <= TP_LOGIT_TOL, f"{label}: prefill logits differ by {lerr:.3e} of the max")
    require(ferr > TP_LOGIT_TOL, f"{label}: logits with layer 0's w_down all-reduce "
            f"skipped differ by only {ferr:.3e}: the gate cannot see a wrong shard")
    print(f"{label}: prefill logits vs tp=1 max |diff| / max |logit| {lerr:.3e} "
          f"(tol {TP_LOGIT_TOL}); planted fault (layer 0's w_down all-reduce skipped) "
          f"{ferr:.3e}")
    same_all, parts = 0, []
    for i, want in tokens.items():
        got = lead["tokens"][i]
        require(len(got) == SERVE_TOKENS, f"{label}: request {i} {len(got)} tokens")
        if got != want:
            same, tie = equal_to_first_near_tie(spec, params, prompts[i], got, want)
            require(same >= tie, f"{label}: request {i} parts from tp=1 at {same} before "
                    f"its first near-tie at {tie}")
            parts.append((i, same, tie))
        else:
            same_all += 1
    n_tok = sum(len(t) for t in tokens.values())
    eq = sum(a == b for i in tokens for a, b in zip(tokens[i], lead["tokens"][i]))
    print(f"{label}: {same_all} of {len(tokens)} greedy streams equal to tp=1's "
          f"({eq} of {n_tok} tokens); the others part at or after a near-tie "
          f"(request, first difference, first near-tie): {parts}")
    # pages: by the leader's block hash, the one-rank page holding that block
    ids, _k, _v = lead["pages"]
    pairs = [(j, engine.allocator._hash_page[h]) for j, h in enumerate(lead["hashes"])
             if h is not None and h in engine.allocator._hash_page]
    require(len(pairs) >= 16, f"{label}: {len(pairs)} sealed blocks in common with tp=1")
    rows = [j for j, _p in pairs]
    ref_pages = torch.tensor([p for _j, p in pairs], device=engine.device)
    rk, rv = engine.fam.extract_pages(engine.k_pages, engine.v_pages, ref_pages)
    worst, swapped = 0.0, float("inf")
    for r, res in enumerate(ranks):
        rids, kb, vb = res["pages"]
        kb, vb = block_tensor(kb), block_tensor(vb)
        require(list(rids) == list(ids), f"{label}: rank {r} holds other pages")
        kh = kb.shape[2]
        for got, want in ((kb[:, rows], rk), (vb[:, rows], rv)):
            got = got.float()
            for q in (r, (r + 1) % n):
                cut = want[:, :, q * kh:(q + 1) * kh].float().cpu()
                err = (got - cut).abs().max().item() / cut.abs().max().item()
                if q == r:
                    worst = max(worst, err)
                else:  # the planted fault: this rank holding its neighbour's heads
                    swapped = min(swapped, err)
    require(worst <= TP_POOL_TOL, f"{label}: rank pages differ by {worst:.3e} of the max")
    require(swapped > TP_POOL_TOL, f"{label}: pages against a neighbour's KV heads differ "
            f"by only {swapped:.3e}: the gate cannot see a wrong shard")
    print(f"{label}: {len(pairs)} sealed pages on every rank vs the matching KV-head slice "
          f"of tp=1's pools: max |diff| / max |value| {worst:.3e} (tol {TP_POOL_TOL}); "
          f"planted fault (each rank against its neighbour's heads) at least {swapped:.3e}")
    steps = lead["steps"]
    total = 0
    for r, res in enumerate(ranks):
        c = res["counts"]
        require(c["fused_decode"] == L * steps and c["kv_write"] == 0
                and c["paged_attention_v3"] == 0,
                f"{label}: rank {r} launches {c} over {steps} decode steps")
        total += c["fused_decode"]
        co = res["coll"]
        print(f"{label}: rank {r} on {res['device']}: fused_decode {c['fused_decode']} "
              f"launches ({L} x {steps} steps); weights {res['params_bytes'] / 1e9:.3f} GB, "
              f"allocated after the pools {res['mem_bytes'] / 1e9:.3f} GB, init "
              f"{res['init_s']:.1f} s; {co['calls']} collectives, "
              f"{co['bytes'] / 1e6:.1f} MB sent, {co['secs']:.2f} s in them"
              + (f"; replayed {res['ops']}" if "ops" in res else ""))
    times = lead["step_times"]
    disp = 1e3 * sum(times) / max(len(times), 1)
    share = lead["coll"]["secs"] / lead["wall"]
    cnt, nbytes, secs = lead["publish"]
    print(f"{label} [{card}]: NOT tp timings ({n} processes time-slice one card): serve "
          f"{n_tok} tokens in {lead['wall']:.2f} s, decode dispatch-to-host mean "
          f"{disp:.2f} ms over {len(times)} dispatches of {steps} steps, TTFT mean "
          f"{1e3 * sum(lead['ttft'].values()) / len(lead['ttft']):.1f} ms; the leader's "
          f"collectives {lead['coll']['calls']} calls, {share:.3f} of the serve's wall "
          f"(staged through host memory); {cnt} descriptors, {nbytes / max(cnt, 1):.0f} "
          f"bytes and {1e6 * secs / max(cnt, 1):.1f} us of host time each; pools "
          f"{lead['pool_bytes'] / 1e9:.3f} GB per rank")
    return total


def tp_group_serve(spec, cfg, prompts, n, label, card, backend="gloo", device=DEVICE,
                   graphs=False) -> tuple[int, dict]:
    """Phase 22 (a), (b), (e): the one-rank reference in this process, then
    ``n`` ranks of the same seeded weights serving the same prompts.
    Returns the ranks' fused_decode launches and the leader's streams."""
    import dataclasses
    import gc

    t0 = time.perf_counter()
    ref = tp_reference(spec, cfg, prompts, label)
    job = {"spec": dataclasses.asdict(spec), "cfg": dict(cfg), "prompts": prompts,
           "logit_prompt": 0, "graphs": graphs, "backend": backend, "device": device,
           "label": label}
    try:
        ranks = run_ranks(n, tp_rank, job)
        launches = tp_check(spec, prompts, ref, ranks, label, card)
    finally:
        drop_engine(ref[0])
        del ref
        gc.collect()
        torch.cuda.empty_cache()
    print(f"{label}: {time.perf_counter() - t0:.1f} s")
    return launches, ranks[0]["tokens"]


def tp_one_rank_nccl(rank, n, port, job, q):
    """Phase 22 (c): a group of one on NCCL, graphs on: the collectives are
    captured in the decode and verify graphs, a replay equals an eager
    step bitwise, and a serve equals phase 4's streams."""
    import traceback

    try:
        sys.path.insert(0, str(ROOT))
        import torch.distributed as dist

        from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
        from dynamo_tpu_torch.engine.core import InferenceEngine
        from dynamo_tpu_torch.models import llama
        from dynamo_tpu_torch.ops.cuda import build
        from dynamo_tpu_torch.parallel.mesh import make_mesh

        if torch.cuda.is_available():
            build.load_library()  # built by the parent
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh(tp=1, devices=[DEVICE])
            require(mesh.group is not None and mesh.backend == "nccl",
                    f"tp=1 group: {mesh.backend}")
            spec = ModelSpec(**job["spec"])
            params = llama.init_params(spec, 0, device=DEVICE, mesh=mesh)
            engine = InferenceEngine(spec, EngineConfig(**job["cfg"]), params=params,
                                     device=DEVICE, mesh=mesh)
            c0 = mesh.stats["captured"]
            precompile(engine, "tp=1 nccl")
            captured = mesh.stats["captured"] - c0
            require(captured > 0, "no collective captured in the decode graphs")
            step_graph_check(engine, job["prompts"])
            c1 = mesh.stats["captured"]
            verify_graph_check(engine, job["prompts"])
            out = serve_phases(engine, [("default", lambda e: serve(e, job["prompts"]))])
            res = out["default"]
            tokens = {i: [t for x in items for t in x["token_ids"]]
                      for i, items in res["res"][0].items()}
            # against phase 4's streams up to the first near-tie (another
            # admission grouping runs other GEMM shapes in the prefill)
            parts = {i: equal_to_first_near_tie(spec, params, job["prompts"][i], got,
                                                job["tokens"][i])
                     for i, got in tokens.items() if got != job["tokens"][i]}
            q.put((rank, {"captured": captured, "verify_captured": mesh.stats["captured"] - c1,
                          "tokens": tokens, "parts": parts, "counts": res["counts"],
                          "steps": res["steps"], "replays": res["replays"]}))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001
        q.put((rank, {"error": traceback.format_exc()}))
    finally:
        q.close()
        q.join_thread()


def tp_nccl_one(spec, cfg, prompts, bf16_tokens, card) -> int:
    import dataclasses

    t0 = time.perf_counter()
    job = {"spec": dataclasses.asdict(spec), "cfg": dict(cfg), "prompts": prompts,
           "tokens": bf16_tokens}
    (res,) = run_ranks(1, tp_one_rank_nccl, job)
    L = spec.num_layers
    bad = {i: p for i, p in res["parts"].items() if p[0] < p[1]}
    require(not bad, f"tp=1 over NCCL: streams part from phase 4's before a near-tie "
            f"(request: first difference, first near-tie): {bad}")
    require(res["counts"]["fused_decode"] == L * res["steps"]
            and res["replays"] == res["steps"],
            f"tp=1 over NCCL: {res['counts']} over {res['steps']} steps, "
            f"{res['replays']} replays")
    print(f"phase 22 (c) [{card}]: tp=1 through the distributed path on NCCL: "
          f"{res['captured']} collectives captured in the decode graphs, "
          f"{res['verify_captured']} in the verify graphs; replays bitwise equal to eager "
          f"steps (graph lines above); {len(bf16_tokens) - len(res['parts'])} of "
          f"{len(bf16_tokens)} streams equal phase 4's, the others part at or after a "
          f"near-tie {res['parts']}; "
          f"{res['steps']} steps, {res['replays']} replays, fused_decode "
          f"{res['counts']['fused_decode']}; {time.perf_counter() - t0:.1f} s")
    return res["counts"]["fused_decode"]


async def _mirror_serve(hub, prompts) -> tuple[dict, float]:
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub_client import RemoteHub
    from dynamo_tpu_torch.runtime.push import PushRouter, RouterMode

    drt = DistributedRuntime(await RemoteHub.connect(hub), RuntimeConfig(hub_address=hub))
    try:
        router = await PushRouter.from_endpoint(
            drt.namespace("dynamo").component("backend").endpoint("generate"),
            RouterMode.ROUND_ROBIN)
        await router.client.wait_for_instances(1, timeout=30)

        async def one(p):
            toks = []
            async for item in router.generate(make_request(p), Context()):
                toks += item["token_ids"]
            return toks

        t0 = time.perf_counter()
        got = await asyncio.gather(*(one(p) for p in prompts))
        wall = time.perf_counter() - t0
        await router.client.close()
        digest = await admin_call(drt, {"op": "kv_digest"})
        status = await admin_call(drt, {"op": "cache_status"})
        return {"tokens": dict(enumerate(got)), "digest": digest,
                "spmd": status["spmd"]}, wall
    finally:
        await drt.close()


MIRROR_LAYERS = 8  # phase 22 (d): llama-3-8b at full width, cut to this many layers


def mirror_phase(spec, cfg, prompts, card) -> int:
    """Phase 22 (d): ``cli hub``, a ``--mirror leader`` worker and a
    ``--mirror follower`` worker (each ``spec`` cut to MIRROR_LAYERS
    layers, on this card) serve phase 4's prompts over TCP; the follower's
    pages equal the leader's bitwise (their kv_digest); the follower is
    SIGKILLed and a new one rejoins through __sync__; after the next serve
    its pages equal the leader's again. Prints the descriptors' bytes and
    host time."""
    import dataclasses

    t0 = time.perf_counter()
    spec = dataclasses.replace(spec, num_layers=MIRROR_LAYERS,
                               name=f"{spec.name}[{MIRROR_LAYERS} layers]")
    flags = ["--spec-json", json.dumps(dataclasses.asdict(spec)),
             "--page-size", str(cfg["page_size"]), "--num-pages",
             str(cfg["num_pages"]), "--max-pages-per-seq", str(cfg["max_pages_per_seq"]),
             "--max-decode-slots", str(cfg["max_decode_slots"])]
    children: list[Child] = []
    try:
        hub_proc = Child("hub", "--port", "0")
        children.append(hub_proc)
        hub = hub_proc.wait_line("DYNAMO_HUB=", 60).split("=", 1)[1]
        leader = Child("worker", "--hub", hub, "--mirror", "leader", "--precompile", *flags)
        follower = Child("worker", "--hub", hub, "--mirror", "follower", *flags)
        children += [leader, follower]
        follower.wait_line("MIRROR_FOLLOWER_READY", PROC_START_S)
        leader.wait_line("ENGINE_READY", PROC_START_S)
        first, wall1 = asyncio.run(_mirror_serve(hub, prompts))
        require(all(len(t) == SERVE_TOKENS for t in first["tokens"].values()),
                f"mirror: the first serve's streams: {first['tokens']}")
        fd = json.loads(follower.wait_line("SPMD_KV_DIGEST ", 120).split(" ", 1)[1])
        ld = first["digest"]
        require(ld["pages"] > 0 and (fd["k"], fd["v"], fd["pages"]) ==
                (ld["k"], ld["v"], ld["pages"]),
                f"mirror: follower digest {fd} != leader's {ld}")
        follower.proc.kill()  # lost: the mirror leader serves on
        follower.proc.wait(30)
        rejoined = Child("worker", "--hub", hub, "--mirror", "follower", *flags,
                         env={"DYNAMO_SPMD_SYNC_JOIN": "1"})
        children.append(rejoined)
        rejoined.wait_line("MIRROR_FOLLOWER_READY", PROC_START_S)
        second, wall2 = asyncio.run(_mirror_serve(hub, prompts))
        rd = json.loads(rejoined.wait_line("SPMD_KV_DIGEST ", 120).split(" ", 1)[1])
        ld2 = second["digest"]
        require((rd["k"], rd["v"], rd["pages"]) == (ld2["k"], ld2["v"], ld2["pages"]),
                f"mirror: rejoined follower digest {rd} != leader's {ld2}")
        synced = next((ln for ln in rejoined.seen if "rejoin complete" in ln), "")
        require(bool(synced), f"mirror: no rejoin sync logged: {rejoined.seen[-10:]}")
        require(all(len(t) == SERVE_TOKENS for t in second["tokens"].values()),
                f"mirror: the second serve's streams: {second['tokens']}")
        st = second["spmd"]
        require(st["healthy"] and st["followers"] == 1, f"mirror leader plane: {st}")
        for child in (leader, rejoined, hub_proc):
            require(child.stop() == 0, f"{child.name} exited non-zero: {child.seen[-8:]}")
        logs = json.loads(leader.logged("ENGINE_LAUNCHES ").split(" ", 1)[1])
    finally:
        for child in children:
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait(30)
    n_tok = sum(len(t) for t in first["tokens"].values())
    print(f"phase 22 (d) [{card}]: mirror leader + follower (each {spec.name}, full width) "
          f"served {n_tok} tokens in {wall1:.2f} s; "
          f"follower pages bitwise equal to the leader's ({ld['pages']} pages, sha256 "
          f"{ld['k'][:12]}/{ld['v'][:12]}); after a SIGKILL the new follower rejoined "
          f"through __sync__ ({synced.strip()[-80:]!r}) and after the next serve "
          f"({wall2:.2f} s) its {ld2['pages']} pages equal the leader's bitwise")
    print(f"phase 22 (d) [{card}]: {st['publishes']} descriptors, {st['bytes']} bytes "
          f"({st['bytes'] / st['publishes']:.0f} per descriptor), "
          f"{1e6 * st['secs'] / st['publishes']:.1f} us of the leader's host time per "
          f"publish; {time.perf_counter() - t0:.1f} s")
    return logs["launches"].get("fused_decode_attention", 0)


def tp_worker_phase(spec, cfg, prompts, card) -> int:
    """Phase 22 (f): ``cli worker --tp 2`` as a user starts it, both ranks
    on this card (``--device cuda:0``, ``DYN_TP_BACKEND=gloo``,
    ``--no-cuda-graphs``): the worker starts its rank 1 itself, which
    prints MULTIHOST_FOLLOWER_READY; phase 4's prompts over TCP; the admin
    kv_digest (rank 1 prints its own, over the same pages); SIGTERM drains
    the worker and its rank 1 stops with it. Returns rank 0's fused_decode
    launches (its ENGINE_LAUNCHES)."""
    import dataclasses

    t0 = time.perf_counter()
    flags = ["--spec-json", json.dumps(dataclasses.asdict(spec)), "--page-size",
             str(cfg["page_size"]), "--num-pages",
             str(cfg["num_pages"]), "--max-pages-per-seq", str(cfg["max_pages_per_seq"]),
             "--max-decode-slots", str(cfg["max_decode_slots"])]
    children: list[Child] = []
    try:
        hub_proc = Child("hub", "--port", "0")
        children.append(hub_proc)
        hub = hub_proc.wait_line("DYNAMO_HUB=", 60).split("=", 1)[1]
        worker = Child("worker", "--hub", hub, "--tp", "2", "--no-cuda-graphs",
                       "--device", "cuda:0", *flags, env={"DYN_TP_BACKEND": "gloo"})
        children.append(worker)
        # the two ranks print in either order
        worker.wait_line("ENGINE_READY", PROC_START_S)
        if not worker.logged("MULTIHOST_FOLLOWER_READY"):
            worker.wait_line("MULTIHOST_FOLLOWER_READY", PROC_START_S)
        res, wall = asyncio.run(_mirror_serve(hub, prompts))
        require(all(len(t) == SERVE_TOKENS for t in res["tokens"].values()),
                f"tp worker: streams {res['tokens']}")
        fd = json.loads(worker.wait_line("SPMD_KV_DIGEST ", 120).split(" ", 1)[1])
        ld = res["digest"]
        require(fd["tp_rank"] == 1 and fd["pages"] == ld["pages"] > 0
                and ld["tp_rank"] == 0, f"tp worker: digests {ld} {fd}")
        st = res["spmd"]
        require(st["healthy"] and st["followers"] == 1, f"tp worker plane: {st}")
        for child in (worker, hub_proc):
            require(child.stop() == 0, f"{child.name} exited non-zero: {child.seen[-8:]}")
        logs = json.loads(worker.logged("ENGINE_LAUNCHES ").split(" ", 1)[1])
    finally:
        for child in children:
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait(30)
    fused, steps = logs["launches"].get("fused_decode_attention", 0), logs["steps"]
    require(DEVICE != "cuda" or fused == spec.num_layers * steps,
            f"tp worker: fused_decode {fused} over {steps} steps")
    n_tok = sum(len(t) for t in res["tokens"].values())
    print(f"phase 22 (f) [{card}]: cli worker --tp 2 ({spec.name}, gloo, both ranks on "
          f"cuda:0, rank 1 started by the worker): {n_tok} tokens over TCP in {wall:.2f} s (NOT a tp "
          f"timing), rank 0 fused_decode {fused} ({spec.num_layers} x {steps} steps); both "
          f"ranks digested the same {ld['pages']} pages; {st['publishes']} descriptors; "
          f"drained on SIGTERM with its rank 1; {time.perf_counter() - t0:.1f} s")
    return fused


def tp_kernel_rows(flush, card) -> dict[str, dict]:
    """fused_decode at a tp rank's shapes, bf16 and fp8 pools: KH 4 / G 4
    (llama-3-8b at tp=2) and KH 2 / G 8 (llama-3-70b at tp=4), held against
    the plain version, timed beside it, SDPA and the bound; kv_write at the
    same KV heads. Returns the bf16 fused_decode rows of the kernels line."""
    from dynamo_tpu_torch.ops.cuda import kv_write

    rows: dict[str, dict] = {}
    layer = 1
    for name, kh, g in (("fused_decode/tp2", 4, 4), ("fused_decode/tp4", 2, 8)):
        for fp8 in (False, True):
            t = kernel_inputs(torch.bfloat16, KH=kh, G=g)
            if fp8:
                fp8_pools(t)
            form = f"KH {kh} G {g} {'fp8' if fp8 else 'bf16'}"
            err_f, _err_v = check_attention(t, f"tp {form}", 0, None, layer)
            times = time_attention_at(t, flush, fp8, KH=kh, G=g)
            q, kn, vn, dp, do = (t[k] for k in ("q", "k_new", "v_new", "dst_page", "dst_off"))
            kp, vp = t["k_pages"], t["v_pages"]
            kw_ms = time_ms(lambda: kv_write.kv_write(kp, vp, kn, vn, dp, do, layer=layer),
                            flush)
            kw_plain = time_ms(lambda: kv_write.kv_write_plain(kp, vp, kn, vn, dp, do,
                                                               layer=layer), flush)
            B, D = q.shape[0], q.shape[2]
            kw_bound, _ = (fp8_append_bound(dp, kh, kp.vals.shape[3], D) if fp8
                           else bound_ms(4 * B * kh * D * 2 + 2 * B * 4, 0.0))
            kw_lib = "none (no single PyTorch call requantizes)"
            if not fp8:  # one index_copy_ per pool, as check_kernels' library row
                NP, page = kp.shape[1], kp.shape[3]
                rows_ = (((layer * NP + dp.long()) * kh)[:, None]
                         + torch.arange(kh, device=DEVICE)[None]) * page + do.long()[:, None]
                rows_ = rows_.reshape(-1)
                kflat, vflat = kp.view(-1, D), vp.view(-1, D)
                kr, vr = kn.reshape(-1, D), vn.reshape(-1, D)

                def library_copy():
                    kflat.index_copy_(0, rows_, kr)
                    vflat.index_copy_(0, rows_, vr)

                kw_lib = f"{time_ms(library_copy, flush):.4f} ms (2x index_copy_)"
            print(f"time tp {form} [{card}]: fused_decode {times['ms']:.4f} ms, plain "
                  f"{times['plain_ms']:.4f} ms, SDPA {times['library_ms']:.4f} ms, bound "
                  f"{times['bound_ms']:.6f} ms ({times['bound_by']}); kv_write "
                  f"{kw_ms:.4f} ms, plain {kw_plain:.4f} ms, library {kw_lib}, bound "
                  f"{kw_bound:.6f} ms")
            if not fp8:
                rows[name] = {"max_abs_err": err_f, **times}
            del t, kp, vp
    return rows


def time_attention_at(t, flush, fp8, **over) -> dict:
    """fused_decode, its plain version and SDPA timed on inputs ``t`` (the
    serving seq_lens at the shape ``over``), with the bound."""
    from dynamo_tpu_torch.ops.cuda import fused_decode

    q, kn, vn, bt, sl, dp, do = (t[k] for k in
                                 ("q", "k_new", "v_new", "bt", "sl", "dst_page", "dst_off"))
    kp, vp = t["k_pages"], t["v_pages"]
    layer = 1
    r = {"ms": time_ms(lambda: fused_decode.fused_decode_attention(
        q, kp, vp, kn, vn, bt, sl, dp, do, layer=layer), flush),
         "plain_ms": time_ms(lambda: fused_decode.fused_decode_plain(
             q, kp, vp, kn, vn, bt, sl, dp, do, layer=layer), flush),
         "library_ms": time_ms(sdpa_call(t, layer), flush)}
    r["bound_ms"], r["bound_by"] = attention_bound(True, 0, fp8=fp8, **over)
    return r


def tp_phase(cfg, prompts, bf16_tokens, card, flush) -> tuple[dict, dict[str, int], dict]:
    """Phase 22: tensor parallelism on the card (see the module docstring).
    Returns the kernel rows at the ranks' shapes, the phase's fused_decode
    launches (every rank of (a), (b), (c), (d) and (e), and (f)'s rank 0)
    and (a)'s streams (phase 25's aggregated tp=2 reference)."""
    from dynamo_tpu_torch.engine.config import ModelSpec

    t22 = time.perf_counter()
    rows = tp_kernel_rows(flush, card)
    spec8 = ModelSpec.llama3_8b()
    spec8a = tp8_spec()
    a, a_tokens = tp_group_serve(spec8a, cfg, prompts, 2,
                                 f"phase 22 (a) llama-3-8b (full width, cut to "
                                 f"{TP8_LAYERS} layers) tp=2 gloo", card)
    b, _ = tp_group_serve(tp70_spec(), cfg, prompts, 4,
                          f"phase 22 (b) llama-3-70b (d 8192, 64/8 heads, FFN 28672, "
                          f"vocab 128256; cut to {TP70_LAYERS} layers) tp=4 gloo", card)
    c = tp_nccl_one(spec8, cfg, prompts, bf16_tokens, card)
    d = mirror_phase(spec8, cfg, prompts, card)
    f = tp_worker_phase(spec8a, cfg, prompts, card)
    e = 0
    if torch.cuda.device_count() >= 2:
        e, _ = tp_group_serve(spec8a, cfg, prompts, 2,
                              f"phase 22 (e) llama-3-8b ({TP8_LAYERS} layers) tp=2 nccl",
                              card, backend="nccl", device=None, graphs=True)
    else:
        print(f"phase 22 (e): {torch.cuda.device_count()} card: tp=2 under NCCL across two "
              "cards was not possible (it needs two)")
    print(f"phase 22: {time.perf_counter() - t22:.1f} s, fused_decode launches (a) {a} "
          f"(b) {b} (c) {c} (d) {d} (e) {e} (f, rank 0) {f}")
    return rows, {"fused_decode": c + d, "fused_decode/tp2": a + e + f,
                  "fused_decode/tp4": b}, a_tokens


# ---------------------------------------------------- expert parallelism

EP_PROMPTS = 4  # phase 4's first prompts, served by every phase-23 group
EP_WIDE_LAYERS = 2  # gpt-oss-120b's depth in (c), ep=4 x tp=1
# (a)-(c) hold the ranks to phase 22's gates (TP_LOGIT_TOL on the prefill
# logits, TP_POOL_TOL on the sealed pages); each planted fault must read
# above TP_LOGIT_TOL in every run


def ep_spec(kind: str, layers: int):
    """gpt-oss-120b or deepseek-r1 at full width, ``layers`` deep."""
    return gpt_oss_spec(layers) if kind == "gpt-oss" else deepseek_spec(layers)


def ep_alone(spec) -> list[int]:
    """Phase 15's (gpt-oss) or phase 16's (MLA) prompt served alone: its
    prefill's logits and dropped slots are the groups' first gate."""
    seed, n = (MLA_SEED, MLA_PROMPT) if spec.is_mla else (MOE_SEED, MOE_PROMPT)
    return np.random.default_rng(seed).integers(3, spec.vocab_size, n).tolist()


def ep_prefill(spec, params, prompt, device, pages: bool = False):
    """One prefill of ``prompt`` on scratch pools (this rank's KV heads, or
    MLA's whole latent pool) through the family's entry point: (its last
    position's logits on the host, the slots its experts dropped), and with
    ``pages`` its pages on the host (``tp_pages``' numpy blocks) and each
    MoE layer's chosen experts [T, k] (``moe.route``, in layer order)."""
    from dynamo_tpu_torch.models import moe
    from dynamo_tpu_torch.models.family import get_family

    fam = get_family(spec)
    mesh = getattr(params, "mesh", None)
    bucket = -(-len(prompt) // 16) * 16
    n_pages = bucket // 16
    k, v = fam.init_cache(spec, n_pages + 1, 16, device=device,
                          tp=mesh.tp if mesh is not None else 1)
    tok = torch.zeros(bucket, dtype=torch.int32, device=device)
    tok[: len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
    bt = torch.arange(1, n_pages + 1, dtype=torch.int32, device=device)
    real, routes = moe.route, []

    def kept(spec_, lp, x):
        w, i = real(spec_, lp, x)
        routes.append(i)
        return w, i

    moe.route = kept
    try:
        with torch.no_grad(), counted_drops() as drops:
            logits, _ = fam.prefill(spec, params, tok, bt, 0, k, v, len(prompt))
    finally:
        moe.route = real
    out = (logits.float().cpu(), sum(int(d) for d in drops))
    if pages:
        from dynamo_tpu_torch.kvbm.offload import block_numpy

        kb, vb = fam.extract_pages(k, v, bt.long())
        out += ((block_numpy(kb.cpu()), block_numpy(vb.cpu())),
                [i[: len(prompt)].sort(dim=-1).values.cpu().numpy() for i in routes])
    del k, v
    return out


def ep_fault_logits(spec, params, prompt, device, kind: str):
    """``ep_prefill`` with a planted fault, the same on every rank (so the
    collectives still line up): ``reduce``, the first MoE layer's
    expert-group all-reduce skipped (each rank goes on with its partial);
    ``neighbour``, each rank's experts fed the rows routed to its
    neighbour ep rank's experts. The logits gate must reject both."""
    mesh = params.mesh
    if kind == "reduce":
        real, seen = mesh.all_reduce, []

        def skip_first(x, over="tp"):
            if over == "expert" and not seen:
                seen.append(over)
                return x
            return real(x, over)

        mesh.all_reduce = skip_first
        try:
            return ep_prefill(spec, params, prompt, device)[0]
        finally:
            del mesh.all_reduce
    ep0 = mesh.coords["ep"]
    mesh.coords["ep"] = (ep0 + 1) % mesh.ep
    try:
        return ep_prefill(spec, params, prompt, device)[0]
    finally:
        mesh.coords["ep"] = ep0


async def ep_rank_serve(rank, n, job):
    """One rank of a phase-23 group: the port's entry points (the group's
    bootstrap, make_mesh(ep, tp), this rank's shard of the seeded init
    drawn one rank at a time, the engine behind an SPMD leader or a
    follower shell); rank 0 serves the prompts, the others replay."""
    import torch.distributed as dist

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.models.family import get_family
    from dynamo_tpu_torch.parallel.mesh import make_mesh
    from dynamo_tpu_torch.parallel.spmd import SpmdFollower, SpmdLeader, StoreHub

    ep = job["ep"]
    mesh = make_mesh(ep=ep, tp=n // ep)
    dev = mesh.device
    spec = ModelSpec(**job["spec"])
    out = {"rank": rank, "device": str(dev), "coords": dict(mesh.coords)}
    # one rank draws at a time: a full expert stack is drawn in f32 before
    # it is cut (15 GB for deepseek-r1's), and every rank shares this card
    for r in range(n):
        if r == rank:
            t0 = time.perf_counter()
            params = get_family(spec).init_params(spec, 0, device=dev, mesh=mesh)
            with torch.no_grad():
                params.embed.mul_(MOE_EMBED_SCALE)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out["init_s"] = time.perf_counter() - t0
            out["params_bytes"] = sum(p.nbytes for p in params.parameters())
            if dev.type == "cuda":
                torch.cuda.empty_cache()  # the f32 draws' blocks, for the next rank
        dist.barrier()
    logits, out["drops"], out["alone_pages"], out["routes"] = ep_prefill(
        spec, params, job["alone"], dev, pages=True)
    faults = {kind: ep_fault_logits(spec, params, job["alone"], dev, kind)
              for kind in job["faults"]}
    if rank == 0:
        out["logits"] = logits.numpy()
        out["faults"] = {k: v.numpy() for k, v in faults.items()}
    cfg = EngineConfig(**job["cfg"], tp=mesh.tp, ep=ep, cuda_graphs=False)
    group = f"phase23/{job['label']}"
    stats0 = {k: dict(v) for k, v in mesh.group_stats.items()}
    if rank == 0:
        leader = await SpmdLeader(StoreHub(), asyncio.get_running_loop(), group,
                                  strict=True).start()
        engine = InferenceEngine(spec, cfg, params=params, device=dev, mesh=mesh,
                                 spmd=leader)
        out["mem_bytes"] = _allocated(dev)
        out["pool_bytes"] = engine.pool_bytes
        zero_counts()
        with counted_drops() as kept:
            await engine.start()
            results, ttft, wall, hit = await serve(engine, job["prompts"])
        out["counts"] = read_counts()
        out["serve_drops"] = sum(int(d) for d in kept)
        out.update(tokens={i: [t for x in items for t in x["token_ids"]]
                           for i, items in results.items()},
                   ttft=ttft, wall=wall, steps=engine.steps,
                   publishes=leader.publish_count)
        await engine.kv_digest()  # the followers record the same pages
        ids = engine.allocator.used_page_ids()[:TP_POOL_PAGES]
        out["hashes"] = [engine.allocator._page_hash.get(p) for p in ids]
        out["pages"] = tp_pages(engine, ids)
        await engine.close()
    else:
        engine = InferenceEngine(spec, cfg, params=params, device=dev, mesh=mesh)
        out["mem_bytes"] = _allocated(dev)
        zero_counts()
        f = SpmdFollower(StoreHub(), group, engine, rejoin=False)
        await f.run()
        out["counts"] = read_counts()
        out["ops"] = dict(f.ops)
        out["pages"] = tp_pages(engine, f.digest_pages[:TP_POOL_PAGES])
    out["coll"] = {g: {k: mesh.group_stats[g][k] - stats0[g][k] for k in stats0[g]}
                   for g in stats0}
    return out


def ep_reference(spec, cfg, prompts, alone):
    """The one-rank engine on the same seeded weights (eager steps, as the
    gloo groups'): its prefill logits and drops for ``alone``, its greedy
    streams with the first position of each whose reference top-2 gap is
    under NEAR_ARGMAX, its sealed pages by block hash, its weight bytes.
    Everything it returns is on the host: the card is freed for the
    ranks."""
    import gc

    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.kvbm.offload import block_tensor
    from dynamo_tpu_torch.models import llama, mla
    from dynamo_tpu_torch.models.family import get_family

    params = get_family(spec).init_params(spec, 0, device=DEVICE)
    with torch.no_grad():
        params.embed.mul_(MOE_EMBED_SCALE)
    out = {"params_bytes": sum(p.nbytes for p in params.parameters()),
           "alone_len": len(alone)}
    out["logits"], out["drops"], (kb, vb), out["routes"] = ep_prefill(
        spec, params, alone, DEVICE, pages=True)
    out["alone_pages"] = (block_tensor(kb).float(), block_tensor(vb).float())
    engine = InferenceEngine(spec, EngineConfig(**cfg, cuda_graphs=False), params=params,
                             device=DEVICE)
    with counted_drops() as kept:
        res = serve_phases(engine, [("default", lambda e: serve(e, prompts))])["default"]
    out["serve_drops"] = sum(int(d) for d in kept)
    out["tokens"] = {i: [t for x in items for t in x["token_ids"]]
                     for i, items in res["res"][0].items()}
    fwd = (mla if spec.is_mla else llama).reference_forward
    ties = {}
    for i, toks in out["tokens"].items():
        seq = torch.tensor(prompts[i] + toks[:-1], device=DEVICE)
        with torch.no_grad():
            top2 = fwd(spec, params, seq)[len(prompts[i]) - 1:].topk(2, dim=-1).values
        near = ((top2[:, 0] - top2[:, 1]) < NEAR_ARGMAX).cpu().numpy()
        ties[i] = int(np.argmax(near)) if near.any() else len(toks)
    out["ties"] = ties
    hashes = dict(engine.allocator._hash_page)
    kb, vb = engine.fam.extract_pages(
        engine.k_pages, engine.v_pages,
        torch.tensor(list(hashes.values()), dtype=torch.int64, device=DEVICE))
    kb, vb = kb.float().cpu(), vb.float().cpu()
    out["pages"] = {h: (kb[:, j], vb[:, j]) for j, h in enumerate(hashes)}
    drop_engine(engine)
    del engine, params, kb, vb
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ep_check(spec, ref, ranks, label, card, faults) -> int:
    """Hold a group against the one-rank reference: prefill logits within
    TP_LOGIT_TOL and each planted fault above it, the prefill's dropped
    slots equal on every rank, streams equal up to the reference's first
    near-tie, each rank's pages (its tp coordinate's KV heads; MLA's whole
    latent rows) within TP_POOL_TOL of the reference's: every layer of the
    alone prompt's, layer 0 of the serve's; the ep replicas of each tp
    coordinate bitwise equal (MLA: all ranks), fused_decode once per layer
    per step on every rank of a GQA group. Prints per-rank
    weights, memory and collectives per group. Returns every rank's
    fused_decode launches."""
    from dynamo_tpu_torch.kvbm.offload import block_tensor

    lead = ranks[0]
    n, L = len(ranks), spec.num_layers
    tp = 1 + max(r["coords"]["tp"] for r in ranks)
    want = ref["logits"]
    scale = want.abs().max().item()
    lerr = (torch.from_numpy(lead["logits"]) - want).abs().max().item() / scale
    require(lerr <= TP_LOGIT_TOL, f"{label}: prefill logits differ by {lerr:.3e} of the max")
    ferr = {k: (torch.from_numpy(v) - want).abs().max().item() / scale
            for k, v in lead.get("faults", {}).items()}
    for k in faults:
        require(ferr[k] > TP_LOGIT_TOL, f"{label}: planted fault {k} differs by only "
                f"{ferr[k]:.3e}: the gate cannot see it")
    drops = [r["drops"] for r in ranks]
    require(all(d == ref["drops"] for d in drops),
            f"{label}: prefill dropped slots {drops} per rank, one rank {ref['drops']}")
    print(f"{label}: prefill logits ({ref['alone_len']}-token prompt) vs one rank "
          f"max |diff| / max |logit| {lerr:.3e} (tol {TP_LOGIT_TOL}); planted faults "
          f"{ {k: f'{v:.3e}' for k, v in ferr.items()} }; dropped slots {drops[0]} on every "
          f"rank, one rank {ref['drops']}")
    same_all, parts = 0, []
    for i, want_t in ref["tokens"].items():
        got = lead["tokens"][i]
        require(len(got) == SERVE_TOKENS, f"{label}: request {i} {len(got)} tokens")
        same = next((j for j, (a, b) in enumerate(zip(got, want_t)) if a != b), len(got))
        if same < len(got):
            require(same >= ref["ties"][i], f"{label}: request {i} parts from one rank at "
                    f"{same} before its first near-tie at {ref['ties'][i]}")
            parts.append((i, same, ref["ties"][i]))
        else:
            same_all += 1
    print(f"{label}: {same_all} of {len(ref['tokens'])} greedy streams equal to one rank's, "
          f"the others part at or after a near-tie (request, first difference, first "
          f"near-tie): {parts}; serve drops {lead['serve_drops']} (one rank "
          f"{ref['serve_drops']}: a router near-tie decided otherwise moves capacity "
          "positions)")
    def rel(got, want):
        return (got - want).abs().max().item() / want.abs().max().item()

    def head_cut(want, t, kh):  # [L, (n,) KH, page, D]: tp coordinate t's heads
        return want if spec.is_mla else want.narrow(-3, t * kh, kh)

    # the prompt alone (the prefill of the logits gate): a token row of
    # layer l whose experts matched one rank's in every MoE layer before l
    # ("routed alike") within TP_POOL_TOL of its layer's max; a row past a
    # router near-tie that the rounding of x decided otherwise moves by O(1)
    # and is counted and printed
    T = ref["alone_len"]
    moe_layers = [l for l in range(L) if not spec.is_mla or l >= spec.first_k_dense]
    alike = torch.ones(L, T, dtype=torch.bool)
    for m, (a, b) in enumerate(zip(lead["routes"], ref["routes"])):
        alike[moe_layers[m] + 1:] &= torch.from_numpy((a == b).all(-1))
    for res in ranks:
        require(all(np.array_equal(a, b) for a, b in zip(res["routes"], lead["routes"])),
                f"{label}: rank {res['coords']} routed otherwise than rank 0")
    flips = [int((~(a == b).all(-1)).sum()) for a, b in zip(lead["routes"], ref["routes"])]
    def row_err(got, want):  # [L, T]: each token row's max |diff| / its layer's max
        dims = tuple(range(2, got.dim() - 2)) + (got.dim() - 1,)  # heads and D
        err = (got - want).abs().amax(dim=dims).reshape(L, -1)[:, :T]
        return err / want.abs().reshape(L, -1).amax(dim=1)[:, None]

    alone, other, swapped = 0.0, 0.0, float("inf")
    for res in ranks:
        t = res["coords"]["tp"]
        for pool in (0,) if spec.is_mla else (0, 1):
            got = block_tensor(res["alone_pages"][pool]).float()
            kh = 0 if spec.is_mla else got.shape[2]
            err = row_err(got, head_cut(ref["alone_pages"][pool], t, kh))
            alone = max(alone, err[alike].max().item())
            if (~alike).any():
                other = max(other, err[~alike].max().item())
            if kh and tp > 1:  # the planted fault: this rank against its neighbour's heads
                wrong = row_err(got, head_cut(ref["alone_pages"][pool], (t + 1) % tp, kh))
                swapped = min(swapped, wrong[alike].max().item())
    require(alone <= TP_POOL_TOL, f"{label}: the alone prompt's routed-alike rows differ "
            f"by {alone:.3e} of their layer's max")
    require(swapped > TP_POOL_TOL, f"{label}: pages against a neighbour's KV heads differ "
            f"by only {swapped:.3e}: the gate cannot see a wrong shard")
    # the serve's sealed pages: layer 0 (upstream of every routing
    # decision) within TP_POOL_TOL; deeper layers follow the routing, and a
    # token that one side routes or drops otherwise (capacity positions
    # move with the rounding of x) moves by O(1): their worst and the share
    # of pages within TP_POOL_TOL are printed
    ids, _k, _v = lead["pages"]
    rows = [j for j, h in enumerate(lead["hashes"]) if h in ref["pages"]]
    require(len(rows) >= 16, f"{label}: {len(rows)} sealed blocks in common with one rank")
    first, deep, within, total_pages = 0.0, 0.0, 0, 0
    blocks = []
    for r, res in enumerate(ranks):
        rids, kb, vb = res["pages"]
        require(list(rids) == list(ids), f"{label}: rank {r} holds other pages")
        blocks.append((kb, vb))
        for pool, got in ((0, block_tensor(kb)), (1, block_tensor(vb))):
            if spec.is_mla and pool == 1:
                continue  # the inert v slot
            for j in rows:
                g = got[:, j].float()
                w = head_cut(ref["pages"][lead["hashes"][j]][pool], res["coords"]["tp"],
                             0 if spec.is_mla else g.shape[1])
                first = max(first, rel(g[0], w[0]))
                e = rel(g, w)
                deep = max(deep, e)
                within += e <= TP_POOL_TOL
                total_pages += 1
    require(first <= TP_POOL_TOL, f"{label}: layer 0 of the rank pages differs by "
            f"{first:.3e} of the max")
    groups = {}
    for r, res in enumerate(ranks):
        groups.setdefault(0 if spec.is_mla else res["coords"]["tp"], []).append(r)
    for members in groups.values():
        for r in members[1:]:
            same = [np.array_equal(a, b) for a, b in zip(blocks[r], blocks[members[0]])]
            same += [np.array_equal(a, b) for a, b in
                     zip(ranks[r]["alone_pages"], ranks[members[0]]["alone_pages"])]
            require(all(same), f"{label}: rank {r}'s pages differ from rank "
                    f"{members[0]}'s (ep replicas must be bitwise equal)")
    print(f"{label}: vs one rank's {'latent rows' if spec.is_mla else 'matching KV-head slice'}"
          f" (max |diff| / max |value|, tol {TP_POOL_TOL}): the alone prompt's rows routed "
          f"alike {alone:.3e} ({int(alike.sum())} of {L * T}; tokens routed otherwise per "
          f"MoE layer {flips}, the rows after them {other:.3e}"
          + (f"; planted fault, each rank against its neighbour's heads, at least "
             f"{swapped:.3e}" if swapped < float("inf") else "")
          + f"); the serve's {len(rows)} sealed pages per rank, layer 0 "
          f"{first:.3e}, all layers worst {deep:.3e} ({within} of {total_pages} rank pages "
          f"within the tolerance); pages bitwise equal within each replica set "
          f"{list(groups.values())}, the serve's and the alone prompt's")
    total = 0
    steps = lead["steps"]
    for r, res in enumerate(ranks):
        c = res["counts"]
        want_f = 0 if spec.is_mla else L * steps
        require(DEVICE != "cuda" or (c["fused_decode"] == want_f
                                     and (spec.is_mla or c["fused_decode"] > 0)
                                     and c["kv_write"] == 0
                                     and c["paged_attention_v3"] == 0),
                f"{label}: rank {r} launches {c} over {steps} decode steps")
        total += c["fused_decode"]
        co = res["coll"]
        print(f"{label}: rank {r} {res['coords']} on {res['device']}: fused_decode "
              f"{c['fused_decode']} launches ({L} x {steps} steps); weights "
              f"{res['params_bytes'] / 1e9:.3f} GB (one rank {ref['params_bytes'] / 1e9:.3f}), "
              f"allocated after the pools {res['mem_bytes'] / 1e9:.3f} GB, init "
              f"{res['init_s']:.1f} s; expert group {co['expert']['calls']} all-reduces "
              f"{co['expert']['bytes'] / 1e6:.1f} MB {co['expert']['secs']:.2f} s, tp group "
              f"{co['tp']['calls']} collectives {co['tp']['bytes'] / 1e6:.1f} MB "
              f"{co['tp']['secs']:.2f} s" + (f"; replayed {res['ops']}" if "ops" in res else ""))
    share = (lead["coll"]["expert"]["secs"] + lead["coll"]["tp"]["secs"]) / lead["wall"]
    print(f"{label} [{card}]: NOT ep timings ({n} processes time-slice one card): serve "
          f"{sum(len(t) for t in lead['tokens'].values())} tokens in {lead['wall']:.2f} s, "
          f"TTFT mean {1e3 * sum(lead['ttft'].values()) / len(lead['ttft']):.1f} ms, "
          f"{lead['publishes']} descriptors; the leader's collectives {share:.3f} of the "
          f"serve's wall (staged through host memory); pools {lead['pool_bytes'] / 1e9:.3f} "
          f"GB per rank")
    return total


def ep_group(kind, layers, ep, tp, cfg, label, card, faults) -> int:
    """Phase 23 (a)-(c): the one-rank reference in this process (freed
    before the ranks start), then ep x tp gloo ranks on this card."""
    import dataclasses

    t0 = time.perf_counter()
    spec = ep_spec(kind, layers)
    prompts = make_prompts(spec.vocab_size)[:EP_PROMPTS]
    alone = ep_alone(spec)
    ref = ep_reference(spec, cfg, prompts, alone)
    free, total = torch.cuda.mem_get_info() if DEVICE == "cuda" else (0, 0)
    print(f"{label}: one-rank reference done; this process holds "
          f"{_allocated(torch.device(DEVICE)) / 1e9:.3f} GB, the card has {free / 1e9:.1f} of "
          f"{total / 1e9:.1f} GB free")
    job = {"spec": dataclasses.asdict(spec), "cfg": dict(cfg), "prompts": prompts,
           "alone": alone, "ep": ep, "faults": faults, "backend": "gloo",
           "device": DEVICE, "label": label}
    # the ranks draw full expert stacks one at a time in a card they share:
    # growable segments keep a freed f32 stack reusable after its cut
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = run_ranks(ep * tp, tp_rank, job)
    finally:
        if conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    launches = ep_check(spec, ref, ranks, label, card, faults)
    print(f"{label}: {time.perf_counter() - t0:.1f} s")
    return launches


def ep_kernel_row(flush, card) -> dict:
    """fused_decode at gpt-oss-120b's tp=2 rank shape (B 8, KH 4, G 8, D 64,
    window MOE_WINDOW + sinks), bf16 and fp8 pools: held against its plain
    version, timed beside it, SDPA with the same window and sinks, and the
    bound. Returns the bf16 row of the kernels line."""
    from dynamo_tpu_torch.ops.cuda import fused_decode

    over = dict(KH=4, G=8, D=64)
    layer = 1
    row = {}
    for fp8 in (False, True):
        t = kernel_inputs(torch.bfloat16, seed=23, **over)
        if fp8:
            fp8_pools(t)
        form = "fp8" if fp8 else "bf16"
        err, _ = check_attention(t, f"gpt-oss tp=2 (KH 4 G 8) {form}", MOE_WINDOW,
                                 t["sinks"], layer)
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
        r["bound_ms"], r["bound_by"] = attention_bound(True, MOE_WINDOW, fp8=fp8, **over)
        print(f"time gpt-oss tp=2 (KH 4 G 8 D 64, window {MOE_WINDOW} + sinks) {form} "
              f"[{card}]: fused_decode {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
        if not fp8:
            row = r
        del t, kp, vp
    return {"fused_decode/gpt-oss-tp2": row}


def ep_phase(cfg, card, flush) -> tuple[dict, dict[str, int]]:
    """Phase 23: expert parallelism on the card (see the module docstring).
    Returns the kernel row at gpt-oss's tp=2 rank shape and the phase's
    fused_decode launches by shape."""
    t23 = time.perf_counter()
    rows = ep_kernel_row(flush, card)
    # one prompt per prefill on both sides: a packed group's rows share the
    # experts' capacity, and the one-rank engine (async admissions) and an
    # SPMD leader (synchronous first tokens) group arrivals differently
    cfg = dict(cfg, prefill_pack_size=1)
    both = ["reduce", "neighbour"]
    a = ep_group("gpt-oss", MOE_LAYERS, 2, 2, cfg,
                 f"phase 23 (a) gpt-oss-120b (full width, {MOE_LAYERS} layers) ep=2 x tp=2 "
                 "gloo", card, both)
    b = ep_group("deepseek-r1", MLA_LAYERS, 2, 2, cfg,
                 f"phase 23 (b) deepseek-r1 (full width, {MLA_LAYERS} layers) ep=2 x tp=2 "
                 "gloo", card, both)
    c = ep_group("gpt-oss", EP_WIDE_LAYERS, 4, 1, cfg,
                 f"phase 23 (c) gpt-oss-120b (full width, {EP_WIDE_LAYERS} layers) ep=4 x "
                 "tp=1 gloo", card, [])
    print(f"phase 23: {time.perf_counter() - t23:.1f} s, fused_decode launches (a) {a} "
          f"(b) {b} (c) {c}")
    return rows, {"fused_decode/gpt-oss-tp2": a, "fused_decode/gpt-oss": c}


# ------------------------------------------ pipeline and sequence parallelism

PP_STEPS = 32  # greedy pp_decode_steps of (a) and (b)
PP8_LAYERS = 4  # llama-3-8b at full width, cut to this many layers in (a) and (b)
PP70_STEPS = 8  # of (c)
PP70_LAYERS = 4  # llama-3-70b at full width, one layer per stage of (c)
PP_PAGES = 40  # pages per slot: the longest prompt (512 tokens) and 32 steps need 34
PP_CMP_PAGES = 8  # prompt 0's first pages, held against the one-rank pools
SP_PROMPT = 2048  # (d)'s cold prompt
SP_SEED = 2424
# (d)'s engine: the 2,048-token prompt and its 32 tokens need 130 pages of
# the table; graphs off (a gloo group's collectives cannot be captured)
SP_CFG = dict(page_size=16, num_pages=512, max_pages_per_seq=160, max_decode_slots=8,
              cuda_graphs=False)
SP_LAYERS = 8  # (d): llama-3-8b at full width, cut to this many layers
DP_LAYERS = 4  # (e): llama-3-8b at full width, cut to this many layers


def pp_tables(B: int) -> np.ndarray:
    """Slot i's block table: pages 1 + i * PP_PAGES onward (page 0 is trash)."""
    return np.stack([np.arange(1 + i * PP_PAGES, 1 + (i + 1) * PP_PAGES)
                     for i in range(B)]).astype(np.int32)


def pp_padded(prompt, device) -> torch.Tensor:
    tok = torch.zeros(-(-len(prompt) // 16) * 16, dtype=torch.int32, device=device)
    tok[: len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
    return tok


def pp_drive(prefill, decode, prompts, steps, device) -> dict:
    """Each prompt's prefill in turn (``prefill(i, tokens, n)`` -> logits
    [V]), then ``steps`` greedy decode steps of all slots (``decode(tokens,
    seq_lens)`` -> logits [B, V]). Returns the prefill logits, the first
    decode step's logits, the streams and, per slot and position, the gap
    between the two largest logits (a stream may part from another only at
    a near-tie)."""
    B = len(prompts)
    t0 = time.perf_counter()
    first = torch.stack([prefill(i, pp_padded(p, device), len(p)).float()
                         for i, p in enumerate(prompts)])
    t1 = time.perf_counter()
    lg, gaps, streams = first, [], [[] for _ in range(B)]
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=device)
    step0 = None
    for s in range(steps + 1):
        top2 = lg.topk(2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).cpu())
        tok = lg.argmax(-1).to(torch.int32)
        for i, t in enumerate(tok.tolist()):
            streams[i].append(t)
        if s == steps:
            break
        lens = lens + 1
        lg = decode(tok, lens).float()
        if s == 0:
            step0 = lg.cpu().numpy()
    # numpy: a torch tensor crosses a process queue as a descriptor that dies
    # with its process
    return {"prefill": first.cpu().numpy(), "step0": step0, "streams": streams,
            "gaps": torch.stack(gaps, 1).numpy(), "prefill_s": t1 - t0,
            "decode_s": time.perf_counter() - t1}


def pp_reference(spec, params, prompts, steps) -> dict:
    """The one-rank path on the same seeded weights: prefill_forward of
    each prompt, then decode_forward steps (the fused kernel); its pools
    stay in the result (``pools``) for the page checks."""
    from dynamo_tpu_torch.models import llama

    B = len(prompts)
    k, v = llama.init_cache(spec, 1 + B * PP_PAGES, 16, device=DEVICE)
    bt = torch.from_numpy(pp_tables(B)).to(DEVICE)
    active = torch.ones(B, dtype=torch.bool, device=DEVICE)
    with torch.no_grad():
        out = pp_drive(
            lambda i, tok, n: llama.prefill_forward(spec, params, tok, bt[i], 0, k, v, n)[0],
            lambda tok, lens: llama.decode_forward(spec, params, tok, bt, lens, k, v, active),
            prompts, steps, DEVICE)
    # prompt 0's first pages, for the stage checks
    out["pools"] = (k[:, 1:1 + PP_CMP_PAGES].clone(), v[:, 1:1 + PP_CMP_PAGES].clone())
    return out


def pp_cell(spec, axes, prompts, steps, dev) -> dict:
    """One pipeline cell on this rank: its stage of the seeded init
    (init_params with the mesh, then stack_params), its stage pools, each
    prompt through pp_prefill, ``steps`` pp_decode_steps. Counts the
    kernels' launches and the collectives per group over the decode steps
    alone (zeroed just before them)."""
    import hashlib

    from dynamo_tpu_torch.kvbm.offload import block_numpy
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.parallel.mesh import make_mesh
    from dynamo_tpu_torch.parallel.pipeline import (
        init_stage_cache,
        pp_decode_step,
        pp_prefill,
        stack_params,
    )

    mesh = make_mesh(**axes)
    t0 = time.perf_counter()
    stage = stack_params(spec, llama.init_params(spec, 0, device=dev, mesh=mesh))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wbytes = sum(t.nbytes for t in (stage.embed, stage.final_norm, *stage.layers.values()))
    wbytes += stage.lm_head.nbytes if stage.lm_head is not None else 0
    res = {"coords": dict(mesh.coords), "init_s": time.perf_counter() - t0,
           "weights_bytes": wbytes, "n_local": stage.n_local}
    B = len(prompts)
    k, v = init_stage_cache(spec, 1 + B * PP_PAGES, 16, mesh, device=dev)
    bt = torch.from_numpy(pp_tables(B)).to(dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    marks = {}

    def decode(tok, lens):
        if not marks:  # the decode steps alone: counts and collectives from here
            zero_counts()
            marks.update({g: dict(st) for g, st in mesh.group_stats.items()})
        return pp_decode_step(spec, stage, tok, bt, lens, k, v, active)

    with torch.no_grad():
        out = pp_drive(lambda i, tok, n: pp_prefill(spec, stage, tok, bt[i], k, v, n),
                       decode, prompts, steps, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    res["counts"] = read_counts()
    res["coll"] = {g: {key: st[key] - marks[g][key] for key in ("calls", "bytes", "secs")}
                   for g, st in mesh.group_stats.items()}
    res.update(out)
    res["pages"] = (block_numpy(k[:, 1:1 + PP_CMP_PAGES].cpu()),
                    block_numpy(v[:, 1:1 + PP_CMP_PAGES].cpu()))
    res["digest"] = hashlib.sha256(block_numpy(k[:, 1:].cpu()).tobytes()
                                   + block_numpy(v[:, 1:].cpu()).tobytes()).hexdigest()
    del stage, k, v
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


async def sp_engine_cell(spec, prompts, long_prompt, dev) -> dict:
    """(d) on this rank: make_mesh(sp=2, tp=2), its shard of the seeded
    init, the 2,048-token prompt's ring-prefill logits on scratch pools,
    then an engine per pool type (rank 0 an SPMD leader serving the long
    prompt and phase 4's prompts, the others followers)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.parallel.mesh import make_mesh
    from dynamo_tpu_torch.parallel.spmd import SpmdFollower, SpmdLeader, StoreHub

    mesh = make_mesh(sp=2, tp=2)
    params = llama.init_params(spec, 0, device=dev, mesh=mesh)
    n_pg = SP_PROMPT // 16
    k, v = llama.init_cache(spec, n_pg + 1, 16, device=dev, tp=2)
    s0 = {g: dict(st) for g, st in mesh.group_stats.items()}
    with torch.no_grad():
        logits, _ = llama.prefill_forward_ring(
            spec, params, pp_padded(long_prompt, dev),
            torch.arange(1, n_pg + 1, dtype=torch.int32, device=dev), k, v, SP_PROMPT)
    res = {"coords": dict(mesh.coords), "logits": logits.float().cpu().numpy(),
           "ring_coll": {g: {key: st[key] - s0[g][key] for key in ("calls", "bytes")}
                         for g, st in mesh.group_stats.items()}}
    del k, v
    for kv in ("bf16", "fp8"):
        cfg = EngineConfig(**SP_CFG, sp=2, tp=2, kv_dtype=kv)
        group = f"phase24/{kv}"
        r: dict = {}
        if mesh.rank == 0:
            leader = await SpmdLeader(StoreHub(), asyncio.get_running_loop(), group,
                                      strict=True).start()
            engine = InferenceEngine(spec, cfg, params=params, device=dev, mesh=mesh,
                                     spmd=leader)
            zero_counts()
            p0 = leader.publish_count
            await engine.start()
            t0 = time.perf_counter()
            first = await requests(engine, [make_request(long_prompt)])
            results, ttft, wall, hit = await serve(engine, prompts)
            r["wall"] = time.perf_counter() - t0
            r["counts"] = read_counts()
            r["tokens"] = {i: [t for x in items for t in x["token_ids"]]
                           for i, items in results.items()}
            r["long"] = [t for x in first[0][0] for t in x["token_ids"]]
            r.update(ring_prefills=engine.ring_prefills, prefills=engine.prefill_forwards,
                     publishes=leader.publish_count - p0, steps=engine.steps)
            r["digest"] = await engine.kv_digest()
            if kv == "bf16":
                ids = engine.allocator.used_page_ids()[:TP_POOL_PAGES]
                r["hashes"] = [engine.allocator._page_hash.get(p) for p in ids]
                r["pages"] = tp_pages(engine, ids)
            await engine.close()
        else:
            engine = InferenceEngine(spec, cfg, params=params, device=dev, mesh=mesh)
            zero_counts()
            f = SpmdFollower(StoreHub(), group, engine, rejoin=False)
            await f.run()
            r["counts"] = read_counts()
            r["ops"] = dict(f.ops)
            r["digest"] = engine.pool_digest(f.digest_pages)
            if kv == "bf16":
                r["pages"] = tp_pages(engine, f.digest_pages[:TP_POOL_PAGES])
        engine.k_pages = engine.v_pages = None
        res[kv] = r
    del params
    return res


def pp_sp_rank(rank, n, port, job, q):
    """A spawned rank of phase 24: join the 4-rank gloo group on this card,
    run (a), (b) and (c) through pp_cell (each cell's weights freed before
    the next) and (d) through sp_engine_cell; put the results on ``q``."""
    import traceback

    try:
        sys.path.insert(0, str(ROOT))
        from dynamo_tpu_torch.engine.config import ModelSpec
        from dynamo_tpu_torch.ops.cuda import build
        from dynamo_tpu_torch.parallel.multihost import initialize_multihost, shutdown

        if torch.cuda.is_available():
            build.load_library()  # built by the parent
        initialize_multihost(f"127.0.0.1:{port}", n, rank, device=job["device"],
                             backend="gloo", timeout_s=TP_TIMEOUT_S)
        from dynamo_tpu_torch.parallel.multihost import local_device

        dev = local_device()
        try:
            spec8 = ModelSpec(**job["spec8"])
            specpp = ModelSpec(**job["specpp"])
            spec70 = ModelSpec(**job["spec70"])
            out = {}
            for cell, spec, axes, steps in (("a", specpp, dict(pp=2, tp=2), PP_STEPS),
                                            ("b", specpp, dict(pp=2, dp=2), PP_STEPS),
                                            ("c", spec70, dict(pp=4), PP70_STEPS)):
                t0 = time.perf_counter()
                out[cell] = r = pp_cell(spec, axes, job["prompts"], steps, dev)
                if rank == 0:
                    print(f"phase 24 ({cell}) rank 0: {time.perf_counter() - t0:.1f} s (init "
                          f"{r['init_s']:.1f}, prefills {r['prefill_s']:.1f}, decode "
                          f"{r['decode_s']:.1f})", flush=True)
            t0 = time.perf_counter()
            out["d"] = asyncio.run(sp_engine_cell(spec8, job["prompts"], job["long"], dev))
            if rank == 0:
                print(f"phase 24 (d) rank 0: {time.perf_counter() - t0:.1f} s", flush=True)
            q.put((rank, out))
        finally:
            shutdown()
    except BaseException:  # noqa: BLE001 - reported to the parent
        q.put((rank, {"error": traceback.format_exc()}))
    finally:
        q.close()
        q.join_thread()


def pp_streams_check(ref, got, label) -> str:
    """Streams equal to the reference's up to its first near-tie (a top-2
    gap under NEAR_ARGMAX); returns the count line."""
    same_all, parts = 0, []
    for i, want in enumerate(ref["streams"]):
        mine = got["streams"][i]
        same = next((j for j, (a, b) in enumerate(zip(mine, want)) if a != b), len(want))
        near = np.flatnonzero(ref["gaps"][i] < NEAR_ARGMAX)
        tie = int(near[0]) if len(near) else len(want)
        require(same >= tie, f"{label}: slot {i} parts from one rank at {same} before its "
                f"first near-tie at {tie}")
        same_all += same == len(want)
        if same < len(want):
            parts.append((i, same, tie))
    return (f"{same_all} of {len(ref['streams'])} greedy streams equal to one rank's, the "
            f"others part at or after a near-tie (slot, first difference, first "
            f"near-tie): {parts}")


def pp_check(spec, ref, ranks, axes, label, card) -> dict[str, int]:
    """(a)-(c) against the one-rank path: every rank's prefill and first
    decode step logits within TP_LOGIT_TOL, streams equal up to the first
    near-tie, each rank's pages of prompt 0 within TP_POOL_TOL of the
    one-rank pools' matching layers and KV heads, kv_write and
    paged_attention_v3 once per layer per tick (2 pp - 1 ticks) per decode
    step on every rank and no fused_decode. Returns the ranks' launches."""
    from dynamo_tpu_torch.kvbm.offload import block_tensor

    S, tp = axes.get("pp", 1), axes.get("tp", 1)
    n_local = spec.num_layers // S
    steps = len(ref["streams"][0]) - 1
    ticks = 2 * S - 1
    scale = np.abs(ref["prefill"]).max()
    rk, rv = ref["pools"]
    launches = {"kv_write": 0, "paged_attention_v3": 0}
    for r, res in enumerate(ranks):
        lerr = float(np.abs(res["prefill"] - ref["prefill"]).max() / scale)
        same0 = [i for i in range(len(ref["streams"]))
                 if res["streams"][i][0] == ref["streams"][i][0]]
        derr = float(np.abs(res["step0"][same0] - ref["step0"][same0]).max()
                     / np.abs(ref["step0"][same0]).max())
        require(lerr <= TP_LOGIT_TOL and derr <= TP_LOGIT_TOL,
                f"{label}: rank {r} logits differ: prefill {lerr:.3e}, decode {derr:.3e}")
        c = res["coords"]
        ls = slice(c["pp"] * n_local, (c["pp"] + 1) * n_local)
        kh = rk.shape[2] // tp
        hs = slice(c["tp"] * kh, (c["tp"] + 1) * kh)
        perr = 0.0
        for got, want in zip(res["pages"], (rk, rv)):
            want = want[ls, :, hs].float().cpu()
            got = block_tensor(got).float()
            perr = max(perr, (got - want).abs().max().item() / want.abs().max().item())
        require(perr <= TP_POOL_TOL, f"{label}: rank {r} pages differ by {perr:.3e}")
        cnt = res["counts"]
        want_n = ticks * n_local * steps
        require(cnt["kv_write"] == want_n and cnt["paged_attention_v3"] == want_n
                and cnt["fused_decode"] == 0,
                f"{label}: rank {r} launches {cnt}, want {want_n} kv_write and "
                f"paged_attention_v3 ({ticks} ticks x {n_local} layers x {steps} steps)")
        for name in launches:
            launches[name] += cnt[name]
        co = res["coll"]
        per = {g: f"{co[g]['calls'] / steps:.0f} calls {co[g]['bytes'] / steps / 1e3:.1f} kB"
               for g in ("pp", "tp", "dp") if co[g]["calls"]}
        print(f"{label}: rank {r} (pp {c['pp']}, tp {c['tp']}, dp {c['dp']}): "
              f"{res['n_local']} layers, weights {res['weights_bytes'] / 1e9:.3f} GB, init "
              f"{res['init_s']:.1f} s; logits vs one rank (max |diff| / max |logit|) prefill "
              f"{lerr:.3e}, decode step 0 {derr:.3e}; prompt 0's pages {perr:.3e} (tols "
              f"{TP_LOGIT_TOL}, {TP_POOL_TOL}); per decode step kv_write "
              f"{cnt['kv_write'] / steps:.0f} and paged_attention_v3 "
              f"{cnt['paged_attention_v3'] / steps:.0f} launches (predicted {ticks} ticks x "
              f"{n_local} layers = {ticks * n_local}); collectives per step: {per}")
    print(f"{label}: {pp_streams_check(ref, ranks[0], label)}")
    lead = ranks[0]
    print(f"{label} [{card}]: NOT pp timings ({len(ranks)} processes time-slice one card, "
          f"collectives staged through host memory): {len(ref['streams'])} pp_prefills in "
          f"{lead['prefill_s']:.2f} s, {steps} decode steps of "
          f"{len(ref['streams'])} slots in {lead['decode_s']:.2f} s on rank 0, "
          f"{lead['coll']['pp']['secs'] + lead['coll']['tp']['secs'] + lead['coll']['dp']['secs']:.2f} s of it "
          f"in collectives")
    return launches


def sp_check(spec, prompts, long_prompt, refs, ranks, label, card) -> int:
    """(d) against one rank: the ring prefill's logits within TP_LOGIT_TOL
    of prefill_forward's, every engine's streams equal to the one-rank
    engine's up to the first near-tie, the bf16 pages by block hash within
    TP_POOL_TOL of the one-rank pools' KV-head slice, the sp replicas'
    pools bitwise equal (kv_digest of ranks 0 and 2, 1 and 3), every prompt
    but the warm sharer by ring prefill, the followers replaying each.
    Returns every rank's fused_decode launches."""
    from dynamo_tpu_torch.kvbm.offload import block_tensor

    params, logits, engines = refs
    lerr = max((torch.from_numpy(r["logits"]) - logits).abs().max().item()
               for r in ranks) / logits.abs().max().item()
    require(lerr <= TP_LOGIT_TOL, f"{label}: ring prefill logits differ by {lerr:.3e}")
    co = ranks[0]["ring_coll"]
    L = spec.num_layers
    print(f"{label}: the {SP_PROMPT}-token prompt's ring prefill logits vs one rank's "
          f"prefill_forward, max |diff| / max |logit| over the 4 ranks {lerr:.3e} (tol "
          f"{TP_LOGIT_TOL}); per layer {co['sp']['calls'] / L:.0f} sends over sp "
          f"({co['sp']['bytes'] / L / 1e6:.3f} MB), {co['tp']['calls'] / L:.1f} all-reduces "
          f"over tp ({co['tp']['bytes'] / L / 1e6:.3f} MB)")
    total = 0
    for kv in ("bf16", "fp8"):
        lead = ranks[0][kv]
        engine, tokens, long_tokens = engines[kv]
        want = dict(tokens, long=long_tokens)
        got = dict(lead["tokens"], long=lead["long"])
        parts = []
        for i, w in want.items():
            g = got[i]
            require(len(g) == SERVE_TOKENS, f"{label} {kv}: request {i}: {len(g)} tokens")
            if g != w:
                p = long_prompt if i == "long" else prompts[i]
                same, tie = equal_to_first_near_tie(spec, params, p, g, w)
                require(same >= tie, f"{label} {kv}: request {i} parts at {same} before "
                        f"its first near-tie at {tie}")
                parts.append((i, same, tie))
        n_req = len(prompts) + 1
        require(lead["ring_prefills"] == n_req - 1 and lead["prefills"] == n_req,
                f"{label} {kv}: {lead['ring_prefills']} ring prefills of "
                f"{lead['prefills']} prefills")
        for r, res in enumerate(ranks[1:], 1):
            require(res[kv]["ops"].get("ring_prefill") == n_req - 1,
                    f"{label} {kv}: rank {r} replayed {res[kv]['ops']}")
        for a, b in ((0, 2), (1, 3)):
            da, db = ranks[a][kv]["digest"], ranks[b][kv]["digest"]
            require(da == db and da["pages"] > 0,
                    f"{label} {kv}: sp replicas {a} and {b} hold other pages: {da} {db}")
        steps = lead["steps"]
        for r, res in enumerate(ranks):
            c = res[kv]["counts"]
            name = "fused_decode/fp8" if kv == "fp8" else "fused_decode"
            require(c[name] == L * steps, f"{label} {kv}: rank {r} launches {c} over "
                    f"{steps} steps")
            total += c[name] if kv == "bf16" else 0
        if kv == "bf16":
            ids, _k, _v = lead["pages"]
            pairs = [(j, engine.allocator._hash_page[h]) for j, h in enumerate(lead["hashes"])
                     if h is not None and h in engine.allocator._hash_page]
            require(len(pairs) >= 16, f"{label}: {len(pairs)} sealed blocks in common")
            rows = [j for j, _p in pairs]
            ref_ids = torch.tensor([p for _j, p in pairs], device=engine.device)
            rk, rv = engine.fam.extract_pages(engine.k_pages, engine.v_pages, ref_ids)
            worst = 0.0
            for r, res in enumerate(ranks):
                _ids, kb, vb = res[kv]["pages"]
                t = res["coords"]["tp"]
                for gb, w in ((block_tensor(kb), rk), (block_tensor(vb), rv)):
                    kh = gb.shape[2]
                    cut = w[:, :, t * kh:(t + 1) * kh].float().cpu()
                    worst = max(worst, (gb[:, rows].float() - cut).abs().max().item()
                                / cut.abs().max().item())
            require(worst <= TP_POOL_TOL, f"{label}: pages differ by {worst:.3e}")
            print(f"{label} bf16: {len(pairs)} sealed pages on every rank vs the matching "
                  f"KV-head slice of one rank's pools: max |diff| / max |value| {worst:.3e} "
                  f"(tol {TP_POOL_TOL})")
        print(f"{label} {kv} [{card}]: {n_req} requests, {lead['ring_prefills']} by ring "
              f"prefill (the sharer of prompt 0's prefix takes the packed path), "
              f"{lead['publishes']} descriptors published (ring_prefill "
              f"{ranks[1][kv]['ops'].get('ring_prefill')}), sp replicas' pools bitwise "
              f"equal ({ranks[0][kv]['digest']['pages']} pages); streams equal to one "
              f"rank's but {parts} (request, first difference, first near-tie); "
              f"fused_decode {L} x {steps} steps per rank; served in {lead['wall']:.2f} s "
              f"(NOT an sp timing: 4 processes time-slice one card)")
    return total


def pp_kernel_rows(flush, card) -> dict[str, dict]:
    """paged_attention_v3 and kv_write at (a)'s stage shape (a microbatch
    of B 4 on a tp=2 rank: KH 4, G 4, D 128, phase 4's first seq_lens),
    held against their plain versions and timed beside them, SDPA / two
    index_copy_ calls and the bound."""
    from dynamo_tpu_torch.ops.attention import pool_layer
    from dynamo_tpu_torch.ops.cuda import kv_write, paged_attention_v3

    over = dict(B=4, KH=4, G=4)
    layer = 1
    t = kernel_inputs(torch.bfloat16, seed=24, **over)
    q, kn, vn, bt, sl, dp, do = (t[k] for k in
                                 ("q", "k_new", "v_new", "bt", "sl", "dst_page", "dst_off"))
    kp, vp = t["k_pages"], t["v_pages"]
    kp2, vp2 = kp.clone(), vp.clone()
    kv_write.kv_write(kp, vp, kn, vn, dp, do, layer=layer)
    kv_write.kv_write_plain(kp2, vp2, kn, vn, dp, do, layer=layer)
    torch.cuda.synchronize()
    require(torch.equal(kp[:, 1:], kp2[:, 1:]) and torch.equal(vp[:, 1:], vp2[:, 1:]),
            "kv_write at the pp stage shape: not bitwise equal to the plain version")
    kl, vl = pool_layer(kp, layer), pool_layer(vp, layer)
    got = paged_attention_v3.paged_decode_attention_v3(q, kl, vl, bt, sl)
    want = paged_attention_v3.paged_attention_v3_plain(q, kl, vl, bt, sl)
    torch.cuda.synchronize()
    err, reading = attention_error(got, want, "paged_attention_v3 pp stage shape")
    B, KH, D = q.shape[0], kp.shape[2], q.shape[2]
    seq_lens = t["sl"].tolist()
    v3 = {"max_abs_err": err,
          "ms": time_ms(lambda: paged_attention_v3.paged_decode_attention_v3(
              q, kl, vl, bt, sl), flush),
          "plain_ms": time_ms(lambda: paged_attention_v3.paged_attention_v3_plain(
              q, kl, vl, bt, sl), flush),
          "library_ms": time_ms(sdpa_call(t, layer), flush)}
    v3["bound_ms"], v3["bound_by"] = attention_bound(False, 0, seq_lens=seq_lens, **over)
    page, NP = kp.shape[3], kp.shape[1]
    rows = (((layer * NP + dp.long()) * KH)[:, None]
            + torch.arange(KH, device=DEVICE)[None]) * page + do.long()[:, None]
    rows = rows.reshape(-1)
    kflat, vflat = kp.view(-1, D), vp.view(-1, D)
    kr, vr = kn.reshape(-1, D), vn.reshape(-1, D)

    def library_copy():  # one index_copy_ per pool
        kflat.index_copy_(0, rows, kr)
        vflat.index_copy_(0, rows, vr)

    kw = {"max_abs_err": 0.0,
          "ms": time_ms(lambda: kv_write.kv_write(kp, vp, kn, vn, dp, do, layer=layer), flush),
          "plain_ms": time_ms(lambda: kv_write.kv_write_plain(kp, vp, kn, vn, dp, do,
                                                              layer=layer), flush),
          "library_ms": time_ms(library_copy, flush)}
    kw["bound_ms"], kw["bound_by"] = bound_ms(4 * B * KH * D * 2 + 2 * B * 4, 0.0)
    print(f"check pp stage shape (B 4, KH 4, G 4, D 128, seq_lens {seq_lens}): kv_write "
          f"bitwise equal outside page 0, paged_attention_v3 max err {reading}")
    for name, r in (("paged_attention_v3", v3), ("kv_write", kw)):
        print(f"time {name} pp stage shape [{card}]: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
    del t, kp, vp, kp2, vp2, kflat, vflat
    return {"paged_attention_v3/pp": v3, "kv_write/pp": kw}


def dp_worker_phase(card) -> int:
    """(e): ``cli worker`` with an EngineConfig of dp=2 (the reference's
    dp has no flag: ``--engine-config-json``), llama-3-8b at full width cut
    to DP_LAYERS layers (``--spec-json``), both ranks on this card (gloo,
    graphs off): the worker starts its dp replica, phase 4's prompts go
    over TCP, the admin kv_digest's pages equal the replica's bit for bit
    (its SPMD_KV_DIGEST), SIGTERM drains both. Returns rank 0's
    fused_decode launches."""
    import dataclasses

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
    from dynamo_tpu_torch.engine.worker import config_json

    t0 = time.perf_counter()
    spec = dataclasses.replace(ModelSpec.llama3_8b(), num_layers=DP_LAYERS,
                               name=f"llama-3-8b[{DP_LAYERS} layers]")
    ecfg = EngineConfig(page_size=16, num_pages=512, max_pages_per_seq=64,
                        max_decode_slots=8, pipeline_decode=True, cuda_graphs=False,
                        guided_mode="off", dp=2)
    prompts = make_prompts(spec.vocab_size)
    children: list[Child] = []
    try:
        hub_proc = Child("hub", "--port", "0")
        children.append(hub_proc)
        hub = hub_proc.wait_line("DYNAMO_HUB=", 60).split("=", 1)[1]
        worker = Child("worker", "--hub", hub, "--device", "cuda:0", "--spec-json",
                       json.dumps(dataclasses.asdict(spec)), "--engine-config-json",
                       config_json(ecfg), env={"DYN_TP_BACKEND": "gloo"})
        children.append(worker)
        worker.wait_line("ENGINE_READY", PROC_START_S)
        if not worker.logged("MULTIHOST_FOLLOWER_READY"):
            worker.wait_line("MULTIHOST_FOLLOWER_READY", PROC_START_S)
        res, wall = asyncio.run(_mirror_serve(hub, prompts))
        require(all(len(t) == SERVE_TOKENS for t in res["tokens"].values()),
                f"dp worker: streams {res['tokens']}")
        fd = json.loads(worker.wait_line("SPMD_KV_DIGEST ", 120).split(" ", 1)[1])
        ld = res["digest"]
        require(all(fd[k] == ld[k] for k in ("pages", "tp_rank", "k", "v"))
                and ld["pages"] > 0, f"dp worker: digests {ld} {fd}")
        for child in (worker, hub_proc):
            require(child.stop() == 0, f"{child.name} exited non-zero: {child.seen[-8:]}")
        logs = json.loads(worker.logged("ENGINE_LAUNCHES ").split(" ", 1)[1])
    finally:
        for child in children:
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait(30)
    fused, steps = logs["launches"].get("fused_decode_attention", 0), logs["steps"]
    require(fused == spec.num_layers * steps, f"dp worker: fused_decode {fused} over "
            f"{steps} steps")
    n_tok = sum(len(t) for t in res["tokens"].values())
    print(f"phase 24 (e) [{card}]: cli worker with EngineConfig dp=2 ({spec.name}, gloo, "
          f"both replicas on cuda:0, the replica started by the worker): {n_tok} tokens "
          f"over TCP in {wall:.2f} s (NOT a dp timing), rank 0 fused_decode {fused} "
          f"({spec.num_layers} x {steps} steps); the replicas' pools bitwise equal over "
          f"{ld['pages']} pages (kv_digest); {time.perf_counter() - t0:.1f} s")
    return fused


def pp_sp_phase(cfg, prompts, card, flush) -> tuple[dict, dict[str, int]]:
    """Phase 24: pipeline, sequence and data parallelism on the card (see
    the module docstring). Returns the kernel rows at (a)'s stage shape and
    the phase's launches by row."""
    import dataclasses
    import gc

    from dynamo_tpu_torch.engine.config import ModelSpec
    from dynamo_tpu_torch.models import llama

    t24 = time.perf_counter()
    rows = pp_kernel_rows(flush, card)
    spec8 = dataclasses.replace(ModelSpec.llama3_8b(), num_layers=SP_LAYERS,
                                name=f"llama-3-8b[{SP_LAYERS} layers]")
    specpp = dataclasses.replace(spec8, num_layers=PP8_LAYERS,
                                 name=f"llama-3-8b[{PP8_LAYERS} layers]")
    spec70 = dataclasses.replace(ModelSpec.llama3_70b(), num_layers=PP70_LAYERS,
                                 name=f"llama-3-70b[{PP70_LAYERS} layers]")
    long_prompt = np.random.default_rng(SP_SEED).integers(
        3, spec8.vocab_size, SP_PROMPT).tolist()
    # the one-rank references first, their results on the host or kept
    params70 = llama.init_params(spec70, 0, device=DEVICE)
    ref70 = pp_reference(spec70, params70, prompts, PP70_STEPS)
    del params70
    gc.collect()
    torch.cuda.empty_cache()
    paramspp = llama.init_params(specpp, 0, device=DEVICE)
    refpp = pp_reference(specpp, paramspp, prompts, PP_STEPS)
    del paramspp
    gc.collect()
    torch.cuda.empty_cache()
    params8 = llama.init_params(spec8, 0, device=DEVICE)
    engines = {}
    for kv in ("bf16", "fp8"):
        engine = new_engine(spec8, dict(SP_CFG, kv_dtype=kv), f"phase 24 (d) one rank {kv}",
                            params=params8)
        out = serve_phases(engine, [
            ("long", lambda e: requests(e, [make_request(long_prompt)])),
            ("default", lambda e: serve(e, prompts))])
        engines[kv] = (engine, {i: [t for x in items for t in x["token_ids"]]
                                for i, items in out["default"]["res"][0].items()},
                       [t for x in out["long"]["res"][0][0] for t in x["token_ids"]])
        if kv == "fp8":
            drop_engine(engine)
    logits = tp_prefill_logits(spec8, params8, long_prompt, DEVICE)
    print(f"phase 24: kernel rows and one-rank references done in "
          f"{time.perf_counter() - t24:.1f} s; "
          f"this process holds {_allocated(torch.device(DEVICE)) / 1e9:.3f} GB")
    job = {"spec8": dataclasses.asdict(spec8), "specpp": dataclasses.asdict(specpp),
           "spec70": dataclasses.asdict(spec70),
           "prompts": prompts, "long": long_prompt, "device": DEVICE}
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        t0 = time.perf_counter()
        ranks = run_ranks(4, pp_sp_rank, job)
        print(f"phase 24 (a)-(d): 4 gloo ranks on this card, {time.perf_counter() - t0:.1f} s")
    finally:
        if conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    try:
        a = pp_check(specpp, refpp, [r["a"] for r in ranks], dict(pp=2, tp=2),
                     f"phase 24 (a) llama-3-8b (full width, cut to {PP8_LAYERS} layers) "
                     "pp=2 x tp=2 gloo", card)
        b = pp_check(specpp, refpp, [r["b"] for r in ranks], dict(pp=2, dp=2),
                     f"phase 24 (b) llama-3-8b ({PP8_LAYERS} layers) pp=2 x dp=2 gloo", card)
        for s in range(2):  # each stage's two dp replicas
            pair = [r["b"] for r in ranks if r["b"]["coords"]["pp"] == s]
            require(len(pair) == 2 and pair[0]["digest"] == pair[1]["digest"],
                    f"phase 24 (b): stage {s}'s dp replicas hold other pools")
        print("phase 24 (b): each stage's dp replicas' pools bitwise equal (sha256 of "
              "every page but trash page 0)")
        c = pp_check(spec70, ref70, [r["c"] for r in ranks], dict(pp=4),
                     f"phase 24 (c) llama-3-70b (d 8192, 64/8 heads, FFN 28672, vocab "
                     f"128256; cut to {PP70_LAYERS} layers) pp=4 gloo", card)
        d = sp_check(spec8, prompts, long_prompt, (params8, logits, engines),
                     [r["d"] for r in ranks],
                     f"phase 24 (d) llama-3-8b (full width, cut to {SP_LAYERS} layers) sp=2 x "
                     "tp=2 gloo engine", card)
    finally:
        drop_engine(engines["bf16"][0])
        del params8, engines
        gc.collect()
        torch.cuda.empty_cache()
    e = dp_worker_phase(card)
    kw = a["kv_write"] + b["kv_write"] + c["kv_write"]
    v3 = a["paged_attention_v3"] + b["paged_attention_v3"] + c["paged_attention_v3"]
    print(f"phase 24: {time.perf_counter() - t24:.1f} s, kv_write / paged_attention_v3 "
          f"launches (a) {a['kv_write']} / {a['paged_attention_v3']} (b) {b['kv_write']} / "
          f"{b['paged_attention_v3']} (c) {c['kv_write']} / {c['paged_attention_v3']}, "
          f"fused_decode (d) {d} (e, rank 0) {e}")
    return rows, {"kv_write/pp": kw, "paged_attention_v3/pp": v3, "fused_decode/tp2": d,
                  "fused_decode": e}


# ------------------------------- disaggregation under tp and the gateway

P25_EXTRA = 2  # fresh prompts served after the mirror's rejoin
P25_B = (2, 3)  # phase 4's prompts served by (b)'s one-rank decode worker
P25_F_TOKENS = 960  # (f)'s prompt: 60 pages, under max context with its 32 tokens
EPP_PICKS = 200  # picks per transport for (e)'s p50 / p99
EMB25_TOL = 5e-2  # (c): max |diff| / max |value| of the tp=2 vector vs one rank's


def page_hashes(k, v) -> list[str]:
    """sha256 of each page's k and v bytes of blocks ``[L, n, ...]``."""
    import hashlib

    from dynamo_tpu_torch.kvbm.offload import block_numpy

    kb, vb = (block_numpy(b.detach().contiguous().cpu()) if isinstance(b, torch.Tensor)
              else np.asarray(b) for b in (k, v))
    return [hashlib.sha256(np.ascontiguousarray(kb[:, j]).tobytes()
                           + np.ascontiguousarray(vb[:, j]).tobytes()).hexdigest()
            for j in range(kb.shape[1])]


def p25_record(engine, out: dict) -> None:
    """Wrap a rank's engine: keep every export's blocks by transfer id and
    every install's tail blocks in order (references only: nothing is
    copied or hashed inside the spans that time ``kv_export`` and
    ``kv_resume``; ``p25_hashes`` hashes them after the serve), each
    resume's mode, transfer id and first page, every pulled transfer id,
    every kv_digest's pages."""
    out.update(exports={}, installs=[], modes=[], digests=[], pulled=[])
    held = engine.p25_held = {"exports": {}, "installs": []}
    export, insert = engine.export_pages, engine._insert_blocks
    install, digest = engine.install_remote, engine.pool_digest
    stage = engine._stage_pull

    def export_pages(pages, num_tokens, transfer_id=None):
        res = export(pages, num_tokens, transfer_id=transfer_id)
        held["exports"][res[0]["transfer_id"]] = (res[1], res[2])
        return res

    def insert_blocks(k, v, ready, page_ids, first):
        held["installs"].append((k[:, first:], v[:, first:]))
        return insert(k, v, ready, page_ids, first)

    def stage_pull(kvp, mode):
        out["pulled"].append(kvp["transfer_id"])
        return stage(kvp, mode)

    def install_remote(mode, info, page_ids, first, **kw):
        out["modes"].append((mode, info.get("transfer_id"), first))
        return install(mode, info, page_ids, first, **kw)

    def pool_digest(ids):
        kb, vb = engine.fam.extract_pages(engine.k_pages, engine.v_pages,
                                          torch.tensor(ids, dtype=torch.int64,
                                                       device=engine.device))
        out["digests"].append((list(ids), page_hashes(kb, vb)))
        return digest(ids)

    engine.export_pages, engine._insert_blocks = export_pages, insert_blocks
    engine.install_remote, engine.pool_digest = install_remote, pool_digest
    engine._stage_pull = stage_pull


def p25_hashes(engine, out: dict, split: int = 0) -> None:
    """The page hashes of what ``p25_record`` kept, into ``out`` (with
    ``split``, each install's as ``split`` KV-head shards), after the
    serve: the installs' streams have finished by then."""
    from dynamo_tpu_torch.disagg.transfer import split_heads

    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    held = engine.p25_held
    kh, packed = engine.spec.num_kv_heads, engine._packed_blocks()
    for tid, (k, v) in held["exports"].items():
        out["exports"][tid] = page_hashes(k, v)
    for k, v in held["installs"]:
        out["installs"].append(
            [page_hashes(split_heads(k, kh, split, r, packed),
                         split_heads(v, kh, split, r, packed)) for r in range(split)]
            if split else page_hashes(k, v))
    held["exports"].clear()
    held["installs"].clear()


async def p25_until(cond, what: str, timeout: float = 300.0) -> None:
    deadline = time.perf_counter() + timeout
    while not cond():
        require(time.perf_counter() < deadline, f"phase 25: no {what} in {timeout} s")
        await asyncio.sleep(0.05)


async def p25_rank_serve(role, rank, n, job, ev) -> dict:
    """One rank of phase 25: ``prefill`` (a tp=2 prefill worker group, its
    leader also serving its mirror group), ``decode`` (a tp=2 decode worker
    group behind its front door) or ``mirror`` (the prefill group's mirror:
    rank 0 follows the prefill leader and relays to rank 1)."""
    from dynamo_tpu_torch.disagg.transfer import PULLS, KvTransferSource
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.engine.worker import XFER_KEY_FMT, launch_engine_worker
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.parallel.mesh import make_mesh
    from dynamo_tpu_torch.parallel.spmd import SpmdFollower, SpmdLeader, StoreHub
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub_client import RemoteHub

    spec = ModelSpec(**job["spec"])
    mesh = make_mesh(tp=n)
    dev = mesh.device
    params = llama.init_params(spec, 0, device=dev, mesh=mesh)
    cfg = EngineConfig(**job["cfg"], tp=n, cuda_graphs=False)
    comp = "backend" if role == "decode" else "p25"
    group = f"dynamo/{comp}/generate"
    out: dict = {"role": role, "rank": rank}
    hub = job["hub"]
    loop = asyncio.get_running_loop()
    if rank == 0 and role != "mirror":
        drt = DistributedRuntime(await RemoteHub.connect(hub), RuntimeConfig(hub_address=hub))
        leader = await SpmdLeader(StoreHub(), loop, group, strict=True).start()
        kw = dict(component=comp, spec=spec, params=params, engine_config=cfg, device=dev,
                  mesh=mesh, spmd=leader)
        if role == "prefill":
            await leader.advertise(drt.hub)  # its mirror group finds it on the hub
            engine, served = await launch_engine_worker(drt, mode="prefill", **kw)
        else:
            engine, served = await launch_engine_worker(drt, mode="decode",
                                                        always_remote_prefill=True, **kw)
            await engine.frontdoor.wait_for_prefill_pool(timeout=300)
            # the engine's own surface: phase 25 (c)'s embedding request
            await drt.namespace("dynamo").component("p25raw").endpoint("generate").serve(
                engine.generate)
        p25_record(engine, out)
        out["instance"] = served.instance.instance_id
        zero_counts()
        steps0, stats0 = engine.steps, dict(mesh.stats)
        print(f"P25_READY {role}", flush=True)
        if role == "prefill":
            await p25_until(lambda: leader.followers == 2, "mirror follower")
            ev["ready"].set()
            await asyncio.to_thread(ev["digest1"].wait, 600)
            await engine.kv_digest()
            await p25_until(lambda: leader.syncs_served == 1, "mirror rejoin")
            ev["rejoined"].set()
            await asyncio.to_thread(ev["digest2"].wait, 600)
            await engine.kv_digest()
        await asyncio.to_thread(ev["done"].wait, 900)
        p25_hashes(engine, out)
        out.update(counts=read_counts(), steps=engine.steps - steps0,
                   coll={k: mesh.stats[k] - stats0[k] for k in stats0},
                   fallbacks=engine.disagg_fallbacks, pulls=PULLS.snapshot(),
                   export_ms=[ms for _t, ms, _b in engine.export_times],
                   resume_ms=[list(r) for r in engine.resume_times],
                   publish=[leader.publish_count, leader.publish_bytes, leader.publish_secs])
        await engine.close()
        await drt.close()
        return out
    src = rhub = relay = None
    if role == "prefill":
        src = await KvTransferSource().start()
        await StoreHub().put(XFER_KEY_FMT.format(group=group, rank=rank),
                             json.dumps({"addr": f"{src.host}:{src.port}", "uid": src.uid}))
    engine = InferenceEngine(spec, cfg, params=params, device=dev, mesh=mesh,
                             transfer_source=src)
    p25_record(engine, out)
    zero_counts()
    if role == "mirror" and rank == 0:
        rhub = await RemoteHub.connect(hub)
        relay = await SpmdLeader(StoreHub(), loop, group, strict=True).start()
        f = SpmdFollower(rhub, group, engine, rejoin=True, relay=relay)
        real, seen = f.apply, []

        def apply(op, sc, ar):
            real(op, sc, ar)
            if op == "kv_digest" and not seen:
                seen.append(op)
                # this mirror rank loses its stream: it rejoins through the
                # leader's sync, its rank 1 through the relayed snapshot
                raise ConnectionError("phase 25 (d): stream dropped")

        f.apply = apply
    else:
        f = SpmdFollower(StoreHub(), group, engine, rejoin=False)
        real_apply, out["replay_resume_ms"] = f.apply, []

        def apply(op, sc, ar):
            t0 = time.perf_counter()
            real_apply(op, sc, ar)
            if op == "kv_resume":
                out["replay_resume_ms"].append((sc["mode"],
                                                1e3 * (time.perf_counter() - t0)))

        f.apply = apply
    await f.run()
    if relay is not None:
        relay.stop()
        await relay.close()
    if rhub is not None:
        await rhub.close()
    p25_hashes(engine, out)
    out.update(counts=read_counts(), ops=dict(f.ops), op_secs=dict(f.op_secs),
               rejoins=f.rejoins, pulls=PULLS.snapshot(),
               prefetch_wait_ms=1e3 * engine.prefetch_wait_secs)
    await engine.close()
    if src is not None:
        await src.close()
    return out


def p25_rank(role, rank, n, port, job, q, ev):
    """A spawned rank of phase 25: join its group's gloo world on this card,
    run ``p25_rank_serve``, put its result (or the traceback) on ``q``."""
    import traceback

    try:
        sys.path.insert(0, str(ROOT))
        from dynamo_tpu_torch.ops.cuda import build
        from dynamo_tpu_torch.parallel.multihost import initialize_multihost, shutdown

        if torch.cuda.is_available():
            build.load_library()  # built by the parent
        initialize_multihost(f"127.0.0.1:{port}", n, rank, device=job["device"],
                             backend="gloo", timeout_s=TP_TIMEOUT_S)
        try:
            q.put(((role, rank), asyncio.run(p25_rank_serve(role, rank, n, job, ev))))
        finally:
            shutdown()
    except BaseException:  # noqa: BLE001 - reported to the parent
        q.put(((role, rank), {"error": traceback.format_exc()}))
    finally:
        q.close()
        q.join_thread()


async def http_picker(host: str, port: int):
    """A keep-alive HTTP/1.1 client of ``POST /pick`` (the standard
    library's streams): pick(body) -> (status, payload, headers)."""
    reader, writer = await asyncio.open_connection(host, port)

    async def pick(body):
        data = json.dumps(body).encode()
        writer.write(f"POST /pick HTTP/1.1\r\nHost: {host}\r\nContent-Type: "
                     f"application/json\r\nContent-Length: {len(data)}\r\n\r\n".encode()
                     + data)
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        headers = {}
        while (line := await reader.readline()) not in (b"\r\n", b""):
            k, v = line.decode().split(":", 1)
            headers[k.strip().lower()] = v.strip()
        return status, json.loads(await reader.readexactly(int(headers["content-length"]))), \
            headers

    return pick, writer


async def p25_drive(spec, cfg, prompts, params, ev, start_ranks, collect_ranks) -> dict:
    """This process's side of phase 25: the hub, a one-rank decode worker
    ((b)), the requests, the embedding and the EPP. Returns the record."""
    from dynamo_tpu_torch.disagg.transfer import PULLS, KvTransferSource, split_heads
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.core import InferenceEngine
    from dynamo_tpu_torch.engine.worker import launch_engine_worker
    from dynamo_tpu_torch.gateway.epp import EndpointPicker
    from dynamo_tpu_torch.gateway.pickline import PickLineClient
    from dynamo_tpu_torch.kv_router.protocols import RouterConfig
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub_client import RemoteHub
    from dynamo_tpu_torch.runtime.hub_server import HubServer
    from dynamo_tpu_torch.runtime.push import PushRouter, RouterMode

    rec: dict = {}
    server = HubServer()
    host, port = await server.start()
    hub = f"{host}:{port}"
    start_ranks(hub)
    drt = DistributedRuntime(await RemoteHub.connect(hub), RuntimeConfig(hub_address=hub))
    epp = None
    try:
        engine, served = await launch_engine_worker(
            drt, spec=spec, params=params, engine_config=EngineConfig(**cfg, cuda_graphs=False),
            device=DEVICE, mode="decode", always_remote_prefill=True)
        p25_record(engine, rec)
        rec["instance1"] = served.instance.instance_id
        router = await PushRouter.from_endpoint(
            drt.namespace("dynamo").component("backend").endpoint("generate"),
            RouterMode.ROUND_ROBIN)
        await router.client.wait_for_instances(2, timeout=600)
        await engine.frontdoor.wait_for_prefill_pool(timeout=600)
        await asyncio.to_thread(ev["ready"].wait, 600)
        dec = next(i for i in router.client.instance_ids() if i != rec["instance1"])
        rec["instance_tp2"] = dec
        zero_counts()
        steps0 = engine.steps

        async def one(p, target=None, sink=None):
            t0 = time.perf_counter()
            toks, ttft = [], None
            agen = (router.generate(make_request(p), Context(), instance_id=target)
                    if target is not None else engine.frontdoor.generate(make_request(p),
                                                                          Context()))
            async for item in agen:
                require(item.get("finish_reason") != "error", f"phase 25: {item}")
                if item.get("token_ids") and ttft is None:
                    ttft = time.perf_counter() - t0
                toks += item.get("token_ids") or []
            if sink is not None:
                sink.append(ttft)
            return toks

        # (a) phase 4's prompts through the tp=2 decode group's front door;
        # the second sharer arrives once the first one has its first token
        ttfts: list = []
        t0 = time.perf_counter()
        first = asyncio.ensure_future(one(prompts[0], dec, ttfts))
        while not ttfts:
            await asyncio.sleep(0.01)
        rest = [asyncio.ensure_future(one(p, dec, ttfts)) for p in prompts[1:]]
        rec["a_tokens"] = {0: await first, **{i + 1: await t for i, t in enumerate(rest)}}
        rec["a_wall"], rec["a_ttft"] = time.perf_counter() - t0, ttfts
        # (b) two of them through this process's one-rank decode worker: the
        # export of a tp=2 group pulled whole over TCP
        PULLS.reset()
        rec["b_tokens"] = {i: await one(prompts[i]) for i in P25_B}
        # and one only this worker serves: (e)'s warm prompt for it
        b_warm = np.random.default_rng(26).integers(3, spec.vocab_size, 320).tolist()
        await one(b_warm)
        rec["b_pulls"] = PULLS.snapshot()
        rec["counts"], rec["steps"] = read_counts(), engine.steps - steps0
        rec["b_fallbacks"] = engine.disagg_fallbacks
        # (d) the mirror group: a digest, its rank 0's lost stream and
        # rejoin, fresh prompts, a digest
        ev["digest1"].set()
        await asyncio.to_thread(ev["rejoined"].wait, 600)
        rng = np.random.default_rng(25)
        extra = [rng.integers(3, spec.vocab_size, 200 + 40 * i).tolist()
                 for i in range(P25_EXTRA)]
        rec["extra_tokens"] = [await one(p, dec) for p in extra]
        ev["digest2"].set()
        raw = await PushRouter.from_endpoint(
            drt.namespace("dynamo").component("p25raw").endpoint("generate"),
            RouterMode.ROUND_ROBIN)
        await raw.client.wait_for_instances(1, timeout=60)

        async def stream(agen):
            toks = []
            async for item in agen:
                require(item.get("finish_reason") != "error", f"phase 25: {item}")
                toks += item.get("token_ids") or []
            return toks

        # (f) a one-rank export of a long prompt resumed by the tp=2 decode
        # group: its leader pulls the whole blocks and sends rank 1 its
        # heads over the group (mode scatter)
        src1 = await KvTransferSource().start()
        pre1 = InferenceEngine(spec, EngineConfig(**cfg, cuda_graphs=False), params=params,
                               device=DEVICE, transfer_source=src1)
        pre1_rec: dict = {}
        p25_record(pre1, pre1_rec)
        long = rng.integers(3, spec.vocab_size, P25_F_TOKENS).tolist()
        try:
            r = make_request(long, n=1, disagg={
                "mode": "prefill", "kv_transfer": {"do_remote_decode": True}})
            (item,) = [i async for i in pre1.generate(r, Context())]
            kvp, first_tok = item["kv_transfer_params"], item["token_ids"][0]
            rec["f_tid"], rec["f_long"] = kvp["transfer_id"], long
            k, v = pre1.p25_held["exports"][kvp["transfer_id"]]
            rec["f_bytes"] = k.nbytes + v.nbytes
            kh = spec.num_kv_heads
            rec["f_export"] = [page_hashes(split_heads(k, kh, 2, r, False),
                                           split_heads(v, kh, 2, r, False)) for r in range(2)]
            resume = make_request(long, disagg={
                "mode": "decode", "kv_transfer": {**kvp, "first_token": first_tok}})
            rec["f_tokens"] = [first_tok] + await stream(raw.generate(resume, Context()))
            rec["f_want"] = await stream(pre1.generate(make_request(long), Context()))
        finally:
            await pre1.close()
            await src1.close()
        # (c) an embedding request on the tp=2 group (op embed), and one rank's
        t0 = time.perf_counter()
        items = [i async for i in raw.generate({"token_ids": prompts[0],
                                                "embedding_request": True}, Context())]
        rec["embed_ms"] = 1e3 * (time.perf_counter() - t0)
        rec["embed"] = items[-1]["embedding"]
        rec["embed1"] = engine._embed(prompts[0])
        await raw.client.close()
        # (e) the EPP in front of both decode workers
        epp = await EndpointPicker(drt, namespace="dynamo", target_component="backend",
                                   config=RouterConfig(block_size=cfg["page_size"]),
                                   host="127.0.0.1", port=0, pick_port=0).start()
        pick, writer = await http_picker("127.0.0.1", epp.port)
        warm = {"phase 4 prompt 0": (prompts[0], dec),
                "(b)'s own prompt": (b_warm, rec["instance1"])}
        got = {}
        deadline = time.perf_counter() + 60
        while len(got) < len(warm):
            require(time.perf_counter() < deadline, f"phase 25 (e): picks {got}")
            for i, (p, _t) in warm.items():
                status, body, headers = await pick({"token_ids": p})
                if status == 200 and body["overlap_blocks"] > 0:
                    got[i] = (body, headers)
            await asyncio.sleep(0.05)
        rec["picks"] = {i: (b["worker_id"], b["overlap_blocks"], b["endpoint"],
                            h.get("x-gateway-destination-endpoint")) for i, (b, h) in got.items()}
        rec["warm"] = {i: t for i, (_p, t) in warm.items()}
        line = await PickLineClient("127.0.0.1", epp.pick_port).connect()
        rec["pickline"] = {}
        for i, (p, _t) in warm.items():
            r = await line.pick({"token_ids": p})
            rec["pickline"][i] = (r["worker_id"], r["overlap_blocks"], r["endpoint"])
        times = {"http": [], "pickline": []}
        for k in range(EPP_PICKS):
            p = prompts[k % len(prompts)]
            t0 = time.perf_counter()
            await pick({"token_ids": p})
            times["http"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            await line.pick({"token_ids": p})
            times["pickline"].append(time.perf_counter() - t0)
        rec["pick_us"] = {k: (1e6 * float(np.percentile(v, 50)), 1e6 * float(np.percentile(v, 99)))
                          for k, v in times.items()}
        await line.close()
        writer.close()
        await router.client.close()
        p25_hashes(engine, rec, split=2)
        await engine.close()
    finally:
        ev["digest1"].set()
        ev["digest2"].set()
        ev["done"].set()
        if epp is not None:
            await epp.close()
        try:
            # the ranks withdraw from the hub as they close: it stays up
            rec["ranks"] = await asyncio.to_thread(collect_ranks)
        finally:
            await drt.close()
            await server.stop()
    return rec


def disagg_tp_phase(cfg, prompts, tp2_tokens, card) -> dict[str, int]:
    """Phase 25: disaggregated serving under tensor parallelism and the
    gateway (see the module docstring). Returns the launches by row."""
    import dataclasses
    import gc
    import queue as _queue
    import socket

    import torch.multiprocessing as mp

    from dynamo_tpu_torch.models import llama

    t25 = time.perf_counter()
    spec = tp8_spec()
    L, KH = spec.num_layers, spec.num_kv_heads
    params = llama.init_params(spec, 0, device=DEVICE)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    ev = {k: ctx.Event() for k in ("ready", "digest1", "rejoined", "digest2", "done")}

    procs: list = []

    def start_ranks(hub):
        job = {"spec": dataclasses.asdict(spec), "cfg": dict(cfg), "hub": hub,
               "device": DEVICE}
        for role in ("prefill", "decode", "mirror"):
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            for r in range(2):
                p = ctx.Process(target=p25_rank, args=(role, r, 2, port, job, q, ev))
                p.start()
                procs.append(p)

    def collect_ranks() -> dict:
        ranks: dict = {}
        try:
            deadline = time.perf_counter() + 600
            while len(ranks) < len(procs):
                try:
                    key, res = q.get(timeout=5.0)
                except _queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    require(not dead and time.perf_counter() < deadline,
                            f"phase 25: rank exit codes {[p.exitcode for p in procs]}")
                    continue
                require("error" not in res,
                        f"phase 25 rank {key} failed:\n{res.get('error')}")
                ranks[key] = res
        finally:
            for p in procs:
                p.join(60)
                if p.is_alive():
                    p.kill()
                    p.join(30)
        return ranks

    rec = asyncio.run(p25_drive(spec, cfg, prompts, params, ev, start_ranks, collect_ranks))
    ranks = rec.pop("ranks")
    P = [ranks[("prefill", r)] for r in range(2)]
    D = [ranks[("decode", r)] for r in range(2)]
    M = [ranks[("mirror", r)] for r in range(2)]
    label = f"phase 25 (a) {spec.name} (full width) prefill tp=2 -> decode tp=2 gloo"
    # (a) every resume by shard, each decode rank's pages its twin's export;
    # then (f)'s, by scatter
    shard = [(t, f) for m, t, f in D[0]["modes"] if m == "shard"]
    require(len(shard) == len(prompts) + P25_EXTRA and len(D[0]["modes"]) == len(shard) + 1
            and D[0]["modes"][-1][:2] == ("scatter", rec["f_tid"]),
            f"{label}: resume modes {D[0]['modes']}")
    pages = 0
    for r in range(2):
        require(len(D[r]["installs"]) == len(shard) + 1, f"{label}: rank {r} installs")
        for (tid, first), got in zip(shard, D[r]["installs"]):
            want = P[r]["exports"][tid][first:]
            require(got == want, f"{label}: decode rank {r}'s install of {tid} is not its "
                    f"prefill twin's export (pages from {first})")
            pages += len(got)
    fallbacks = (sum(d["pulls"]["route_fallbacks"] for d in D) + D[0]["fallbacks"]
                 + rec["b_pulls"]["route_fallbacks"] + rec["b_fallbacks"])
    require(fallbacks == 0, f"{label}: {fallbacks} route or pull fallbacks")
    device_pulls = [[x for x in d["pulls"]["records"] if x["route"] == "device"] for d in D]
    # the leader's last: (f)'s whole pull of a one-rank export
    f_pull = device_pulls[0].pop() if DEVICE == "cuda" and device_pulls[0] else None
    device_pulls = device_pulls[0] + device_pulls[1]
    require(DEVICE != "cuda" or len(device_pulls) == 2 * len(shard),
            f"{label}: {len(device_pulls)} CUDA IPC shard pulls for {len(shard)} resumes x 2 "
            f"ranks")
    steps = D[0]["steps"]
    for r in range(2):
        c = D[r]["counts"]
        require(DEVICE != "cuda" or (c["fused_decode"] == L * steps and c["kv_write"] == 0
                                     and c["paged_attention_v3"] == 0),
                f"{label}: decode rank {r} launches {c} over {steps} steps")
    same_all, parts = 0, []
    for i, want in tp2_tokens.items():
        got = rec["a_tokens"][i]
        require(len(got) == SERVE_TOKENS, f"{label}: request {i} {len(got)} tokens")
        if got != want:
            same, tie = equal_to_first_near_tie(spec, params, prompts[i], got, want)
            require(same >= tie, f"{label}: request {i} parts from the aggregated tp=2 "
                    f"group at {same} before its first near-tie at {tie}")
            parts.append((i, same, tie))
        else:
            same_all += 1
    print(f"{label}: {len(shard)} resumes, every one by shard: each decode rank pulled its "
          f"prefill twin's KV heads itself and installed {pages // 2} pages bitwise equal to "
          f"its export (sha256 per page); 0 route and pull fallbacks; fused_decode "
          f"{D[0]['counts']['fused_decode']} / {D[1]['counts']['fused_decode']} per rank "
          f"({L} x {steps} steps); {same_all} of {len(tp2_tokens)} streams equal to phase 22 "
          f"(a)'s aggregated tp=2 group, the others part at or after a near-tie {parts}")
    gb = [(x["bytes"] / 1e9, x["total"]) for x in device_pulls]
    split = {k: sum(x.get(k, 0.0) for x in device_pulls) / max(len(device_pulls), 1)
             for k in ("control", "open", "copy")}
    exp_ms = P[0]["export_ms"]
    p1 = P[1]["op_secs"].get("kv_export", 0.0), P[1]["ops"].get("kv_export", 0)
    res_ms = [x[0] for x in D[0]["resume_ms"][:len(shard)]]
    res_install = [x[2]["install"] for x in D[0]["resume_ms"][:len(shard)]]
    d1 = [ms for m, ms in D[1]["replay_resume_ms"] if m == "shard"]
    if gb:
        print(f"{label} [{card}]: per-shard CUDA IPC pulls ({len(gb)}): mean "
              f"{sum(t for _b, t in gb) / len(gb):.2f} ms, "
              f"{sum(b for b, _t in gb) / max(sum(t for _b, t in gb) / 1e3, 1e-9):.2f} GB/s "
              f"over {sum(b for b, _t in gb):.3f} GB (control {split['control']:.2f}, handle "
              f"opens {split['open']:.2f}, copy {split['copy']:.2f} ms each); the step "
              f"thread's kv_export "
              f"{sum(exp_ms) / max(len(exp_ms), 1):.2f} ms (leader) / "
              f"{1e3 * p1[0] / max(p1[1], 1):.2f} ms (rank 1), kv_resume "
              f"{sum(res_ms) / max(len(res_ms), 1):.2f} ms (leader; its install with the "
              f"ok-flag all-reduce {sum(res_install) / max(len(res_install), 1):.2f} ms) / "
              f"{sum(d1) / max(len(d1), 1):.2f} ms (rank 1: its shard pulled at the leader's "
              f"intake, op kv_prefetch; of it, waiting for that pull "
              f"{D[1]['prefetch_wait_ms'] / max(len(d1), 1):.2f} ms); serve "
              f"{sum(len(t) for t in rec['a_tokens'].values())} tokens in "
              f"{rec['a_wall']:.2f} s, TTFT mean "
              f"{1e3 * sum(rec['a_ttft']) / len(rec['a_ttft']):.1f} ms (NOT tp timings: "
              f"6 processes time-slice one card)")
    # (b) the one-rank decode worker's whole pull: the two shards joined
    lb = f"phase 25 (b) {spec.name} prefill tp=2 -> decode tp=1 over TCP"
    tcp = [x for x in rec["b_pulls"]["records"] if x["route"] == "tcp"]
    require(not rec["modes"] and len(tcp) == len(P25_B) + 1 == len(rec["installs"])
            == len(rec["pulled"]), f"{lb}: modes {rec['modes']}, pulls {tcp}")
    for tid, split in zip(rec["pulled"], rec["installs"]):
        n, m = len(P[0]["exports"][tid]), len(split[0])
        for r in range(2):
            require(split[r] == P[r]["exports"][tid][n - m:],
                    f"{lb}: the whole blocks' KV heads of rank {r} are not its export")
    for i in P25_B:
        got, want = rec["b_tokens"][i], tp2_tokens[i]
        if got != want:
            same, tie = equal_to_first_near_tie(spec, params, prompts[i], got, want)
            require(same >= tie, f"{lb}: request {i} parts at {same} before a near-tie "
                    f"at {tie}")
    gbs = sum(x["bytes"] for x in tcp) / 1e9
    ms = sum(x["total"] for x in tcp)
    print(f"{lb} [{card}]: {len(tcp)} whole pulls (the prefill leader joins both shards on "
          f"the heads axis under one checksum): the installed blocks bitwise equal to the two "
          f"shards joined (sha256 per page and KV-head shard); mean {ms / len(tcp):.2f} ms, "
          f"{gbs / max(ms / 1e3, 1e-9):.3f} GB/s over {gbs:.3f} GB (control "
          f"{sum(x['control'] for x in tcp) / len(tcp):.2f}, body "
          f"{sum(x['copy'] for x in tcp) / len(tcp):.2f}, checksum "
          f"{sum(x['checksum'] for x in tcp) / len(tcp):.2f} ms each)")
    # (f) a one-rank export scattered over the tp=2 decode group
    lf = f"phase 25 (f) {spec.name} prefill tp=1 -> decode tp=2, mode scatter"
    for r in range(2):
        got, want = D[r]["installs"][-1], rec["f_export"][r]
        require(len(got) > 0 and got == want[len(want) - len(got):],
                f"{lf}: decode rank {r}'s install is not its heads of the export")
    got, want = rec["f_tokens"], rec["f_want"]
    require(len(got) == len(want) == SERVE_TOKENS, f"{lf}: {len(got)} / {len(want)} tokens")
    same, tie = len(got), None
    if got != want:
        same, tie = equal_to_first_near_tie(spec, params, rec["f_long"], got, want)
        require(same >= tie, f"{lf}: the stream parts from one rank's at {same} before its "
                f"first near-tie at {tie}")
    f_ms, _n, f_split = D[0]["resume_ms"][-1]
    f1 = [ms for m, ms in D[1]["replay_resume_ms"] if m == "scatter"]
    print(f"{lf} [{card}]: {len(D[0]['installs'][-1])} "
          f"pages ({rec['f_bytes'] / 1e6:.1f} MB of KV, {P25_F_TOKENS} tokens) pulled whole "
          f"by the decode leader, rank 1's heads sent over the group (gloo, through host "
          f"memory; no descriptor carries them): each rank's install bitwise its heads of the "
          f"export (sha256 per page); the whole pull "
          f"{f_pull['total'] if f_pull else float('nan'):.2f} ms (CUDA IPC, at intake); the "
          f"step thread's kv_resume {f_ms:.2f} ms (leader, its "
          f"install and send {f_split['install']:.2f} ms) / {f1[-1] if f1 else float('nan'):.2f}"
          f" ms (rank 1); the stream {'equal to' if tie is None else f'equal for {same} tokens, to its first near-tie at {tie}, to'}"
          f" one rank's (NOT tp timings)")
    # (c) the embedding forward on the tp=2 group
    got = torch.tensor(rec["embed"])
    want = torch.tensor(rec["embed1"])
    err = (got - want).abs().max().item() / want.abs().max().item()
    require(got.shape == want.shape and err <= EMB25_TOL,
            f"phase 25 (c): the tp=2 embedding differs by {err:.3e} of the max")
    require(D[1]["ops"].get("embed") == 1, f"phase 25 (c): rank 1 ops {D[1]['ops']}")
    print(f"phase 25 (c) [{card}]: an embedding request on the tp=2 group (op embed on the "
          f"leader's step thread, replayed by rank 1): {got.numel()} values within "
          f"{err:.3e} of one rank's (max |diff| / max |value|, tol {EMB25_TOL}) in "
          f"{rec['embed_ms']:.1f} ms")
    # (d) the mirror group: each rank's pages its twin's, after the serve and
    # after the rejoin
    ld = "phase 25 (d) a mirror of the tp=2 prefill group (2 ranks, rank 0 relaying)"
    require(len(P[0]["digests"]) == 2, f"{ld}: digests {len(P[0]['digests'])}")
    for j, when in enumerate(("the serve", "the rejoin and the next serve")):
        for r in range(2):
            ids, want = P[r]["digests"][j]
            ids2, got = M[r]["digests"][j]
            require(ids == ids2 and got == want and len(ids) > 0,
                    f"{ld}: mirror rank {r}'s pages after {when} are not its twin's")
    require(M[0]["rejoins"] == 1 and M[1]["ops"].get("sync_install", 0) >= 1
            and P[1]["ops"].get("kv_gather", 0) >= 1,
            f"{ld}: rejoins {M[0]['rejoins']}, ops {M[1]['ops']} / {P[1]['ops']}")
    print(f"{ld} [{card}]: each mirror rank's pages bitwise equal to its prefill-group twin's "
          f"after the serve ({len(P[0]['digests'][0][0])} pages) and after its rank 0 lost "
          f"its stream, rejoined (the snapshot gathered both ranks' KV heads: "
          f"{P[1]['ops']['kv_gather']} kv_gather; rank 1 installed its heads from "
          f"{M[1]['ops']['sync_install']} relayed chunks) and the leader served "
          f"{P25_EXTRA} more prompts ({len(P[0]['digests'][1][0])} pages)")
    # (e) the EPP
    le = "phase 25 (e) the EPP in front of the tp=2 and the one-rank decode worker"
    for i, target in rec["warm"].items():
        wid, overlap, endpoint, header = rec["picks"][i]
        require(wid == target and overlap > 0 and header == endpoint,
                f"{le}: prompt {i} picked {rec['picks'][i]}, its prefix is on {target:x}")
        require(rec["pickline"][i] == (wid, overlap, endpoint),
                f"{le}: pickline {rec['pickline'][i]} != HTTP {rec['picks'][i][:3]}")
    (h50, h99), (l50, l99) = rec["pick_us"]["http"], rec["pick_us"]["pickline"]
    print(f"{le} [{card}]: each warm prompt picked to its prefix's worker with the GIE header "
          f"({ {i: v[1] for i, v in rec['picks'].items()} } overlap blocks), the pickline "
          f"pick equal to the HTTP pick; pick latency over {EPP_PICKS} picks each: HTTP p50 "
          f"{h50:.1f} us p99 {h99:.1f} us, pickline p50 {l50:.1f} us p99 {l99:.1f} us")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 25: {time.perf_counter() - t25:.1f} s")
    return {"fused_decode": rec["counts"]["fused_decode"],
            "fused_decode/tp2": sum(d["counts"]["fused_decode"] for d in D)}


# ------------------------------------------------------------ phase 26

SCALE_DIR = ROOT / "build" / "scaling"
SCALE_INTERVAL_S = 2.0  # the planner's --adjustment-interval
# the bursts' output tok/s over one replica's profiled tok/s: two replicas'
# worth (ceil), with room for an interval whose completions bunch; a reading
# above 2 plans 3, which the chip budget (one prefill replica in it) caps at 2
SCALE_LOAD = 1.75
SCALE_GROUP = 2  # requests sent at once: the router tells idle workers apart by load
SCALE_BURST2_INTERVALS = 3  # the second burst's length, in planner intervals
SCALE_BUDGET = 3  # chips: the planner keeps its min-endpoint prefill replica in it
SCALE_SEED = 2626
SCALE_AS_STREAMS = 16  # the autoscaler's burst: 8 slots running, 8 waiting
SCALE_AS_TOKENS = 192


def scaling_profile(p4: dict, path: Path) -> dict:
    """The planner's profile (its npz format) from phase 4's readings on this
    card: the full-depth llama-3-8b's decode tok/s at B 8 as the throughput
    per chip at every context (ITL constant at phase 4's dispatch-to-host
    mean, so any SLA above it selects that reading), its mean TTFT and its
    packed prefill's tokens/s for the prefill side."""
    from dynamo_tpu_torch.planner.interpolation import synthetic_profile

    prof = synthetic_profile(
        base_ttft_s=p4["ttft_s"], ttft_per_token_s=0.0,
        prefill_thpt_per_chip=p4["prefill_tok_s"], base_itl_s=p4["itl_s"],
        itl_per_kv_usage_s=0.0, itl_per_context_s=0.0,
        decode_thpt_at_full_kv=p4["tok_s"], max_kv_tokens=p4["kv_tokens"],
        max_context=p4["max_context"])
    path.mkdir(parents=True, exist_ok=True)
    for name in ("prefill.npz", "decode.npz"):
        np.savez(path / name, **prof)
    return prof


async def scale_stream(port, model, text, n) -> dict:
    """One streamed chat completion through the frontend (stream_call)."""
    return await stream_call(port, "/v1/chat/completions", {
        "model": model, "messages": [{"role": "user", "content": text}]}, n)


async def stream_call(port, path, body, n) -> dict:
    """One streamed completion of ``n`` tokens through the frontend: status,
    the final usage and finish, TTFT (send to the first chunk) and ITL
    (first to last chunk over tokens - 1)."""
    status, body, times = await http_call(port, "POST", path, {
        **body, "max_tokens": n, "ignore_eos": True, "stream": True,
        "stream_options": {"include_usage": True}})
    events = sse_events(body) if status == 200 else []
    usage = next((e["usage"] for e in events if isinstance(e, dict) and e.get("usage")), {})
    finish = [c.get("finish_reason") for e in events if isinstance(e, dict)
              for c in e.get("choices", []) if c.get("finish_reason")]
    tokens = usage.get("completion_tokens", 0)
    return {"ok": status == 200 and events[-1:] == ["[DONE]"] and finish == ["length"]
            and tokens == n, "tokens": tokens, "ttft": times[0] if times else None,
            "itl": (times[-1] - times[0]) / (n - 1) if len(times) > 1 and n > 1 else None,
            "status": status}


async def _scaling_drive(spec, hub_addr, port, op, planner, worker_cmd, prompts,
                         rate) -> dict:
    """Phase 26's traffic and observation, on this process's own loop."""
    from dynamo_tpu_torch.autoscaler import (AutoscaleController, AutoscalerConfig,
                                             FleetTelemetry, K8sBackend)
    from dynamo_tpu_torch.operator.graph import DynamoGraphDeployment, ServiceSpec
    from dynamo_tpu_torch.runtime.hub_client import RemoteHub

    hub = await RemoteHub.connect(hub_addr)
    t0 = time.monotonic()
    clock = lambda: time.monotonic() - t0  # noqa: E731
    out: dict = {"desired": [], "status": [], "instances": {}, "metrics": {},
                 "results": {"burst1": [], "burst2": [], "trickle": [], "autoscale": []}}
    inst = out["instances"]  # instance key -> [put time, delete time]

    async def watch(prefix, fn):
        async for ev in hub.watch_prefix(prefix):
            fn(ev)

    def on_desired(ev):
        if ev.kind == "put":
            v = ev.value
            out["desired"].append((clock(), v["revision"], v["prefill"], v["decode"]))

    def on_status(ev):
        if ev.kind == "put" and "decode" in ev.value["services"]:
            s = ev.value["services"]["decode"]
            if not out["status"] or out["status"][-1][1:] != (s["desired"], s["ready"]):
                out["status"].append((clock(), s["desired"], s["ready"]))

    def on_instance(ev):
        if ev.kind == "put":
            inst.setdefault(ev.key, [clock(), None])
        elif ev.kind == "delete" and ev.key in inst:
            inst[ev.key][1] = clock()

    async def on_metrics():
        async for _s, m in hub.subscribe("kv_metrics.dynamo/backend"):
            w = out["metrics"].setdefault(m["worker_id"], {"running": 0, "step_ms": 0.0,
                                                           "reports": 0})
            w["reports"] += 1
            if m["running_requests"] > 0:
                w["running"] = max(w["running"], m["running_requests"])
                w["step_ms"] = max(w["step_ms"], m["step_time_ms"])
                w.setdefault("busy", []).append(clock())

    def live() -> int:
        return sum(1 for a, d in inst.values() if d is None)

    async def until(cond, what, timeout):
        t = time.monotonic()
        while not cond():
            require(time.monotonic() - t < timeout,
                    f"phase 26: {what} within {timeout} s (desired {out['desired']}, "
                    f"status {out['status']}, instances {inst}, operator "
                    f"{op.seen[-6:]})")
            await asyncio.sleep(0.05)

    tasks = [asyncio.create_task(c) for c in (
        watch("v1/planner/dynamo/desired", on_desired), watch("v1/dgd-status/scale", on_status),
        watch("v1/instances/dynamo/backend/generate/", on_instance), on_metrics())]
    pending: list[asyncio.Task] = []
    rng = np.random.default_rng(SCALE_SEED)

    async def paced(label, per_s, stop, group=1):
        """``group`` requests at a time, ``per_s`` in all, until ``stop()``."""
        i, t = 0, time.monotonic()
        while not stop():
            for _ in range(group):
                p = prompts[int(rng.integers(0, len(prompts)))]
                task = asyncio.create_task(scale_stream(port, spec.name, p, SERVE_TOKENS))
                task.add_done_callback(lambda f, lab=label: out["results"][lab].append(
                    f.result()))
                pending.append(task)
                i += 1
            await asyncio.sleep(max(0.0, t + i / per_s - time.monotonic()))

    try:
        dgd = DynamoGraphDeployment(name="scale", services=[ServiceSpec(
            name="decode", replicas=1, role="decode", command=worker_cmd)])
        await dgd.apply(hub)
        out["t_dgd"] = clock()
        await until(lambda: live() == 1, "the first worker registered", PROC_START_S)
        out["t_first"] = clock()
        while True:  # the frontend has discovered the model's card
            status, body, _ = await http_call(port, "GET", "/v1/models")
            if status == 200 and spec.name in [m["id"] for m in json.loads(body)["data"]]:
                break
            require(clock() - out["t_first"] < 30, f"phase 26: /v1/models {body[:200]}")
            await asyncio.sleep(0.05)
        # the bursts: SCALE_LOAD x one replica's profiled tok/s, in groups
        await paced("burst1", rate, lambda: live() == 2, SCALE_GROUP)
        out["t_burst2"] = clock()
        await paced("burst2", rate, lambda: clock() - out["t_burst2"] >
                    SCALE_BURST2_INTERVALS * SCALE_INTERVAL_S, SCALE_GROUP)
        out["t_trickle"] = clock()
        await paced("trickle", 1.0 / SCALE_INTERVAL_S,
                    lambda: live() == 1 and out["desired"][-1][3] == 1)
        await asyncio.gather(*pending)
        pending.clear()
        out["t_quiet"] = clock()
        await until(lambda: any("decode[1]" in ln and "after SIGTERM" in ln
                                for ln in op.pump()), "the second worker exited", 60)
        out["t_exited"] = clock()
        out["planner_rc"] = await asyncio.to_thread(planner.stop)
        # the load-based autoscaler on the same hub and graph: its signal from
        # the worker's own ForwardPassMetrics, its plan through K8sBackend
        tel = FleetTelemetry(hub, "dynamo/backend", stale_after_s=2.0).start()
        cfg = AutoscalerConfig(slots_per_worker=8, target_occupancy=0.75, min_workers=1,
                               max_workers=2, up_cooldown_s=0.0, tick_interval_s=0.1)
        ctl = AutoscaleController(cfg, tel, K8sBackend(hub, "dynamo", dgd_name="scale"),
                                  initial_workers=1)
        n_before = len(inst)
        out["t_as"] = clock()
        burst = [asyncio.create_task(scale_stream(
            port, spec.name, prompts[i % len(prompts)], SCALE_AS_TOKENS))
            for i in range(SCALE_AS_STREAMS)]
        sigs = []
        while not ctl.plans:
            require(not all(t.done() for t in burst) and clock() - out["t_as"] < 60,
                    f"phase 26: the autoscaler planned nothing (signals {sigs[-5:]})")
            sigs.append(tel.signal())
            await ctl.tick()
            await asyncio.sleep(cfg.tick_interval_s)
        out["as_signal"], out["as_plan"], out["t_as_plan"] = sigs[-1], ctl.plans[0], clock()
        while ctl._converging is not None:
            require(clock() - out["t_as_plan"] < 30, f"phase 26: plan not converged "
                    f"({ctl.report()}, status {out['status'][-3:]})")
            await asyncio.sleep(cfg.tick_interval_s)
            await ctl.tick()
        out["t_as_converged"] = clock()
        out["as_report"] = ctl.report()
        out["results"]["autoscale"] = await asyncio.gather(*burst)
        await until(lambda: live() == 2 and len(inst) == n_before + 1,
                    "the autoscaler's worker registered", PROC_START_S)
        out["t_as_ready"] = clock()
        await tel.close()
    finally:
        for t in pending:
            t.cancel()
        for t in tasks:
            t.cancel()
        await hub.close()
    return out


def scaling_phase(p4: dict, card: str, device: str | None = None, spec=None) -> int:
    """Phase 26: the scaling plane on the card (see the module docstring).
    Returns the workers' fused_decode launches (their ENGINE_LAUNCHES)."""
    import dataclasses
    import gc
    import shutil

    t26 = time.perf_counter()
    spec = spec or tp8_spec()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(SCALE_DIR, ignore_errors=True)
    prof = scaling_profile(p4, SCALE_DIR / "profile")
    rng = np.random.default_rng(SCALE_SEED)
    # chat texts of 64-128 bytes (mock-tokenizer tokens), each opening with
    # its own number so no two share a first KV block (the router would
    # follow the overlap)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    prompts = [f"{i:03d} " + "".join(rng.choice(letters, int(n) - 4))
               for i, n in enumerate(rng.integers(64, 129, 32))]
    children: list[Child] = []
    try:
        hub_proc = Child("hub", "--port", "0")
        children.append(hub_proc)
        hub = hub_proc.wait_line("DYNAMO_HUB=", 60).split("=", 1)[1]
        front = Child("frontend", "--hub", hub, "--port", "0", "--host", "127.0.0.1")
        op = Child("operator", "--hub", hub, "--name", "scale", "--interval", "0.5",
                   "--log-dir", str(SCALE_DIR / "workers"))
        children += [front, op]
        port = int(front.wait_line("DYNAMO_HTTP=", 120).rsplit(":", 1)[1])
        planner = Child("planner", "--hub", hub, "--metrics-url",
                        f"http://127.0.0.1:{port}/metrics", "--load-predictor", "constant",
                        "--no-correction", "--adjustment-interval", str(SCALE_INTERVAL_S),
                        "--min-endpoint", "1", "--max-chip-budget", str(SCALE_BUDGET),
                        "--profile-dir", str(SCALE_DIR / "profile"))
        children.append(planner)
        op.wait_line("OPERATOR_READY", 60)
        planner.wait_line("PLANNER_READY", 60)
        worker_cmd = ["-m", "dynamo_tpu_torch.engine.worker", "--hub", hub, "--spec-json",
                      json.dumps(dataclasses.asdict(spec)), "--page-size", "16",
                      "--num-pages", "512", "--max-pages-per-seq", "64",
                      "--max-decode-slots", "8", "--guided", "off", "--precompile",
                      *(["--device", device] if device else [])]
        rate = SCALE_LOAD * p4["tok_s"] / SERVE_TOKENS
        res = asyncio.run(_scaling_drive(spec, hub, port, op, planner, worker_cmd, prompts,
                                         rate))
        for child in (op, front, hub_proc):
            require(child.stop() == 0, f"{child.name} exited non-zero: {child.seen[-8:]}")
        op.pump()
    finally:
        for child in children:
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait(30)
    return scaling_report(res, prof, spec, p4, op, card, time.perf_counter() - t26)


def _compress(values) -> list:
    out: list = []
    for v in values:
        if not out or v != out[-1]:
            out.append(v)
    return out


def scaling_report(res, prof, spec, p4, op, card, wall) -> int:
    """Phase 26's gates and lines; the workers' fused_decode launches."""
    import statistics

    results = res["results"]
    for label, rs in results.items():
        bad = [r for r in rs if not r["ok"]]
        require(rs and not bad, f"phase 26 {label}: {len(bad)} of {len(rs)} streams "
                f"failed: {bad[:3]}")
    t_as = res["t_as"]
    planner_writes = [d for d in res["desired"] if d[0] < t_as]
    as_writes = [d for d in res["desired"] if d[0] >= t_as]
    require(_compress([1] + [d[3] for d in planner_writes]) == [1, 2, 1]
            and [d[1] for d in planner_writes] == list(range(1, len(planner_writes) + 1)),
            f"phase 26: the planner's desired writes {planner_writes}")
    status = [s for s in res["status"] if s[0] < t_as]
    require(_compress([s[1] for s in status]) == [1, 2, 1]
            and _compress([s[2] for s in status if s[2] > 0]) == [1, 2, 1],
            f"phase 26: the operator's status {status}")
    keys = sorted(res["instances"], key=lambda k: res["instances"][k][0])
    require(len(keys) == 3, f"phase 26: instances {res['instances']}")
    ids = [int(k.rsplit("/", 1)[1], 16) for k in keys]
    m = res["metrics"]
    t_up = next(d[0] for d in planner_writes if d[3] == 2)
    t_down = next(d[0] for d in planner_writes if d[0] > t_up and d[3] == 1)
    for i, wid in enumerate(ids[:2]):
        w = m.get(wid, {})
        require(w.get("running", 0) >= 1 and w.get("step_ms", 0) > 0,
                f"phase 26: worker {i} ({wid:x}) metrics {w}")
    served2 = [t for t in m[ids[1]].get("busy", []) if res["t_burst2"] <= t <= res["t_trickle"]]
    require(served2, f"phase 26: the scaled-up worker ran nothing in the second burst "
            f"({m[ids[1]].get('busy', [])[:8]})")
    # the workers' own kernel counts since their precompile (ENGINE_LAUNCHES
    # at each SIGTERM drain): decode-1.log holds the planner's replica,
    # then the autoscaler's
    launches = []
    for log in sorted((SCALE_DIR / "workers").glob("decode-*.log")):
        text = log.read_text()
        for ln in text.splitlines():
            if ln.startswith("ENGINE_LAUNCHES "):
                d = json.loads(ln.split(" ", 1)[1])
                launches.append((log.name, d["launches"].get("fused_decode_attention", 0),
                                 d["steps"]))
        require(text.count("ENGINE_DRAINED leftover=0") == text.count("ENGINE_LAUNCHES "),
                f"phase 26: {log.name} did not drain clean: {text[-400:]}")
    require(len(launches) == 3, f"phase 26: ENGINE_LAUNCHES lines {launches}")
    for name, fused, steps in launches:
        require(DEVICE != "cuda" or fused == spec.num_layers * steps,
                f"phase 26: {name}: fused_decode {fused} over {steps} steps")
    require(DEVICE != "cuda" or (launches[0][1] > 0 and launches[1][1] > 0),
            f"phase 26: a planner-scaled worker launched no fused_decode: {launches}")
    exit_s = [float(re.search(r"exited rc=0 ([0-9.]+) s after SIGTERM", ln).group(1))
              for ln in op.seen if "decode[1]" in ln and "exited rc=0" in ln]
    require(exit_s, f"phase 26: no clean exit of decode[1] in {op.seen[-10:]}")
    withdraw = res["instances"][keys[1]][1]
    sig, plan, rep = res["as_signal"], res["as_plan"], res["as_report"]
    require(sig.workers_observed >= 1 and sig.demand >= 7 and plan.workers == 2
            and not rep["unconverged"] and [d[3] for d in as_writes] == [2],
            f"phase 26: autoscaler signal {sig}, plan {plan}, report {rep}, "
            f"writes {as_writes}")

    def lat(label):
        rs = results[label]
        tt = [r["ttft"] for r in rs]
        it = [r["itl"] for r in rs if r["itl"] is not None]
        return (f"{len(rs)} streams, TTFT mean {1e3 * statistics.fmean(tt):.1f} ms, max "
                f"{1e3 * max(tt):.1f}, ITL mean {1e3 * statistics.fmean(it):.2f} ms")

    thpt = float(prof["decode_thpt_per_chip"].max())
    print(f"phase 26 [{card}]: scaling plane ({spec.name} workers started by the operator, "
          f"each on this card); profile from phase 4 ({p4['tok_s']:.1f} tok/s per chip at B 8, "
          f"ITL {1e3 * p4['itl_s']:.2f} ms, TTFT {1e3 * p4['ttft_s']:.1f} ms, prefill "
          f"{p4['prefill_tok_s']:.0f} tok/s): one replica {thpt:.1f} tok/s; bursts of "
          f"{SCALE_GROUP} x {SERVE_TOKENS}-token streams at {SCALE_LOAD} x that "
          f"({SCALE_LOAD * thpt / SERVE_TOKENS:.2f} requests/s); planner interval "
          f"{SCALE_INTERVAL_S} s, chip budget {SCALE_BUDGET} (1 prefill + 2 decode)")
    gaps = [round(b[0] - a[0], 3) for a, b in zip(planner_writes, planner_writes[1:])]
    print("phase 26 planner decisions (s since the DGD, revision, prefill, decode): "
          + ", ".join(f"({t - res['t_dgd']:.2f}, r{r}, {p}, {d})"
                      for t, r, p, d in planner_writes) + f"; intervals {gaps} s")
    st_up = next(s[0] for s in status if s[2] == 2)
    print(f"phase 26 scale-up: first worker ready {res['t_first'] - res['t_dgd']:.2f} s "
          f"after the DGD; desired decode 2 at {t_up - res['t_dgd']:.2f} s; the second "
          f"worker registered {res['instances'][keys[1]][0] - t_up:.2f} s after it "
          f"(spawn, weights, graphs on the card), status ready 2 after "
          f"{st_up - t_up:.2f} s")
    print(f"phase 26 scale-down: desired decode 1 at {t_down - res['t_dgd']:.2f} s; the "
          f"second worker withdrew {withdraw - t_down:.2f} s after it and exited rc 0 "
          f"{exit_s[0]:.2f} s after its SIGTERM (drain)")
    for i, wid in enumerate(ids):
        w = m.get(wid, {})
        print(f"phase 26 worker {i} ({wid:x}): peak running requests {w.get('running')}, "
              f"max step {w.get('step_ms', 0):.2f} ms ({w.get('reports', 0)} "
              f"ForwardPassMetrics reports)")
    print("phase 26 workers' fused_decode launches (ENGINE_LAUNCHES): " + ", ".join(
        f"{n} {f} = {spec.num_layers} x {s} steps" for n, f, s in launches))
    for label in ("burst1", "burst2", "trickle", "autoscale"):
        print(f"phase 26 {label}: {lat(label)}")
    print("phase 26: two workers time-slice one card (no MPS): these lines show the "
          "path, not a capacity gain")
    print(f"phase 26 autoscaler: signal demand {sig.demand} from {sig.workers_observed} "
          f"worker(s) (prefill queue {sig.prefill_queue_tokens}); plan r{plan.revision} "
          f"workers {plan.workers} ({plan.reason}) {res['t_as_plan'] - res['t_as']:.2f} s "
          f"into its burst; converged in {rep['converge_ticks_max']} ticks "
          f"({res['t_as_converged'] - res['t_as_plan']:.2f} s, status ready 2), the new "
          f"worker registered {res['t_as_ready'] - res['t_as_plan']:.2f} s after the plan")
    print(f"phase 26: {wall:.1f} s")
    return sum(f for _n, f, _s in launches)


# ------------------------------------------------------------ phase 27

HUB27_DIR = ROOT / "build" / "hub27"
HUB27_LEASE_S = 1.0  # the replicas' leader lease
HUB27_WRITE_S = 0.05  # the writer's put interval
HUB27_BEFORE = 4  # streams finished before the leader is killed
HUB27_AFTER = 8  # streams started after the killed replica caught up
HUB27_SEED = 2727


def hub27_replica(addr: str, peers: str, data_dir: Path) -> "Child":
    """One ``cli hub-replica`` process, listening once this returns."""
    host, port = addr.rsplit(":", 1)
    child = Child("hub-replica", "--host", host, "--port", port, "--peers", peers,
                  "--data-dir", str(data_dir), "--lease-s", str(HUB27_LEASE_S))
    child.wait_line("DYNAMO_HUB=", 60)
    return child


def _p27_classes(streams, t_kill, t_elected) -> dict[str, list]:
    """The streams that ended before the kill, ran while the cluster had no
    leader (from the kill to the election), and started after it."""
    return {"before": [s for s in streams if s["end"] < t_kill],
            "during": [s for s in streams if s["end"] >= t_kill and s["start"] < t_elected],
            "after": [s for s in streams if s["start"] >= t_elected]}


async def _replicated_drive(spec, addrs, first_leader, port, replicas, dirs, vocab) -> dict:
    """Phase 27 (a)'s traffic, kill, restart and observation."""
    from dynamo_tpu_torch.runtime.hub_client import RemoteHub, failover_stats
    from dynamo_tpu_torch.sim import cluster

    peers = ",".join(addrs)
    fo0 = failover_stats()
    hub = await RemoteHub.connect(peers, reconnect_window_s=30.0)
    t0 = time.monotonic()
    clock = lambda: time.monotonic() - t0  # noqa: E731
    out: dict = {"streams": [], "acks": [], "write_failures": [], "leaders": {},
                 "health": [], "deletes": []}
    stop, stop_streams = asyncio.Event(), asyncio.Event()
    inst_prefix = "v1/instances/dynamo/backend/generate/"
    inst = await hub.get_prefix(inst_prefix)
    require(len(inst) == 1, f"phase 27: instance keys {inst}")
    out["inst_key"] = next(iter(inst))
    rng = np.random.default_rng(HUB27_SEED)
    prompts = [rng.integers(3, vocab, int(n)).tolist() for n in rng.integers(64, 257, 64)]

    async def writer():
        i = 0
        while not stop.is_set():
            t = time.monotonic()
            try:
                await hub.put(f"p27/w/{i}", i)
                out["acks"].append(clock())
            except (ConnectionError, RuntimeError) as e:
                out["write_failures"].append(f"{i}: {e}")
            i += 1
            await asyncio.sleep(max(0.0, t + HUB27_WRITE_S - time.monotonic()))

    async def watch():
        async for ev in hub.watch_prefix(inst_prefix):
            if ev.kind == "delete":
                out["deletes"].append((clock(), ev.key))

    async def poll():
        """The replicas' roles and the frontend's view of the worker."""
        while not stop.is_set():
            for a, st in zip(addrs, await asyncio.gather(
                    *(cluster.repl_status(a) for a in addrs))):
                if st and st["role"] == "leader":
                    out["leaders"].setdefault(st["epoch"], set()).add(a)
            status, body, _ = await http_call(port, "GET", "/health")
            models = json.loads(body).get("models", {}) if status == 200 else {}
            out["health"].append((clock(), models.get(spec.name, {}).get("instances", 0)))
            await asyncio.sleep(0.1)

    async def stream(i):
        t = clock()
        r = await stream_call(port, "/v1/completions", {
            "model": spec.name, "prompt": prompts[i % len(prompts)]}, SERVE_TOKENS)
        out["streams"].append(dict(r, i=i, start=t, end=clock()))

    async def pairs(first):
        i = first
        while not stop_streams.is_set():
            await asyncio.gather(stream(i), stream(i + 1))
            i += 2

    async def statuses(skip=()):
        return {a: await cluster.repl_status(a) for a in addrs if a not in skip}

    tasks = [asyncio.create_task(c) for c in (writer(), watch(), poll())]
    runner = None
    try:
        for i in range(0, HUB27_BEFORE, 2):
            await asyncio.gather(stream(i), stream(i + 1))
        leader = await cluster.find_leader(addrs)
        require(leader == first_leader, f"phase 27: the leader moved from {first_leader} "
                f"to {leader} before the kill")
        epoch0 = (await cluster.repl_status(leader))["epoch"]
        runner = asyncio.create_task(pairs(HUB27_BEFORE))
        await asyncio.sleep(0.1)  # two streams in flight
        out["t_kill"] = clock()
        replicas[leader].proc.kill()
        replicas[leader].proc.wait(30)
        while True:
            sts = await statuses(skip=(leader,))
            new = [a for a, st in sts.items()
                   if st and st["role"] == "leader" and st["epoch"] > epoch0]
            if new:
                break
            require(clock() - out["t_kill"] < 30, f"phase 27: no new leader in 30 s: {sts}")
            await asyncio.sleep(0.02)
        out["t_elected"], out["new_leader"], out["old_leader"] = clock(), new[0], leader
        out["epochs"] = (epoch0, sts[new[0]]["epoch"])
        out["t_restart"] = clock()
        replicas[leader] = await asyncio.to_thread(hub27_replica, leader, peers, dirs[leader])
        while True:
            lead, back = await cluster.repl_status(new[0]), await cluster.repl_status(leader)
            if lead and back and back["role"] == "follower" and back["leader"] == new[0] \
                    and back["cursor"] >= lead["wal_seq"]:
                break
            require(clock() - out["t_restart"] < 30,
                    f"phase 27: the restarted replica did not catch up: {back} vs {lead}")
            await asyncio.sleep(0.02)
        out["t_caught_up"] = clock()
        while sum(s["start"] >= out["t_caught_up"] for s in out["streams"]) < HUB27_AFTER:
            require(not runner.done() and clock() - out["t_caught_up"] < 120,
                    "phase 27: the streams after the restart stalled")
            await asyncio.sleep(0.05)
        stop_streams.set()
        await runner
        status, body, _ = await http_call(port, "GET", "/metrics")
        out["frontend_failover"] = [ln for ln in body.decode().splitlines()
                                    if ln.startswith(("dynamo_hub_redirects_total",
                                                      "dynamo_hub_backoff_seconds_count"))]
    finally:
        stop.set()
        stop_streams.set()
        for t in tasks + ([runner] if runner else []):
            t.cancel()
        await asyncio.gather(*tasks, *([runner] if runner else []), return_exceptions=True)
        await hub.close()
    out["failover"] = {k: v - fo0.get(k, 0.0) for k, v in failover_stats().items()}
    return out


async def _durable_drive(hub_addr, port, restart, data_dir) -> dict:
    """Phase 27 (b): the durable single hub across a SIGKILL."""
    from dynamo_tpu_torch.runtime.hub_client import RemoteHub
    from dynamo_tpu_torch.sim import cluster

    hub = await RemoteHub.connect(hub_addr, reconnect=False)
    try:
        t0 = time.monotonic()
        while True:  # the frontend has the mocker's card
            status, body, _ = await http_call(port, "GET", "/v1/models")
            if status == 200 and json.loads(body)["data"]:
                break
            require(time.monotonic() - t0 < 60, f"phase 27 (b): /v1/models {body[:200]}")
            await asyncio.sleep(0.05)
        model = json.loads(body)["data"][0]["id"]
        before = (await hub.get_boot_id(), await hub.get_prefix("v1/mdc/"),
                  await hub.get_prefix("v1/instances/"))
    finally:
        await hub.close()
    n_wal = len(cluster.read_wal(data_dir)[1])
    restart_s = await asyncio.to_thread(restart)
    hub = await RemoteHub.connect(hub_addr, reconnect=False)
    try:
        after = (await hub.get_boot_id(), await hub.get_prefix("v1/mdc/"),
                 await hub.get_prefix("v1/instances/"))
    finally:
        await hub.close()
    keys = set(before[1]) | set(before[2])
    rewrites = [r for r in cluster.read_wal(data_dir)[1][n_wal:] if r.get("k") in keys]
    t_chat = time.monotonic()
    while True:
        status, body, _ = await http_call(port, "POST", "/v1/chat/completions", {
            "model": model, "messages": [{"role": "user", "content": "After the restart."}],
            "max_tokens": 8})
        if status == 200:
            break
        require(time.monotonic() - t_chat < 30, f"phase 27 (b): chat {status} {body[:200]}")
        await asyncio.sleep(0.1)
    return {"before": before, "after": after, "rewrites": rewrites, "restart_s": restart_s,
            "chat": json.loads(body), "chat_s": time.monotonic() - t_chat, "model": model}


def hub_phase(card: str, device: str | None = None, spec=None) -> int:
    """Phase 27: the replicated hub under a worker on the card, then the
    durable single hub (see the module docstring). Returns the worker's
    fused_decode launches (its ENGINE_LAUNCHES)."""
    import dataclasses
    import gc
    import shutil

    from dynamo_tpu_torch.sim import cluster

    t27 = time.perf_counter()
    spec = spec or tp8_spec()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(HUB27_DIR, ignore_errors=True)
    ports = sorted(cluster.free_port() for _ in range(3))
    addrs = [f"127.0.0.1:{p}" for p in ports]
    peers = ",".join(addrs)
    dirs = {a: HUB27_DIR / f"replica{i}" for i, a in enumerate(addrs)}
    replicas: dict[str, Child] = {}
    children: list[Child] = []
    try:
        for a in addrs:
            replicas[a] = hub27_replica(a, peers, dirs[a])
        # the leader first in the frontend's and the worker's lists: both
        # hold their hub connection to the replica that is killed
        leader = asyncio.run(cluster.find_leader(addrs))
        first = ",".join([leader] + [a for a in addrs if a != leader])
        front = Child("frontend", "--hub", first, "--port", "0", "--host", "127.0.0.1")
        worker = Child("worker", "--hub", first, "--spec-json",
                       json.dumps(dataclasses.asdict(spec)), "--page-size", "16",
                       "--num-pages", "512", "--max-pages-per-seq", "64",
                       "--max-decode-slots", "8", "--guided", "off", "--precompile",
                       *(["--device", device] if device else []))
        children += [front, worker]
        port = int(front.wait_line("DYNAMO_HTTP=", 120).rsplit(":", 1)[1])
        worker.wait_line("ENGINE_READY", PROC_START_S)
        t_models = time.perf_counter()
        while True:
            status, body, _ = asyncio.run(http_call(port, "GET", "/v1/models"))
            if status == 200 and spec.name in [m["id"] for m in json.loads(body)["data"]]:
                break
            require(time.perf_counter() - t_models < 30, f"phase 27: /v1/models {body[:200]}")
            time.sleep(0.05)
        t_drive = time.perf_counter()
        res = asyncio.run(_replicated_drive(spec, addrs, leader, port, replicas, dirs,
                                            spec.vocab_size))
        res["drive_s"] = time.perf_counter() - t_drive
        require(worker.stop() == 0, f"worker exited non-zero: {worker.seen[-8:]}")
        require(front.stop() == 0, f"frontend exited non-zero: {front.seen[-8:]}")
        for a in addrs:
            require(replicas[a].stop() == 0, f"replica {a} exited non-zero: "
                    f"{replicas[a].seen[-8:]}")
        launches = [json.loads(ln.split(" ", 1)[1]) for ln in worker.pump()
                    if ln.startswith("ENGINE_LAUNCHES ")]
        res["invariants"] = cluster.check_cluster_invariants([dirs[a] for a in addrs])
        res["registration"] = sorted(
            int(r.get("rsq", r.get("sq"))) for a in addrs for r in cluster.read_wal(dirs[a])[1]
            if r.get("op") == "put" and r.get("k") == res["inst_key"])

        # (b) the durable single hub
        hub_port = cluster.free_port()
        single = HUB27_DIR / "single"
        hub_args = ("hub", "--port", str(hub_port), "--data-dir", str(single))
        hub = Child(*hub_args)
        children.append(hub)
        hub.wait_line("DYNAMO_HUB=", 60)
        hub_addr = f"127.0.0.1:{hub_port}"
        mocker = Child("mocker", "--hub", hub_addr, "--speedup-ratio", "10")
        front_b = Child("frontend", "--hub", hub_addr, "--port", "0", "--host", "127.0.0.1")
        children += [mocker, front_b]
        mocker.wait_line("MOCKERS_READY", 60)
        port_b = int(front_b.wait_line("DYNAMO_HTTP=", 120).rsplit(":", 1)[1])

        def restart() -> float:
            """SIGKILL the hub, start it again: seconds until it listens."""
            t = time.monotonic()
            hub.proc.kill()
            hub.proc.wait(30)
            new = Child(*hub_args)
            children.append(new)
            new.wait_line("DYNAMO_HUB=", 60)
            return time.monotonic() - t

        dur = asyncio.run(_durable_drive(hub_addr, port_b, restart, single))
        mocker.stop()  # no SIGTERM handler of its own: it dies of the signal
        for child in (front_b, children[-1]):
            require(child.stop() == 0, f"{child.name} exited non-zero: {child.seen[-8:]}")
    finally:
        for child in children + list(replicas.values()):
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait(30)
    return hub_report(res, dur, launches, spec, card, time.perf_counter() - t27)


def hub_report(res, dur, launches, spec, card, wall) -> int:
    """Phase 27's gates and lines; the worker's fused_decode launches."""
    import statistics

    bad = [s for s in res["streams"] if not s["ok"]]
    require(res["streams"] and not bad, f"phase 27: {len(bad)} of {len(res['streams'])} "
            f"streams failed: {bad[:3]}")
    require(not res["write_failures"], f"phase 27: writes failed: {res['write_failures'][:3]}")
    dual = {e: a for e, a in res["leaders"].items() if len(a) > 1}
    require(not dual, f"phase 27: two leaders in one term: {dual}")
    seen = [n for t, n in res["health"]]
    require(seen and all(n == 1 for n in seen), f"phase 27: the frontend's instance count "
            f"left 1: {[(round(t, 2), n) for t, n in res['health'] if n != 1][:8]}")
    require(not res["deletes"], f"phase 27: instance key deleted: {res['deletes']}")
    committed = set(res["invariants"]["committed"])
    require(res["registration"] and set(res["registration"]) <= committed,
            f"phase 27: the worker's registration {res['registration']} outside the "
            f"committed prefix ({len(committed)} seqs)")
    require(len(launches) == 1, f"phase 27: ENGINE_LAUNCHES lines {launches}")
    fused, steps = launches[0]["launches"].get("fused_decode_attention", 0), launches[0]["steps"]
    require(DEVICE != "cuda" or (steps > 0 and fused == spec.num_layers * steps),
            f"phase 27: fused_decode {fused} over {steps} steps")
    before, after = dur["before"], dur["after"]
    require(after == before and before[1] and before[2], f"phase 27 (b): state before the "
            f"kill {before} and after the restart {after}")
    require(not dur["rewrites"], f"phase 27 (b): re-registration writes {dur['rewrites']}")
    text = dur["chat"]["choices"][0]["message"]["content"]
    require(isinstance(text, str) and text, f"phase 27 (b): chat {dur['chat']}")

    acks = sorted(res["acks"])
    gaps = [b - a for a, b in zip(acks, acks[1:])]
    worst = max(range(len(gaps)), key=gaps.__getitem__)
    classes = _p27_classes(res["streams"], res["t_kill"], res["t_elected"])

    def lat(rs):
        if not rs:
            return "none"
        tt = [r["ttft"] for r in rs]
        it = [r["itl"] for r in rs if r["itl"] is not None]
        return (f"{len(rs)} streams, TTFT mean {1e3 * statistics.fmean(tt):.1f} ms, max "
                f"{1e3 * max(tt):.1f}, ITL mean {1e3 * statistics.fmean(it):.2f} ms, max "
                f"{1e3 * max(it):.2f}")

    t_kill = res["t_kill"]
    print(f"phase 27 [{card}]: replicated hub, 3 cli hub-replica (lease {HUB27_LEASE_S} s), "
          f"a {spec.name} worker on this card and a frontend on the whole address list; "
          f"{len(res['streams'])} streams of {SERVE_TOKENS} tokens two at a time, "
          f"{len(acks)} writes every {1e3 * HUB27_WRITE_S:.0f} ms; leader {res['old_leader']} "
          f"SIGKILLed (term {res['epochs'][0]})")
    print(f"phase 27 election: kill -> new leader {res['new_leader']} (term "
          f"{res['epochs'][1]}) {res['t_elected'] - t_kill:.3f} s; writer's longest gap "
          f"between acks {gaps[worst]:.3f} s (from {acks[worst] - t_kill:+.3f} s of the kill); "
          f"restart -> caught up {res['t_caught_up'] - res['t_restart']:.3f} s; terms "
          f"seen {sorted(res['leaders'])}, one leader each; the worker's registration at "
          f"seq {sorted(set(res['registration']))} in {len(res['registration'])} of the 3 WALs, "
          f"inside the {len(committed)} committed seqs")
    print("phase 27 client failover: this process "
          + json.dumps({k: round(v, 4) for k, v in res["failover"].items() if v})
          + "; frontend " + "; ".join(res["frontend_failover"] or ["none"]))
    for label, rs in classes.items():
        print(f"phase 27 streams {label} the election: {lat(rs)}")
    print(f"phase 27 worker: fused_decode {fused} = {spec.num_layers} x {steps} steps "
          f"(ENGINE_LAUNCHES); the frontend's /health counted 1 instance at all "
          f"{len(seen)} polls")
    print(f"phase 27 (b) durable hub: SIGKILL -> listening again {dur['restart_s']:.3f} s, "
          f"boot_id {dur['after'][0]} kept, {len(dur['after'][1])} model card(s) and "
          f"{len(dur['after'][2])} instance key(s) recovered with no write since the restart, "
          f"a chat served {dur['chat_s']:.3f} s after it")
    print(f"phase 27: {wall:.1f} s (the drive {res['drive_s']:.1f} s)")
    return fused


def phase21_alone(card: str) -> int:
    """``chip_smoke.py --phase21``: phase 21 alone on llama-3-8b's seeded
    weights, a quick check of the multimodal path (no kernel table, no
    final line)."""
    from dynamo_tpu_torch.engine.config import ModelSpec
    from dynamo_tpu_torch.models import llama

    spec = ModelSpec.llama3_8b()
    cfg = dict(page_size=16, num_pages=2048, max_pages_per_seq=64, max_decode_slots=8)
    t0 = time.perf_counter()
    launches = multimodal_phase(spec, cfg, llama.init_params(spec, 0, device=DEVICE), card)
    print(f"phase 21 alone: {time.perf_counter() - t0:.1f} s, fused_decode {launches}")
    return 0


def phase10_alone(card: str) -> int:
    """``chip_smoke.py --phase10``: phase 10 and (b) alone, a quick check of
    cli run, cli bench, cli profile and profile_engine on the card (no
    kernel table, no final line)."""
    from dynamo_tpu_torch.engine.config import ModelSpec

    cli_launches, bench_launches, _row = cli_phase(ModelSpec.llama3_8b().name, card)
    print(f"phase 10 alone: fused_decode {cli_launches} (server) + {bench_launches} "
          f"(profile_engine)")
    return 0


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
    if sys.argv[1:] == ["--phase21"]:
        return phase21_alone(card)
    if sys.argv[1:] == ["--phase10"]:
        return phase10_alone(card)

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
    serve_fp8, fp8_tokens = serve_check(engine, prompts, out["default"], "fp8",
                                        bf16_tokens=bf16_tokens)
    fp8_ttft = out["default"]["res"][1]
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

    # the KVBM tiers on the same weights: write-through offload to host and
    # disk, onboard at admission, a restart on the same disk tier, fp8
    # blocks, MLA's latent blocks
    p4_disp_ms = 1e3 * sum(default_out["times"]) / len(default_out["times"])
    kvbm_launches, kvbm_fp8_launches = kvbm_phase(spec, cfg, params, prompts, card,
                                                  p4_disp_ms)

    # the same weights served over HTTP by the one-process stack
    http_launches, http_stats = http_serve(spec, dict(cfg, kv_dtype="bf16"), params,
                                           prompts, default_out, bf16_tokens)
    # observability on the same weights: the default serve traced and
    # profiled, the overload and guided splits, the instrumentation's cost
    obs_launches = observability_phase(spec, cfg, params, prompts, card)
    # multimodal and embeddings on the same weights: the ViT tower, the EPD
    # serve over HTTP, /v1/embeddings
    mm_launches = multimodal_phase(spec, cfg, params, card)
    del params
    torch.cuda.empty_cache()
    # the same stack from the command line, in a process of its own, with
    # cli bench and cli profile against it; profile_engine on the card
    cli_launches, bench_launches, kernels["fused_decode/llama-1b-bench"] = cli_phase(
        spec.name, card)
    # hub, two workers and frontend, each a process of its own
    process_launches, p11_ttft = process_phase(spec, cfg, prompts, bf16_tokens, http_stats)
    # disaggregated serving on phase 4's weights: in process (bf16, fp8),
    # as processes over the device and TCP routes, deepseek-r1's blocks
    p4_ttft = default_out["res"][1]
    disagg_launches, disagg_fp8_launches = disagg_phase(
        spec, cfg, prompts, {
            "bf16": (bf16_tokens, 1e3 * sum(p4_ttft.values()) / len(p4_ttft)),
            "fp8": (fp8_tokens, 1e3 * sum(fp8_ttft.values()) / len(fp8_ttft))},
        p11_ttft, card)
    # observability across processes: hub, worker and frontend traced, the
    # frontend audited
    t20 = time.perf_counter()
    obs_launches += obs_processes(spec, cfg, prompts, card)
    print(f"phase 20 (c): {time.perf_counter() - t20:.1f} s")

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

    # tensor parallelism: gloo groups on this card (llama-3-8b at tp=2,
    # llama-3-70b's width cut to 4 layers at tp=4), tp=1 on NCCL with
    # graphs, the mirror topology, NCCL across two cards where there are two
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    tp_rows, tp_launches, tp2_tokens = tp_phase(cfg, prompts, bf16_tokens, card, flush)
    kernels.update(tp_rows)

    # expert parallelism: gloo groups on this card (gpt-oss-120b and
    # deepseek-r1 at full width over ep=2 x tp=2, gpt-oss-120b over ep=4)
    ep_rows, ep_launches = ep_phase(cfg, card, flush)
    kernels.update(ep_rows)

    # pipeline, sequence and data parallelism: one 4-rank gloo group on this
    # card through pp=2 x tp=2, pp=2 x dp=2 and pp=4 (pp_decode_step with
    # kv_write and paged_attention_v3) and an sp=2 x tp=2 engine (ring
    # prefill), then cli worker with dp=2
    pp_rows, pp_launches = pp_sp_phase(cfg, prompts, card, flush)
    del flush
    kernels.update(pp_rows)

    # disaggregated serving under tp: a prefill group and a decode group of
    # tp=2 (per-shard CUDA IPC pulls), a one-rank decode worker pulling
    # whole over TCP, embeddings on the tp=2 group, a mirror of the prefill
    # group, the EPP in front of both decode workers
    p25_launches = disagg_tp_phase(cfg, prompts, tp2_tokens, card)

    # the scaling plane: hub, frontend, operator and planner processes; the
    # operator scales llama-3-8b workers (4 layers) 1 -> 2 -> 1 on the
    # planner's decisions, then converges the load-based autoscaler's plan
    p4_res, p4_ttft, p4_wall, _hit = default_out["res"]
    p4 = {"tok_s": sum(len(x["token_ids"]) for items in p4_res.values() for x in items)
          / p4_wall,
          "ttft_s": sum(p4_ttft.values()) / len(p4_ttft),
          "itl_s": sum(default_out["times"]) / len(default_out["times"]),
          "prefill_tok_s": sum(len(p) for p in prompts) / max(p4_ttft.values()),
          "kv_tokens": cfg["num_pages"] * cfg["page_size"],
          "max_context": cfg["max_pages_per_seq"] * cfg["page_size"]}
    scale_launches = scaling_phase(p4, card)

    # the control plane's durability: three hub replicas under a llama-3-8b
    # worker (4 layers) on this card, the leader SIGKILLed mid-stream and
    # restarted; then a durable single hub SIGKILLed and restarted
    t27 = time.perf_counter()
    hub_launches = hub_phase(card)
    t27 = time.perf_counter() - t27

    launches = {"fused_decode": serve_launches["fused_decode"] + http_launches
                + cli_launches + process_launches + overload_launches + guided_launches
                + kvbm_launches + text_launches["fused_decode"] + disagg_launches
                + obs_launches + mm_launches + tp_launches["fused_decode"]
                + pp_launches["fused_decode"] + p25_launches["fused_decode"]
                + scale_launches + hub_launches,
                "paged_attention_v3": unfused[0], "kv_write": unfused[2],
                "kv_write/verify": spec_kv_launches + guided_kv_launches
                + text_launches["kv_write/verify"],
                "fused_decode/fp8": serve_fp8["fused_decode/fp8"] + kvbm_fp8_launches
                + disagg_fp8_launches,
                "paged_attention_v3/fp8": unfused_fp8[1],
                "kv_write/fp8": unfused_fp8[3],
                "kv_write/fp8-verify": spec_kv_fp8_launches,
                "fused_decode/gpt-oss": moe_launches + ep_launches["fused_decode/gpt-oss"],
                "fused_decode/gpt-oss-tp2": ep_launches["fused_decode/gpt-oss-tp2"],
                "fused_decode/tp2": tp_launches["fused_decode/tp2"]
                + pp_launches["fused_decode/tp2"] + p25_launches["fused_decode/tp2"],
                "paged_attention_v3/pp": pp_launches["paged_attention_v3/pp"],
                "kv_write/pp": pp_launches["kv_write/pp"],
                "fused_decode/tp4": tp_launches["fused_decode/tp4"],
                "fused_decode/llama-1b-bench": bench_launches}
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
        # and phase 23 (c)'s ep=4 ranks
        "fused_decode/gpt-oss": ("dynamo_tpu_torch/csrc/fused_decode.cu",
                                 "dynamo_tpu/ops/pallas/fused_decode.py:58"),
        # the same kernel on a tp rank's KV heads (KH 4 / G 4: llama-3-8b at
        # tp=2; KH 2 / G 8: llama-3-70b at tp=4), launched by every rank of
        # phase 22 (the reference runs it under shard_map over tp,
        # dynamo_tpu/ops/attention.py:489)
        "fused_decode/tp2": ("dynamo_tpu_torch/csrc/fused_decode.cu",
                             "dynamo_tpu/ops/pallas/fused_decode.py:58"),
        # gpt-oss-120b's shape on a tp=2 rank of phase 23 (a): KH 4, G 8, D
        # 64, window 128 on its sliding layers, sinks
        "fused_decode/gpt-oss-tp2": ("dynamo_tpu_torch/csrc/fused_decode.cu",
                                     "dynamo_tpu/ops/pallas/fused_decode.py:58"),
        "fused_decode/tp4": ("dynamo_tpu_torch/csrc/fused_decode.cu",
                             "dynamo_tpu/ops/pallas/fused_decode.py:58"),
        # the same kernel at profile_engine's card engine (llama-1b-bench: B 64,
        # KH 8, G 2), launched by phase 10 (b)'s profiled rung; the reference
        # profiles that configuration (benchmarks/profile_engine.py)
        "fused_decode/llama-1b-bench": ("dynamo_tpu_torch/csrc/fused_decode.cu",
                                        "dynamo_tpu/ops/pallas/fused_decode.py:58"),
        # the unfused pair at a pipeline stage's shape (a microbatch of 4 on a
        # tp=2 rank: KH 4, G 4), launched by every pp_decode_step tick of
        # phase 24 (a)-(c): the reference's write_new_kv then
        # paged_decode_attention_auto (dynamo_tpu/parallel/pipeline.py:152-157)
        "paged_attention_v3/pp": ("dynamo_tpu_torch/csrc/paged_attention_v3.cu",
                                  "dynamo_tpu/ops/pallas/paged_attention_v3.py:76"),
        "kv_write/pp": ("dynamo_tpu_torch/csrc/kv_write.cu",
                        "dynamo_tpu/ops/pallas/kv_write.py:39"),
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
    print(f"total: {time.perf_counter() - t_start:.1f} s (phase 27: {t27:.1f} s)")
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
