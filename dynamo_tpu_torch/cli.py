"""dynamo-tpu's torch CLI (the counterpart of dynamo_tpu/cli.py).

    python -m dynamo_tpu_torch.cli run --in http --out engine --model llama-3-8b
        in-memory hub + torch engine worker + OpenAI HTTP frontend on one
        event loop; prints DYNAMO_HTTP=host:port once serving
    python -m dynamo_tpu_torch.cli run --in http --model-path DIR [--spec ngram]
        the same, serving the HF-format checkpoint in DIR (config.json +
        *.safetensors; models/loader.py) with the tokenizer it holds
        (tokenizer.json; frontend/hf_tokenizer.py), else the mock one
    python -m dynamo_tpu_torch.cli run --in batch:reqs.jsonl --out engine
        offline batch: one JSON result line per input line
    python -m dynamo_tpu_torch.cli run --in text --out echo
        interactive chat on stdin (one line per turn, ctrl-d ends)
    python -m dynamo_tpu_torch.cli run ... --out mocker|echo
        the same inputs in front of a mock engine (simulated timing, no
        model) instead of the torch engine; echo returns the prompt
    python -m dynamo_tpu_torch.cli hub|worker|frontend|router|mocker ...
        one service process of a deployment (the same as python -m
        dynamo_tpu_torch.<module>): the TCP hub (prints DYNAMO_HUB=), an
        engine worker (prints ENGINE_READY; SIGTERM drains it; publishes
        its KV events and load, router mode "kv" by default), the OpenAI
        frontend (prints DYNAMO_HTTP=; routes a "kv" card by prefix
        overlap) and the standalone KV router service (prints
        ROUTER_READY; serves "generate" and "best_worker" on component
        "router") and a fleet of mock workers (prints MOCKERS_READY N)

The engine runs on the GPU; ``--device cpu`` runs it on the CPU (tests).
``--spec``, ``--guided`` and ``--tp`` are the reference's, each beating its
``DYN_*`` variable. With ``--in http``, SIGTERM ends the serve and the
engine prints ``ENGINE_LAUNCHES {json}`` (kernel launches, steps, replays
and speculation counters since it was ready), as a worker does.
``--out engine`` is the default (the reference's is ``mocker``): the port's
main path is the card. The other service subcommands (planner, ...) are
refused until their own slices.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

SUBCOMMAND_MODULES = {
    "hub": "dynamo_tpu_torch.runtime.hub_server",
    "frontend": "dynamo_tpu_torch.frontend.__main__",
    "worker": "dynamo_tpu_torch.engine.worker",
    "router": "dynamo_tpu_torch.kv_router.service",
    "mocker": "dynamo_tpu_torch.mocker.__main__",
}
# the reference's other service commands -> the ROADMAP Queue A item that
# ports them
REFUSED_COMMANDS = {
    "hub-replica": "item 14", "encoder": "item 12", "operator": "item 14", "planner": "item 14",
    "bench": "item 14", "profile": "item 14",
}


def _usage() -> str:
    return (
        "usage: python -m dynamo_tpu_torch.cli <command> [args]\n"
        "commands:\n"
        "  run        one-process serving stack (--in http|text|batch:FILE "
        "--out engine|mocker|echo)\n"
        + "".join(f"  {name:<10} launch {mod}\n"
                  for name, mod in SUBCOMMAND_MODULES.items())
    )


async def _arun(args: argparse.Namespace) -> None:
    from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub import InMemoryHub

    drt = DistributedRuntime(InMemoryHub())
    if args.out in ("mocker", "echo"):
        from dynamo_tpu_torch.mocker.__main__ import launch_mock_worker
        from dynamo_tpu_torch.mocker.engine import MockEngineConfig

        model_name = args.model_name or (
            "echo" if args.out == "echo" else "mock-model")
        engine, _ = await launch_mock_worker(
            drt, args.namespace, "backend", "generate",
            MockEngineConfig(block_size=16, speedup_ratio=args.speedup_ratio,
                             echo_prompt=args.out == "echo"),
            model_name=model_name, register_card=True,
        )

        async def close_engine() -> None:  # the mock engine's publishers
            for pub in (engine.events, engine.metrics):
                await pub.close()
    else:
        from dynamo_tpu_torch.engine.config import EngineConfig
        from dynamo_tpu_torch.engine.worker import (
            engine_launches,
            launch_base,
            launch_engine_worker,
        )
        from dynamo_tpu_torch.runtime.config import RuntimeConfig

        env_cfg = RuntimeConfig.from_env()
        engine, _ = await launch_engine_worker(
            drt, namespace=args.namespace, model=args.model,
            model_path=args.model_path, model_name=args.model_name,
            # serving always pipelines the decode bursts (as the reference's
            # worker); a flag beats its DYN_* variable beats the default
            engine_config=EngineConfig(
                tp=args.tp, pipeline_decode=True,
                spec_mode=args.spec or env_cfg.spec_mode or "off",
                spec_k_max=env_cfg.spec_k_max or 8,
                guided_mode=args.guided or env_cfg.guided_mode or "auto",
            ),
            precompile=args.precompile, device=args.device,
        )
        model_name = args.model_name or engine.spec.name
        base = launch_base(engine)

        async def close_engine() -> None:
            await engine.close()
            print("ENGINE_LAUNCHES " + json.dumps(engine_launches(engine, base)),
                  flush=True)
    manager = ModelManager()
    watcher = await ModelWatcher(drt, manager).start()
    try:
        await watcher.wait_for_model(model_name, timeout=30)
        if args.inp == "http":
            await _serve_http(args, drt, manager, model_name)
        elif args.inp == "text":
            await _serve_text(args, manager.get(model_name), model_name)
        else:
            await _serve_batch(args, manager.get(model_name), model_name)
    finally:
        await watcher.close()
        await close_engine()
        await drt.close()


async def _serve_http(args, drt, manager, model_name: str) -> None:
    import signal

    from dynamo_tpu_torch.frontend.http import HttpFrontend

    # SIGTERM ends the serve through the finally blocks: the engine closes
    # and prints its ENGINE_LAUNCHES line
    asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, drt.runtime.shutdown)
    frontend = HttpFrontend(manager, host=args.host, port=args.port, drt=drt)
    host, port = await frontend.start()
    print(f"DYNAMO_HTTP={host}:{port}", flush=True)
    print(f"serving {model_name!r}: POST http://{host}:{port}/v1/chat/completions",
          flush=True)
    try:
        await drt.runtime.wait_for_shutdown()
    finally:
        await frontend.stop()


async def _serve_batch(args, pipe, model_name: str) -> None:
    from dynamo_tpu_torch.runtime.context import Context

    path = args.inp[len("batch:"):]
    # read AND parse off the loop: a big batch file must not stall the
    # pipeline sharing this loop
    def _read() -> list[dict]:
        with open(path) as f:
            return [json.loads(ln) for ln in f if ln.strip()]

    reqs = await asyncio.to_thread(_read)
    sem = asyncio.Semaphore(args.batch_concurrency)

    async def one(i: int, req: dict) -> dict:
        body = {"model": model_name, "max_tokens": args.max_tokens}
        body.update(req)
        if "messages" not in body and "prompt" in body:
            body["messages"] = [{"role": "user", "content": body.pop("prompt")}]
        pre = pipe.preprocessor.preprocess(body)
        text: list[str] = []
        async with sem:
            async for d in pipe.generate(pre, Context()):
                if d.get("text"):
                    text.append(d["text"])
        return {"index": i, "text": "".join(text)}

    results = await asyncio.gather(*(one(i, r) for i, r in enumerate(reqs)))
    if args.output:

        def _write() -> None:
            with open(args.output, "w") as f:
                for r in results:
                    f.write(json.dumps(r) + "\n")

        await asyncio.to_thread(_write)
        print(f"BATCH_DONE n={len(results)} -> {args.output}", flush=True)
    else:
        for r in results:
            sys.stdout.write(json.dumps(r) + "\n")


async def _serve_text(args, pipe, model_name: str) -> None:
    """Interactive chat: one stdin line per user turn, the reply streamed
    to stdout; end of input ends the session."""
    from dynamo_tpu_torch.runtime.context import Context

    print(f"interactive chat with {model_name!r} (ctrl-d to exit)")
    loop = asyncio.get_running_loop()
    while True:
        try:
            line = await loop.run_in_executor(None, input, "> ")
        except EOFError:
            return
        if not line.strip():
            continue
        body = {
            "model": model_name, "max_tokens": args.max_tokens,
            "messages": [{"role": "user", "content": line}],
        }
        pre = pipe.preprocessor.preprocess(body)
        async for d in pipe.generate(pre, Context()):
            if d.get("text"):
                print(d["text"], end="", flush=True)
        print()


def _run_command(rest: list[str]) -> int:
    p = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.cli run")
    p.add_argument("--in", dest="inp", default="http",
                   help="http | text | batch:FILE.jsonl")
    p.add_argument("--out", default="engine",
                   choices=["engine", "mocker", "echo"])
    p.add_argument("--model", default="tiny-test",
                   help="model preset (out=engine)")
    p.add_argument("--model-path", default=None,
                   help="local HF-format checkpoint dir (out=engine)")
    p.add_argument("--model-name", default=None)
    p.add_argument("--device", default=None,
                   help="torch device of the engine (default: the GPU)")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor parallelism (only 1 is ported)")
    p.add_argument("--precompile", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="capture every decode graph variant before serving")
    p.add_argument("--guided", default=None, choices=["auto", "off"],
                   help="guided decoding for response_format / forced "
                        "tool_choice (default DYN_GUIDED_MODE, else auto)")
    p.add_argument("--spec", default=None, choices=["off", "ngram"],
                   help="out=engine: speculative decoding (prompt-lookup "
                        "drafter + batched verify; default DYN_SPEC_MODE, "
                        "else off)")
    p.add_argument("--max-tokens", type=int, default=128)
    p.add_argument("--speedup-ratio", type=float, default=1.0,
                   help="out=mocker|echo: divide the simulated step times")
    p.add_argument("--output", default=None,
                   help="batch mode: write JSONL results here (default stdout)")
    p.add_argument("--batch-concurrency", type=int, default=8)
    args = p.parse_args(rest)
    if args.inp not in ("http", "text") and not args.inp.startswith("batch:"):
        p.error(f"unknown --in {args.inp!r} (http | text | batch:FILE)")
    try:
        asyncio.run(_arun(args))
    except KeyboardInterrupt:
        pass
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "run":
        return _run_command(rest)
    mod_name = SUBCOMMAND_MODULES.get(cmd)
    if mod_name is not None:
        import importlib

        importlib.import_module(mod_name).main(rest)
        return 0
    if cmd in REFUSED_COMMANDS:
        raise NotImplementedError(
            f"{cmd!r} is not ported yet (ROADMAP Queue A {REFUSED_COMMANDS[cmd]})")
    print(f"unknown command: {cmd!r}\n{_usage()}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
