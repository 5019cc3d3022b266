"""dynamo-tpu's torch CLI: the one-process serving stack (the counterpart of
dynamo_tpu/cli.py).

    python -m dynamo_tpu_torch.cli run --in http --out engine --model llama-3-8b
        in-memory hub + torch engine worker + OpenAI HTTP frontend on one
        event loop; prints DYNAMO_HTTP=host:port once serving
    python -m dynamo_tpu_torch.cli run --in batch:reqs.jsonl --out engine
        offline batch: one JSON result line per input line

The engine runs on the GPU; ``--device cpu`` runs it on the CPU (tests).
Not yet ported, and refused: ``--in text``, ``--out mocker|echo`` and the
service subcommands (hub, frontend, worker, router, ...), which need the
TCP hub (ROADMAP Queue A item 4b) or their own slices.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

REFUSED_COMMANDS = ("hub", "hub-replica", "frontend", "worker", "mocker", "router",
                    "encoder", "operator", "planner", "bench", "profile")


def _usage() -> str:
    return (
        "usage: python -m dynamo_tpu_torch.cli run [args]\n"
        "commands:\n"
        "  run        one-process serving stack (--in http|batch:FILE "
        "--out engine)\n"
    )


async def _arun(args: argparse.Namespace) -> None:
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.worker import launch_engine_worker
    from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub import InMemoryHub

    drt = DistributedRuntime(InMemoryHub())
    # serving always pipelines the decode bursts (as the reference's worker)
    engine, _ = await launch_engine_worker(
        drt, namespace=args.namespace, model=args.model,
        model_name=args.model_name,
        engine_config=EngineConfig(pipeline_decode=True),
        precompile=args.precompile, device=args.device,
    )
    model_name = args.model_name or engine.spec.name
    manager = ModelManager()
    watcher = await ModelWatcher(drt, manager).start()
    try:
        await watcher.wait_for_model(model_name, timeout=30)
        if args.inp == "http":
            await _serve_http(args, drt, manager, model_name)
        else:
            await _serve_batch(args, manager.get(model_name), model_name)
    finally:
        await watcher.close()
        await engine.close()
        await drt.close()


async def _serve_http(args, drt, manager, model_name: str) -> None:
    from dynamo_tpu_torch.frontend.http import HttpFrontend

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


def _run_command(rest: list[str]) -> int:
    p = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.cli run")
    p.add_argument("--in", dest="inp", default="http",
                   help="http | batch:FILE.jsonl")
    p.add_argument("--out", default="engine",
                   help="engine (mocker and echo are not ported yet)")
    p.add_argument("--model", default="tiny-test", help="model preset")
    p.add_argument("--model-name", default=None)
    p.add_argument("--device", default=None,
                   help="torch device of the engine (default: the GPU)")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--precompile", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="capture every decode graph variant before serving")
    p.add_argument("--max-tokens", type=int, default=128)
    p.add_argument("--output", default=None,
                   help="batch mode: write JSONL results here (default stdout)")
    p.add_argument("--batch-concurrency", type=int, default=8)
    args = p.parse_args(rest)
    if args.out != "engine":
        raise NotImplementedError(
            f"--out {args.out}: the port serves --out engine only (the mocker "
            "is not ported yet)")
    if args.inp != "http" and not args.inp.startswith("batch:"):
        if args.inp == "text":
            raise NotImplementedError("--in text is not ported yet")
        p.error(f"unknown --in {args.inp!r} (http | batch:FILE)")
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
    if cmd in REFUSED_COMMANDS:
        raise NotImplementedError(
            f"{cmd!r} runs as its own process, which needs the TCP hub "
            "(ROADMAP Queue A item 4b) or its own slice; use 'run'")
    print(f"unknown command: {cmd!r}\n{_usage()}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
