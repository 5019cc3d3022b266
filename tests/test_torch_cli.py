"""The port's one-process CLI against the reference's: ``cli run`` builds
its EngineConfig from the same flags (``--spec``, ``--guided``, ``--tp``)
and the same DYN_* environment, with the reference's precedence (a flag
beats its variable beats the default). ``launch_engine_worker`` is stubbed
in both CLIs to capture the config it is handed."""

import dataclasses

import pytest

import dynamo_tpu.cli as jax_cli
import dynamo_tpu.engine.worker as jax_worker
import dynamo_tpu_torch.cli as cli
import dynamo_tpu_torch.engine.worker as worker

pytestmark = pytest.mark.unit

ENV = ("DYN_SPEC_MODE", "DYN_SPEC_K_MAX", "DYN_GUIDED_MODE")
FIELDS = ("tp", "pipeline_decode", "spec_mode", "spec_k_max", "guided_mode")


class _Captured(Exception):
    pass


def _capture(monkeypatch, module):
    seen = {}

    async def stub(drt, **kw):
        seen.update(kw)
        raise _Captured

    monkeypatch.setattr(module, "launch_engine_worker", stub)
    return seen


def _run(monkeypatch, module, run, argv):
    seen = _capture(monkeypatch, module)
    with pytest.raises(_Captured):
        run(["--out", "engine", "--port", "0", *argv])
    return seen["engine_config"]


@pytest.mark.parametrize("argv,env", [
    ([], {}),
    (["--spec", "ngram"], {}),
    ([], {"DYN_SPEC_MODE": "ngram"}),
    (["--spec", "off"], {"DYN_SPEC_MODE": "ngram"}),
    (["--spec", "ngram"], {"DYN_SPEC_K_MAX": "4"}),
    ([], {"DYN_SPEC_MODE": "ngram", "DYN_SPEC_K_MAX": "3"}),
    (["--guided", "off"], {}),
    ([], {"DYN_GUIDED_MODE": "off"}),
    (["--guided", "auto"], {"DYN_GUIDED_MODE": "off"}),
    (["--tp", "1", "--spec", "ngram", "--guided", "off"], {"DYN_SPEC_K_MAX": "6"}),
])
def test_run_builds_the_reference_engine_config(monkeypatch, argv, env):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = _run(monkeypatch, jax_worker, jax_cli._run_command, argv)
    got = _run(monkeypatch, worker, cli._run_command, argv)
    assert {f: getattr(got, f) for f in FIELDS} == {f: getattr(want, f) for f in FIELDS}
    # every field the two configs share is equal, not only the five above
    shared = {f.name for f in dataclasses.fields(want)} & {
        f.name for f in dataclasses.fields(got)}
    assert {f: getattr(got, f) for f in shared} == {f: getattr(want, f) for f in shared}


def test_run_tp_2_refuses_naming_item_11(monkeypatch):
    """``--tp 2`` builds the reference's config. MLA, refused here until
    item 11b ported it, shards now: ``--ep 2 --tp 2`` reaches the launcher
    as the port's config, and a model whose experts do not divide over
    ``--ep`` is refused naming the axis before any rank starts."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert _run(monkeypatch, jax_worker, jax_cli._run_command, ["--tp", "2"]).tp == 2
    seen = {}

    async def launcher(ecfg, **kw):
        seen.update(ecfg=ecfg, model=kw["model"])
        raise _Captured

    monkeypatch.setattr(worker, "start_tp_group", launcher)
    with pytest.raises(_Captured):
        cli._run_command(["--out", "engine", "--port", "0", "--ep", "2", "--tp", "2",
                          "--model", "tiny-deepseek"])
    assert (seen["ecfg"].ep, seen["ecfg"].tp, seen["model"]) == (2, 2, "tiny-deepseek")
    monkeypatch.undo()
    _capture(monkeypatch, worker)
    with pytest.raises(ValueError, match="ep=3"):
        cli._run_command(["--out", "engine", "--port", "0", "--ep", "3",
                          "--model", "tiny-moe"])


@pytest.mark.parametrize("argv", [["--spec", "eagle"], ["--guided", "on"]])
def test_run_rejects_unknown_choices_as_the_reference(argv):
    for run in (jax_cli._run_command, cli._run_command):
        with pytest.raises(SystemExit) as e:
            run(argv)
        assert e.value.code == 2


def test_run_serves_a_tokenizer_checkpoint_and_reports_at_sigterm(tmp_path):
    """``cli run --model-path DIR --spec ngram`` on a directory holding a
    tokenizer serves a chat whose prompt the tokenizer counts, and on
    SIGTERM prints ENGINE_LAUNCHES with the verify dispatches it ran."""
    import json
    import os
    import signal
    import subprocess
    import sys
    import urllib.request
    from pathlib import Path

    from test_torch_tokenizer import build_tokenizer_dir

    from dynamo_tpu_torch.engine.config import ModelSpec
    from dynamo_tpu_torch.frontend.tokenizer import HFTokenizer
    from dynamo_tpu_torch.models import llama, loader

    spec = ModelSpec(vocab_size=1024, hidden_size=64, intermediate_size=128, num_layers=2,
                     num_heads=4, num_kv_heads=2, head_dim=16, dtype="float32",
                     name="cli-text")
    loader.save_params(spec, llama.init_params(spec, 1, device="cpu"), str(tmp_path))
    build_tokenizer_dir("llama3", tmp_path)
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli", "run", "--in", "http",
         "--model-path", str(tmp_path), "--device", "cpu", "--port", "0", "--spec", "ngram"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        for line in proc.stdout:
            if line.startswith("DYNAMO_HTTP="):
                addr = line.strip().split("=", 1)[1]
                break
        else:
            pytest.fail("cli run printed no DYNAMO_HTTP=")
        chat = [{"role": "user", "content": "Hello there, 机器学习!"}]
        req = urllib.request.Request(
            f"http://{addr}/v1/chat/completions", method="POST",
            headers={"Content-Type": "application/json"},
            data=json.dumps({"model": tmp_path.name, "messages": chat, "max_tokens": 6,
                             "ignore_eos": True}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        tok = HFTokenizer(str(tmp_path))
        assert body["usage"] == {"prompt_tokens": len(tok.encode(tok.apply_chat_template(chat))),
                                 "completion_tokens": 6,
                                 "total_tokens": body["usage"]["total_tokens"]}
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    line = next(ln for ln in out.splitlines() if ln.startswith("ENGINE_LAUNCHES "))
    report = json.loads(line.split(" ", 1)[1])
    assert report["spec"]["verifies"] > 0 and report["launches"]["kv_write"] == 0


def test_planner_command_prints_the_reference_dryrun(tmp_path, capsys):
    """``cli planner --dryrun-trace`` (moved from the refused commands)
    prints the reference CLI's decisions line for line."""
    import json

    trace = tmp_path / "trace.jsonl"
    trace.write_text("".join(json.dumps({"num_req": n, "isl": 300 + 10 * n, "osl": 120})
                             + "\n" for n in (4, 90, 400, 1500, 60, 0)))
    argv = ["planner", "--dryrun-trace", str(trace), "--load-predictor", "holt",
            "--adjustment-interval", "5", "--max-chip-budget", "10"]
    assert jax_cli.main(list(argv)) == 0
    want = capsys.readouterr().out
    assert cli.main(list(argv)) == 0
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == 6
    assert "planner" in cli.SUBCOMMAND_MODULES and "planner" not in cli.REFUSED_COMMANDS


def test_operator_command_refuses_without_a_hub_as_the_reference(monkeypatch):
    """``cli operator`` (moved from the refused commands) needs a hub, and
    says so in the reference's words."""
    for k in ("DYN_HUB_ADDRESSES", "DYN_HUB_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    msgs = []
    for main in (jax_cli.main, cli.main):
        with pytest.raises(SystemExit) as e:
            main(["operator", "--name", "g"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "--hub" in msgs[1]
    assert "operator" in cli.SUBCOMMAND_MODULES and "operator" not in cli.REFUSED_COMMANDS
