"""The port's SLA profiler (dynamo_tpu_torch/profiling/profile_sla.py, ``cli
profile``) held against the reference's benchmarks/profile_sla.py on the
CPU: ``profile_prefill`` and ``profile_decode`` of both packages, run
against one port mocker frontend on the same grid, give npz files of equal
keys, dtypes and shapes; each package's ``PrefillInterpolator`` and
``DecodeInterpolator`` reads the other's files, and both give identical
numbers on the same file; ``cli profile`` end to end in subprocesses.
"""

import numpy as np
import pytest
import torch

from benchmarks import profile_sla as jprof
from dynamo_tpu import planner as jplanner
from dynamo_tpu_torch import planner as tplanner
from dynamo_tpu_torch.profiling import profile_sla
from test_torch_loadgen import _cli, _json_lines, _stack, mocker_server

pytestmark = pytest.mark.integration

ISLS, CONCS, CTXS, OSL, KV = [32, 128], [1, 4], [32, 128], 6, 4096 * 4


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


async def _profiles(mod, url):
    return (await mod.profile_prefill(url, "bench-model", ISLS, requests_per_point=2),
            await mod.profile_decode(url, "bench-model", CONCS, CTXS, KV, osl=OSL,
                                     requests_per_point=2))


def _write(tmp_path, name, prefill, decode):
    d = tmp_path / name
    d.mkdir()
    np.savez(d / "prefill.npz", **prefill)
    np.savez(d / "decode.npz", **decode)
    return d


def _read(pkg, d):
    pre = pkg.PrefillInterpolator(str(d / "prefill.npz"))
    dec = pkg.DecodeInterpolator(str(d / "decode.npz"))
    return ([pre.interpolate_ttft(x) for x in (16, 32, 80, 128, 500)]
            + [pre.interpolate_thpt_per_chip(x) for x in (32, 80, 128)]
            + [dec.interpolate_itl(c, x) for c in (1, 2, 4) for x in (32, 90, 128)]
            + [dec.interpolate_thpt_per_chip(c, x) for c in (1, 3) for x in (32, 128)]
            + list(dec.find_best_throughput_per_chip(10.0, 64))
            + list(dec.find_best_throughput_per_chip(1e-9, 64)))


async def test_profiles_read_alike_across_packages(tmp_path):
    url, close = await _stack()
    try:
        got = await _profiles(profile_sla, url)
        want = await _profiles(jprof, url)
    finally:
        await close()
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            assert (g[k].dtype, g[k].shape) == (w[k].dtype, w[k].shape), k
            assert np.isfinite(g[k]).all() and (g[k] >= 0).all(), k
    # the grid's axes and the kv usage do not depend on timing
    for k in ("prefill_isl",):
        assert np.array_equal(got[0][k], want[0][k])
    for k in ("decode_kv_usage", "decode_context", "max_kv_tokens"):
        assert np.array_equal(got[1][k], want[1][k])
    assert (got[0]["prefill_ttft_s"] > 0).all() and (got[1]["decode_thpt_per_chip"] > 0).all()
    port_dir = _write(tmp_path, "port", *got)
    ref_dir = _write(tmp_path, "ref", *want)
    for d in (port_dir, ref_dir):
        a, b = _read(tplanner, d), _read(jplanner, d)
        assert a == b and all(np.isfinite(a)), d
    thpt, itl, _kv = tplanner.DecodeInterpolator(str(port_dir / "decode.npz")
                                                 ).find_best_throughput_per_chip(10.0, 64)
    assert thpt > 0 and itl > 0


def test_cli_profile_prints_the_references_lines(tmp_path):
    server, url = mocker_server()
    try:
        args = ["--url", url, "--model", "mock-model", "--isl-grid", "32,96",
                "--concurrency-grid", "1,2", "--context-grid", "32,64", "--osl", "4",
                "--requests-per-point", "2", "--max-kv-tokens", "8192"]
        got = _json_lines(_cli("dynamo_tpu_torch.cli", "profile", *args,
                               "--out", str(tmp_path / "port")))
        want = _json_lines(_cli("benchmarks.profile_sla", *args,
                                "--out", str(tmp_path / "ref")))
    finally:
        server.terminate()
        server.communicate(timeout=30)  # reaps it and closes its pipes
    assert [sorted(x) for x in got] == [sorted(x) for x in want]
    assert got[:2] == want[:2] == [{"written": "prefill.npz", "points": 2},
                                   {"written": "decode.npz", "grid": [2, 2]}]
    assert got[2]["ttft_at_mid_isl_ms"] > 0 and got[2]["best_thpt_at_sla"] > 0
    for name in ("prefill.npz", "decode.npz"):
        with np.load(tmp_path / "port" / name) as g, np.load(tmp_path / "ref" / name) as w:
            assert {k: (g[k].dtype, g[k].shape) for k in g.files} == {
                k: (w[k].dtype, w[k].shape) for k in w.files}
