"""Build and load the port's CUDA kernels (``dynamo_tpu_torch/csrc``).

Every ``*.cu`` source compiles with its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects link into one shared library with a
plain C interface, ``build/dynamo_tpu_torch/libkernels.so`` at the root of
the checkout, loaded with ``ctypes``. The build runs at first use and again
whenever a source is newer than the library. The staleness check and the
build hold an ``fcntl`` lock on ``build/dynamo_tpu_torch/.lock``, so
processes started together on a fresh checkout (a hub's workers) build once
and load the same library. Nothing here runs at import.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "dynamo_tpu_torch"
LIB_PATH = BUILD_DIR / "libkernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of every C entry point; each returns a cudaError_t as int
SIGNATURES = {
    "dtt_kv_write": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "dtt_paged_attention_v3": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P,
    ],
    "dtt_fused_decode": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P,
    ],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
            "CUDA kernels build from source at first use"
        )
    return found


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(
        src.stat().st_mtime > built
        for src in list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh"))
    )


@contextlib.contextmanager
def _build_lock():
    """Hold the cross-process build lock (released by the kernel if the
    holder dies, so a killed build leaves nothing to clean up)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(verbose: bool = False) -> Path:
    """Compile every source in parallel and link ``libkernels.so``, under
    the build lock."""
    with _build_lock():
        return _compile(verbose)


def ensure_built() -> Path:
    """Build unless the library is fresh; one process builds while the
    others wait on the lock, then find it fresh."""
    with _build_lock():
        if _stale():
            _compile(False)
    return LIB_PATH


def _compile(verbose: bool) -> Path:
    """Writes into a private temporary directory and renames the library
    into place, so a reader never loads a half-written file."""
    nvcc = nvcc_path()
    sources = sorted(CSRC.glob("*.cu"))
    flags = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    if verbose:
        flags += ["-Xptxas", "-v"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *flags, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
            elif verbose and out:
                print(out, end="")
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / LIB_PATH.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        os.replace(tmp_lib, LIB_PATH)
    return LIB_PATH


def load_library() -> ctypes.CDLL:
    """The kernels' library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(ensure_built()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.dtt_error_string.argtypes = [ctypes.c_int]
            lib.dtt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = load_library().dtt_error_string(rc).decode()
        raise RuntimeError(f"{name} failed: cudaError {rc} ({msg})")


def dtype_code(dtype: torch.dtype) -> int:
    """csrc/common.cuh code of a query / output / new-row dtype (and of a
    plain pool's, which matches it)."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")
    return codes[dtype]


def pool_code(dtype: torch.dtype) -> int:
    """csrc/common.cuh code of a pool's value dtype: the query's, or fp8
    e4m3 (code 2, with bf16 scales beside it)."""
    if dtype == torch.float8_e4m3fn:
        return 2
    return dtype_code(dtype)


def stream_ptr(tensor: torch.Tensor) -> int:
    return torch.cuda.current_stream(tensor.device).cuda_stream


# every kernel wrapper with launch counters (see ``counted``)
KERNELS: list = []


def counted(fn):
    """Give a kernel wrapper its counters: ``launches`` (and
    ``fp8_launches``, its fp8 form's among them) count kernels that ran;
    ``captured`` / ``fp8_captured`` count launches recorded into a CUDA
    graph, which run only when the graph replays. A graph's runner
    (engine/graphs.py) adds its captured launches to ``launches`` at every
    replay."""
    fn.launches = fn.fp8_launches = fn.captured = fn.fp8_captured = 0
    KERNELS.append(fn)
    return fn


def count_launch(fn, fp8: bool = False) -> None:
    """One launch of ``fn``'s kernel on the current stream."""
    if torch.cuda.is_current_stream_capturing():
        fn.captured += 1
        fn.fp8_captured += int(fp8)
    else:
        fn.launches += 1
        fn.fp8_launches += int(fp8)
