"""Perf interpolators over pre-deployment profiling results (a copy of
dynamo_tpu/planner/interpolation.py: numpy only, the same file format).

Role of the upstream planner's perf_interpolation.py:36-92: turn profiled
(ISL -> TTFT, throughput/chip) and (kv-usage, context -> ITL,
throughput/chip) curves into the inverse lookups the planner needs. Our
profiler (profiling/profile_sla.py, the reference's
benchmarks/profile_sla.py) emits REGULAR grids, so 1D piecewise-
linear (np.interp) and regular-grid bilinear interpolation are exact
enough — no scattered-data cubic fitting, no scipy dependency on the
serving path.

File format (npz, one file per deployment config):
  prefill_isl [n]            tokens
  prefill_ttft_s [n]         seconds
  prefill_thpt_per_chip [n]  tokens/s/chip at saturation
  decode_kv_usage [nx]       fraction of KV pool in use (grid axis)
  decode_context [ny]        average context length (grid axis)
  decode_itl_s [ny, nx]      seconds
  decode_thpt_per_chip [ny, nx] tokens/s/chip
  max_kv_tokens [1]          KV pool capacity in tokens per replica
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["PrefillInterpolator", "DecodeInterpolator", "synthetic_profile"]


class PrefillInterpolator:
    """ISL -> expected TTFT and per-chip prefill throughput."""

    def __init__(self, profile: str | dict):
        data = _load(profile, "prefill.npz")
        order = np.argsort(data["prefill_isl"])
        self.isl = np.asarray(data["prefill_isl"], np.float64)[order]
        self.ttft = np.asarray(data["prefill_ttft_s"], np.float64)[order]
        self.thpt = np.asarray(data["prefill_thpt_per_chip"], np.float64)[order]

    def interpolate_ttft(self, isl: float) -> float:
        return float(np.interp(isl, self.isl, self.ttft))

    def interpolate_thpt_per_chip(self, isl: float) -> float:
        return float(np.interp(isl, self.isl, self.thpt))


class DecodeInterpolator:
    """(kv usage, context length) -> ITL and per-chip decode throughput."""

    def __init__(self, profile: str | dict):
        data = _load(profile, "decode.npz")
        self.kv_usage = np.asarray(data["decode_kv_usage"], np.float64)
        self.context = np.asarray(data["decode_context"], np.float64)
        self.itl = np.asarray(data["decode_itl_s"], np.float64)
        self.thpt = np.asarray(data["decode_thpt_per_chip"], np.float64)
        self.max_kv_tokens = float(np.asarray(data["max_kv_tokens"]).reshape(-1)[0])

    def _bilinear(self, grid: np.ndarray, x: float, y: float) -> float:
        """grid[iy, ix] over (kv_usage x, context y)."""
        xi = np.clip(np.searchsorted(self.kv_usage, x) - 1, 0,
                     len(self.kv_usage) - 2)
        yi = np.clip(np.searchsorted(self.context, y) - 1, 0,
                     len(self.context) - 2)
        x0, x1 = self.kv_usage[xi], self.kv_usage[xi + 1]
        y0, y1 = self.context[yi], self.context[yi + 1]
        tx = 0.0 if x1 == x0 else np.clip((x - x0) / (x1 - x0), 0.0, 1.0)
        ty = 0.0 if y1 == y0 else np.clip((y - y0) / (y1 - y0), 0.0, 1.0)
        g = grid
        v = (
            g[yi, xi] * (1 - tx) * (1 - ty)
            + g[yi, xi + 1] * tx * (1 - ty)
            + g[yi + 1, xi] * (1 - tx) * ty
            + g[yi + 1, xi + 1] * tx * ty
        )
        return float(v)

    def _kv_usage_of(self, concurrency: float, context_length: float) -> float:
        return concurrency * context_length / self.max_kv_tokens

    def interpolate_itl(self, concurrency: float, context_length: float) -> float:
        return self._bilinear(
            self.itl, self._kv_usage_of(concurrency, context_length),
            context_length,
        )

    def interpolate_thpt_per_chip(
        self, concurrency: float, context_length: float
    ) -> float:
        return self._bilinear(
            self.thpt, self._kv_usage_of(concurrency, context_length),
            context_length,
        )

    def find_best_throughput_per_chip(
        self, itl: float, context_length: float
    ) -> tuple[float, float, float]:
        """Highest per-chip decode throughput whose ITL meets the target at
        this context length; returns (thpt/chip, itl, kv_usage). Scans the
        kv-usage axis (interpolated ITL need not be monotonic — same
        reasoning as the reference's linear scan)."""
        best = None
        for x in self.kv_usage:
            itl_x = self._bilinear(self.itl, x, context_length)
            if itl_x <= itl:
                thpt = self._bilinear(self.thpt, x, context_length)
                if best is None or thpt > best[0]:
                    best = (thpt, itl_x, float(x))
        if best is None:
            # SLA unattainable: run at the lowest-load grid point
            x = float(self.kv_usage[0])
            best = (
                self._bilinear(self.thpt, x, context_length),
                self._bilinear(self.itl, x, context_length),
                x,
            )
        return best


def _load(profile: str | dict, filename: str) -> dict:
    if isinstance(profile, dict):
        return profile
    path = profile
    if os.path.isdir(path):
        path = os.path.join(path, filename)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def synthetic_profile(
    *,
    base_ttft_s: float = 0.1,
    ttft_per_token_s: float = 1e-4,
    prefill_thpt_per_chip: float = 8000.0,
    base_itl_s: float = 0.01,
    itl_per_kv_usage_s: float = 0.04,
    itl_per_context_s: float = 2e-6,
    decode_thpt_at_full_kv: float = 4000.0,
    max_kv_tokens: int = 65536,
    max_context: int = 8192,
) -> dict:
    """An analytic profile for tests and dryruns: TTFT linear in ISL,
    ITL linear in kv-usage and context, decode throughput proportional to
    kv usage (more concurrency = more tokens/s until the ITL knee). The
    planner math can be checked against it in closed form."""
    isl = np.linspace(64, max_context, 16)
    kv = np.linspace(0.05, 1.0, 20)
    ctx = np.linspace(64, max_context, 16)
    KV, CTX = np.meshgrid(kv, ctx)
    itl = base_itl_s + itl_per_kv_usage_s * KV + itl_per_context_s * CTX
    thpt = decode_thpt_at_full_kv * KV
    return {
        "prefill_isl": isl,
        "prefill_ttft_s": base_ttft_s + ttft_per_token_s * isl,
        "prefill_thpt_per_chip": np.full_like(isl, prefill_thpt_per_chip),
        "decode_kv_usage": kv,
        "decode_context": ctx,
        "decode_itl_s": itl,
        "decode_thpt_per_chip": thpt,
        "max_kv_tokens": np.asarray([max_kv_tokens]),
    }
