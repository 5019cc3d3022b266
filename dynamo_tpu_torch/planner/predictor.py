"""Load predictors for the SLA planner (a copy of
dynamo_tpu/planner/predictor.py: numpy only, the same float64 arithmetic).

Same role as the upstream planner's load_predictor.py (constant / auto-ARIMA /
Prophet). This environment has neither pmdarima nor prophet, and neither is
necessary: the planner needs one-step-ahead forecasts of slowly-varying
aggregates. We provide:

  - ``constant``: next = last observed (the reference's ConstantPredictor).
  - ``ar``: autoregressive AR(p) fit by least squares over a sliding
    window — the workhorse of ARIMA without the package dependency; falls
    back to the last value until enough history exists or when the fit is
    degenerate.
  - ``holt``: Holt's double exponential smoothing (level + trend), the
    classic forecaster for load with drift; trend is dampened so a burst
    does not extrapolate to infinity.

All ignore NaNs, skip the initial idle period (leading zeros), and keep a
bounded window.

For the autoscaler's predictive pre-scaler (dynamo_tpu_torch/autoscaler/) every
predictor also answers ``predict_ahead(k)`` — the k-step-ahead forecast
used to scale BEFORE a ramp arrives instead of after the queue has built:

  - ``constant``/``ar`` iterate their one-step forecast;
  - ``holt`` sums the damped trend k steps out (a live ramp extrapolates
    ahead of itself);
  - ``seasonal`` (new) bins observations into a known period (the diurnal
    cycle of a serving fleet) and forecasts from the matching phase of
    earlier cycles — after one full cycle it sees the morning ramp coming
    while a reactive predictor is still looking at the overnight trough.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["BasePredictor", "ConstantPredictor", "ARPredictor",
           "HoltPredictor", "SeasonalPredictor", "make_predictor",
           "PREDICTORS"]


class BasePredictor:
    def __init__(self, window_size: int = 128):
        self.window_size = window_size
        self.buf: list[float] = []

    def observe(self, value: float) -> None:
        if value is None or math.isnan(value):
            value = 0.0
        if not self.buf and value == 0.0:
            return  # skip leading idle period
        self.buf.append(float(value))
        if len(self.buf) > self.window_size:
            del self.buf[: len(self.buf) - self.window_size]

    def last(self) -> float:
        return self.buf[-1] if self.buf else 0.0

    def predict(self) -> float:  # pragma: no cover - abstract
        raise NotImplementedError

    def predict_ahead(self, steps: int = 1) -> float:
        """k-step-ahead forecast; the default holds the one-step forecast
        flat (exact for ``constant``, conservative for anything that
        lacks a sharper multi-step story)."""
        return self.predict()


class ConstantPredictor(BasePredictor):
    def predict(self) -> float:
        return self.last()


class ARPredictor(BasePredictor):
    """AR(p) one-step forecast fit by least squares on the window."""

    def __init__(self, window_size: int = 128, order: int = 4,
                 min_points: int = 8):
        super().__init__(window_size)
        self.order = order
        self.min_points = min_points

    def predict(self) -> float:
        x = np.asarray(self.buf, np.float64)
        p = self.order
        if len(x) < max(self.min_points, p + 2) or np.ptp(x) == 0.0:
            return self.last()
        # rows: x[t] ~ c + sum_j a_j * x[t-j]
        T = len(x) - p
        A = np.ones((T, p + 1))
        for j in range(p):
            A[:, j + 1] = x[p - 1 - j : len(x) - 1 - j]
        y = x[p:]
        try:
            coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        except np.linalg.LinAlgError:
            return self.last()
        feats = np.concatenate([[1.0], x[-1 : -p - 1 : -1]])
        pred = float(feats @ coef)
        if not math.isfinite(pred):
            return self.last()
        return max(0.0, pred)

    def predict_ahead(self, steps: int = 1) -> float:
        """Iterated rollout: feed each one-step forecast back in as the
        newest observation and forecast again. Shares the fitted
        coefficients across steps (refitting on synthetic data would just
        launder the same information)."""
        if steps <= 1:
            return self.predict()
        x = np.asarray(self.buf, np.float64)
        p = self.order
        if len(x) < max(self.min_points, p + 2) or np.ptp(x) == 0.0:
            return self.last()
        T = len(x) - p
        A = np.ones((T, p + 1))
        for j in range(p):
            A[:, j + 1] = x[p - 1 - j : len(x) - 1 - j]
        y = x[p:]
        try:
            coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        except np.linalg.LinAlgError:
            return self.last()
        hist = list(x[-p:])
        pred = hist[-1]
        for _ in range(steps):
            feats = np.concatenate([[1.0], np.asarray(hist[::-1])])
            pred = float(feats @ coef)
            if not math.isfinite(pred):
                return self.last()
            pred = max(0.0, pred)
            hist = hist[1:] + [pred]
        return pred


class HoltPredictor(BasePredictor):
    """Holt double exponential smoothing with damped trend."""

    def __init__(self, window_size: int = 128, alpha: float = 0.5,
                 beta: float = 0.3, phi: float = 0.9):
        super().__init__(window_size)
        self.alpha, self.beta, self.phi = alpha, beta, phi

    def predict(self) -> float:
        if len(self.buf) < 2:
            return self.last()
        level, trend = self.buf[0], self.buf[1] - self.buf[0]
        for x in self.buf[1:]:
            prev = level
            level = self.alpha * x + (1 - self.alpha) * (level + self.phi * trend)
            trend = self.beta * (level - prev) + (1 - self.beta) * self.phi * trend
        return max(0.0, level + self.phi * trend)

    def predict_ahead(self, steps: int = 1) -> float:
        """Damped-trend extrapolation: level + sum_{i<=k} phi^i * trend."""
        if len(self.buf) < 2 or steps <= 1:
            return self.predict()
        level, trend = self.buf[0], self.buf[1] - self.buf[0]
        for x in self.buf[1:]:
            prev = level
            level = self.alpha * x + (1 - self.alpha) * (level + self.phi * trend)
            trend = self.beta * (level - prev) + (1 - self.beta) * self.phi * trend
        damp = sum(self.phi ** i for i in range(1, steps + 1))
        return max(0.0, level + damp * trend)


class SeasonalPredictor(BasePredictor):
    """Period-binned forecaster for cyclic load (the diurnal wave).

    Observations are assigned round-robin to ``period`` phase bins; the
    forecast for a phase is the recency-weighted mean of earlier cycles at
    that phase, plus a cycle-over-cycle drift term so a growing service
    doesn't get last week's amplitude. Until one full cycle has been seen
    there is nothing seasonal to say, so it behaves like Holt (damped
    trend) — the fallback keeps cold starts sane.
    """

    def __init__(self, window_size: int = 0, period: int = 24,
                 decay: float = 0.5):
        # keep >= 4 cycles of history by default
        super().__init__(window_size or max(128, 4 * period))
        if period < 2:
            raise ValueError("seasonal period must be >= 2")
        self.period = period
        self.decay = decay
        self._fallback = HoltPredictor(window_size=max(16, period))

    def observe(self, value: float) -> None:
        super().observe(value)
        if self.buf:  # leading zeros were skipped by super()
            self._fallback.observe(self.buf[-1])

    def _phase_forecast(self, offset: int) -> float:
        """Forecast for the observation ``offset`` steps after the last."""
        n = len(self.buf)
        phase = (n - 1 + offset) % self.period
        # samples at this phase, most recent last
        idx = [i for i in range(n) if i % self.period == phase]
        if not idx:
            return self._fallback.predict_ahead(offset)
        vals = [self.buf[i] for i in idx]
        w = [self.decay ** (len(vals) - 1 - j) for j in range(len(vals))]
        base = sum(v * wi for v, wi in zip(vals, w)) / sum(w)
        # cycle-over-cycle drift: how much the latest cycle runs above the
        # one before it, averaged over the phases both cycles cover
        if n >= 2 * self.period:
            cur = self.buf[n - self.period : n]
            prev = self.buf[n - 2 * self.period : n - self.period]
            drift = sum(c - p for c, p in zip(cur, prev)) / self.period
        else:
            drift = 0.0
        return max(0.0, base + drift)

    def predict(self) -> float:
        if len(self.buf) < self.period:
            return self._fallback.predict()
        return self._phase_forecast(1)

    def predict_ahead(self, steps: int = 1) -> float:
        if len(self.buf) < self.period:
            return self._fallback.predict_ahead(steps)
        return self._phase_forecast(max(1, steps))


PREDICTORS = {
    "constant": ConstantPredictor,
    "ar": ARPredictor,
    "arima": ARPredictor,  # reference flag compatibility
    "holt": HoltPredictor,
    "prophet": HoltPredictor,  # reference flag compatibility
    "seasonal": SeasonalPredictor,
}


def make_predictor(kind: str, window_size: int = 128,
                   **kwargs) -> BasePredictor:
    """Extra ``kwargs`` go to the predictor class (e.g. ``period=`` for
    ``seasonal``); classes that don't take them raise, which is the right
    error for a misconfigured plan."""
    try:
        cls = PREDICTORS[kind]
    except KeyError:
        raise ValueError(
            f"unknown predictor {kind!r}; choose from {sorted(PREDICTORS)}"
        ) from None
    return cls(window_size=window_size, **kwargs)
