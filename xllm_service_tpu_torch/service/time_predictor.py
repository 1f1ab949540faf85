"""TTFT/TPOT latency predictors for SLO-aware routing, and the worker's
profiling mode that feeds them.

A copy of the JAX package's ``service/time_predictor.py``.
``TimePredictor`` (reference ``common/time_predictor.{h,cpp}``) is the
master's per-instance model: a degree-2 polynomial TTFT fit over the
prompt length and a linear TPOT model ``c0 + c1*batch +
c2*batch*(seq_len-1)``, both numpy least squares. ``profile_engine``
measures the samples on the live engine for a worker's registration
(the same prompt lengths, batches, request ids and sampling as the JAX
worker's). The module imports no engine at import time: the engine is
imported inside ``profile_engine``, so the master, which loads only the
predictor, touches no device.
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np

from xllm_service_tpu_torch.utils.types import SamplingParams


class TimePredictor:
    """Per-instance latency model fit from registration profiling data."""

    def __init__(self) -> None:
        self._ttft_coef: np.ndarray | None = None      # [c0, c1, c2]
        self._tpot_coef: np.ndarray | None = None      # [c0, c1, c2]

    @property
    def has_ttft(self) -> bool:
        return self._ttft_coef is not None

    @property
    def has_tpot(self) -> bool:
        return self._tpot_coef is not None

    def fit_ttft(self, samples: Sequence[Tuple[float, float]]) -> bool:
        """samples: [(num_prompt_tokens, ttft_ms)]; fits
        ttft ≈ c0 + c1*n + c2*n²."""
        if len(samples) < 3:
            return False
        n = np.asarray([s[0] for s in samples], np.float64)
        y = np.asarray([s[1] for s in samples], np.float64)
        A = np.stack([np.ones_like(n), n, n * n], axis=1)
        self._ttft_coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        return True

    def fit_tpot(self,
                 samples: Sequence[Tuple[float, float, float]]) -> bool:
        """samples: [(batch, seq_len, tpot_ms)]; fits
        tpot ≈ c0 + c1*batch + c2*batch*(seq_len-1)."""
        if len(samples) < 3:
            return False
        b = np.asarray([s[0] for s in samples], np.float64)
        t = np.asarray([s[1] for s in samples], np.float64)
        y = np.asarray([s[2] for s in samples], np.float64)
        A = np.stack([np.ones_like(b), b, b * (t - 1.0)], axis=1)
        self._tpot_coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        return True

    def predict_ttft(self, num_tokens: int) -> float:
        if self._ttft_coef is None:
            return 0.0
        c = self._ttft_coef
        return float(c[0] + c[1] * num_tokens + c[2] * num_tokens ** 2)

    def predict_tpot(self, total_tokens: int, num_requests: int) -> float:
        """Predicted per-token latency with ``num_requests`` decoding and
        ``total_tokens`` total context across them (reference call shape:
        instance_mgr.cpp:849-877)."""
        if self._tpot_coef is None:
            return 0.0
        c = self._tpot_coef
        b = float(max(num_requests, 1))
        mean_len = float(total_tokens) / b
        return float(c[0] + c[1] * b + c[2] * b * (mean_len - 1.0))

    @classmethod
    def from_profiling(cls, ttft: Sequence[Tuple[float, float]],
                       tpot: Sequence[Tuple[float, float, float]]
                       ) -> "TimePredictor":
        p = cls()
        p.fit_ttft(ttft)
        p.fit_tpot(tpot)
        return p



def profile_engine(engine, prompt_lens: Sequence[int] = (32, 64, 128),
                   batches: Sequence[int] = (1, 2, 4)
                   ) -> Tuple[List[Tuple[float, float]],
                              List[Tuple[float, float, float]]]:
    """Run the profile on ``engine`` (idle, driven from this thread) and
    return ``([(prompt tokens, ttft_ms)], [(batch, seq_len, tpot_ms)])``.
    TTFT: one request of ``[1] * n`` tokens and one sampled token, timed
    from its admission to idle, for each length that fits the largest
    prefill bucket. TPOT: ``b`` requests of 32 tokens and 8 new ones;
    once none waits, the remaining steps' mean time, for each batch that
    fits ``max_batch_size``. The prompts register their prefix-cache
    blocks, as the JAX engine's do."""
    from xllm_service_tpu_torch.runtime.engine import EngineRequest

    ttft_samples: List[Tuple[float, float]] = []
    tpot_samples: List[Tuple[float, float, float]] = []
    max_prompt = engine.ecfg.prefill_buckets[-1]
    for n in prompt_lens:
        if n > max_prompt:
            continue
        t0 = time.monotonic()
        engine.add_request(EngineRequest(
            request_id=f"__profile_ttft_{n}", token_ids=[1] * n,
            sampling=SamplingParams(max_tokens=1, ignore_eos=True)))
        while engine.has_work():
            engine.step()
        ttft_samples.append((float(n), 1000.0 * (time.monotonic() - t0)))
    gen = 8
    for b in batches:
        if b > engine.ecfg.max_batch_size:
            continue
        n = min(32, max_prompt)
        for i in range(b):
            engine.add_request(EngineRequest(
                request_id=f"__profile_tpot_{b}_{i}", token_ids=[1] * n,
                sampling=SamplingParams(max_tokens=gen, ignore_eos=True)))
        while engine.waiting:
            engine.step()
        t0 = time.monotonic()
        steps = 0
        while engine.has_work():
            engine.step()
            steps += 1
        if steps > 1:
            tpot_ms = 1000.0 * (time.monotonic() - t0) / steps
            tpot_samples.append((float(b), float(n + gen), tpot_ms))
    return ttft_samples, tpot_samples
