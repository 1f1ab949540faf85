"""The worker's profiling mode: TTFT/TPOT samples measured on the live
engine for its registration.

A copy of ``profile_engine`` from the JAX package's
``service/time_predictor.py``: the same prompt lengths, batches, request
ids and sampling, so that a port worker's ``ttft_profiling_data`` /
``tpot_profiling_data`` have the JAX worker's shape. The master fits each
instance's latency predictor from them (a degree-2 TTFT polynomial in
the prompt length, a linear TPOT model in the batch and its context);
the predictor itself belongs to the service plane, which this package
does not carry.
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple

from xllm_service_tpu_torch.utils.types import SamplingParams


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
