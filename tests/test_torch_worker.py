"""The port's worker on the CPU against the JAX package's worker: both
serve OpenAI requests straight to the worker with the byte tokenizer
and the same tiny float32 weights (the JAX engine's random init,
``init_params(cfg, PRNGKey(0))``). At temperature 0 the texts must be
equal, and the SSE streams must parse and end in ``[DONE]``."""

import dataclasses
import json
from http.client import HTTPConnection

import numpy as np
import jax
import pytest
import torch

from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.runtime import worker as jax_worker
from xllm_service_tpu.service.coordination import InMemoryStore
from xllm_service_tpu_torch.config import ModelConfig
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.runtime import worker as torch_worker


def _post(addr, path, obj):
    host, port = addr.rsplit(":", 1)
    conn = HTTPConnection(host, int(port), timeout=120)
    try:
        conn.request("POST", path, body=json.dumps(obj),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read().decode("utf-8", "replace")
    finally:
        conn.close()


def _sse(body):
    """Frames of an SSE body: parsed JSON objects, then "[DONE]"."""
    frames = [f[len("data: "):] for f in body.split("\n\n") if f]
    assert all(f for f in frames)
    assert frames[-1] == "[DONE]", frames[-3:]
    return [json.loads(f) for f in frames[:-1]]


def _stream_text(frames, is_chat):
    frames = [f for f in frames if f["choices"]]     # not the usage chunk
    if is_chat:
        assert frames[0]["choices"][0]["delta"] == {"role": "assistant"}
        return "".join(f["choices"][0]["delta"].get("content", "")
                       for f in frames)
    return "".join(f["choices"][0]["text"] for f in frames)


@pytest.fixture(scope="module")
def workers():
    jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=512),
                               dtype="float32")
    tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=512),
                               dtype="float32")
    mp = pytest.MonkeyPatch()
    mp.setitem(jax_worker._MODEL_REGISTRY, "tiny", lambda: jcfg)
    jw = jax_worker.Worker(jax_worker.WorkerOptions(model="tiny"),
                           InMemoryStore()).start()
    params = params_from_jax(
        jax.tree_util.tree_map(np.asarray,
                               jtf.init_params(jcfg, jax.random.PRNGKey(0))),
        tcfg, "cpu")
    tw = torch_worker.Worker(
        torch_worker.WorkerOptions(model="tiny", device="cpu"),
        model_cfg=tcfg, params=params).start()
    try:
        yield jw.name, tw.name
    finally:
        tw.stop()
        jw.stop()
        mp.undo()


REQUESTS = [
    ("/v1/completions", {"prompt": "The quick brown fox", "max_tokens": 12,
                         "temperature": 0.0}),
    ("/v1/completions", {"prompt": "hello, worker", "max_tokens": 9,
                         "temperature": 0.0, "logprobs": 0}),
    ("/v1/chat/completions", {"messages": [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "what is a page table?"}],
        "max_tokens": 10, "temperature": 0.0}),
]


@pytest.mark.parametrize("path,body", REQUESTS)
def test_non_stream_text_matches_jax_worker(workers, path, body):
    jax_addr, torch_addr = workers
    js, jbody = _post(jax_addr, path, body)
    ts, tbody = _post(torch_addr, path, body)
    assert js == ts == 200, (jbody, tbody)
    jr, tr = json.loads(jbody), json.loads(tbody)
    is_chat = "messages" in body
    key = (lambda c: c["message"]["content"]) if is_chat else \
        (lambda c: c["text"])
    assert key(tr["choices"][0]) == key(jr["choices"][0])
    assert tr["choices"][0]["finish_reason"] == \
        jr["choices"][0]["finish_reason"]
    assert tr["usage"] == jr["usage"]
    assert tr["object"] == jr["object"]
    if "logprobs" in body:
        jl = jr["choices"][0]["logprobs"]
        tl = tr["choices"][0]["logprobs"]
        assert tl["tokens"] == jl["tokens"]
        np.testing.assert_allclose(tl["token_logprobs"],
                                   jl["token_logprobs"], atol=1e-4)


@pytest.mark.parametrize("path,body", REQUESTS)
def test_stream_text_matches_jax_worker(workers, path, body):
    jax_addr, torch_addr = workers
    body = {**body, "stream": True,
            "stream_options": {"include_usage": True}}
    is_chat = "messages" in body
    js, jbody = _post(jax_addr, path, body)
    ts, tbody = _post(torch_addr, path, body)
    assert js == ts == 200
    jf, tf = _sse(jbody), _sse(tbody)
    assert _stream_text(tf, is_chat) == _stream_text(jf, is_chat)
    # Same chunk grammar: finish chunk, then the usage chunk.
    assert tf[-1]["usage"] == jf[-1]["usage"]
    assert tf[-2]["choices"][0]["finish_reason"] == \
        jf[-2]["choices"][0]["finish_reason"]
    assert [f["object"] for f in tf] == [f["object"] for f in jf][:len(tf)]


def test_routes_and_refusals(workers):
    _, torch_addr = workers
    host, port = torch_addr.rsplit(":", 1)
    conn = HTTPConnection(host, int(port), timeout=30)
    for path, want in (("/hello", {"ok": True}), ("/v1/models", None)):
        conn.request("GET", path)
        r = conn.getresponse()
        body = json.loads(r.read())
        assert r.status == 200
        if want is not None:
            assert body == want
        else:
            assert body["data"][0]["id"] == "tiny"
    conn.close()
    status, body = _post(torch_addr, "/v1/completions",
                         {"prompt": "x", "n": 2})
    assert status == 400 and "not supported" in body
    status, _ = _post(torch_addr, "/v1/completions",
                      {"prompt": "x" * 5000})     # past max_model_len
    assert status == 400
    status, body = _post(torch_addr, "/v1/completions",
                         {"prompt": "stop here please", "max_tokens": 30,
                          "temperature": 0.0, "stop": ["e"]})
    assert status == 200 and "e" not in json.loads(body)[
        "choices"][0]["text"]


def test_worker_needs_a_gpu_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_worker.Worker(torch_worker.WorkerOptions(model="tiny"))
    with pytest.raises(RuntimeError):
        torch_worker.main(["--model", "tiny"])
