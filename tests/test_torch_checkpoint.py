"""The port's checkpoint loader and writer against the JAX package's, on
the CPU, and the port worker booted from a model directory.

- The format: the port's reader on files the ``safetensors`` package
  wrote (each dtype the JAX loader meets), ``safetensors.safe_open`` on
  the port's writer, bit for bit.
- The families: a directory written by the JAX ``save_checkpoint`` (or a
  random-init ``transformers`` model's ``save_pretrained``) loads through
  the JAX ``load_checkpoint`` and the port's into bit-equal leaves (the
  file float32, the leaves bfloat16: the cast is the one rounding), and
  the float32 leaves give the JAX forward's logits within
  ``tests/test_torch_model.py``'s tolerance (atol = rtol = 1e-4).
- MLA: DeepSeek-V2 with and without ``q_lora_rank``, with one dense
  layer and with none.
- The writer: ``save_checkpoint`` writes the JAX writer's tensors and
  ``config.json``, and refuses MLA and GPT-OSS trees.
- The worker: a port worker on a directory with a ``tokenizer.json``
  (a tiny BPE) resolves the JAX worker's config and serves its text at
  temperature 0; a warm and a cold wake keep the boot's weights.
- F6: ``/fork_master`` with every JAX catalog name stages the same
  models, with the same configs, on a port and on a JAX worker.
"""

import ast
import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.config import (EngineConfig as JaxEngineConfig,
                                     InstanceType as JaxInstanceType,
                                     ModelConfig as JaxModelConfig)
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.runtime import checkpoint as jck
from xllm_service_tpu.runtime import worker as jax_worker
from xllm_service_tpu.service.coordination import \
    InMemoryStore as JaxInMemoryStore
from xllm_service_tpu.service.httpd import http_json
from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models import transformer as ttf
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.runtime import checkpoint as tck
from xllm_service_tpu_torch.runtime import worker as torch_worker
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
ENGINE = dict(page_size=16, num_pages=64, max_model_len=256,
              max_batch_size=4, max_prefill_tokens=256,
              prefill_buckets=(32, 64, 128))


def _bits(x) -> np.ndarray:
    """A leaf's bit pattern (JAX array, numpy array or torch tensor)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.dtype(f"i{x.element_size()}"))
    a = np.asarray(x)
    return a.view(np.dtype(f"i{a.dtype.itemsize}"))


def _same_leaves(tparams, jparams):
    """Every leaf bit-equal, in shape and dtype width, and the trees
    alike."""
    flat_j = dict((tuple(p.key for p in path), leaf) for path, leaf in
                  jax.tree_util.tree_leaves_with_path(jparams))
    flat_t = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat_t[prefix + (k,)] = v
    walk(tparams, ())
    assert sorted(flat_t) == sorted(flat_j)
    for k, leaf in flat_j.items():
        t = flat_t[k]
        assert tuple(t.shape) == tuple(leaf.shape), k
        assert t.element_size() == np.asarray(leaf).dtype.itemsize, k
        np.testing.assert_array_equal(_bits(t), _bits(leaf), err_msg=str(k))


# ---------------------------------------------------------------------------
# The format
# ---------------------------------------------------------------------------

FORMAT_DTYPES = ("F32", "F16", "BF16", "U8", "I32", "I64")


def _sample(dtype_name: str, shape, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    dt = tck._DTYPES[dtype_name]
    if dt.is_floating_point:
        x = torch.randn(shape, generator=g).to(dt)
        if x.numel() >= 3:
            x.view(-1)[:3] = torch.tensor([float("inf"), -0.0,
                                           float("nan")])
        return x
    info = torch.iinfo(dt)
    return torch.randint(max(info.min, -2 ** 40), min(info.max, 2 ** 40),
                         shape, generator=g, dtype=torch.int64).to(dt)


@pytest.mark.parametrize("dtype_name", FORMAT_DTYPES)
def test_reader_reads_safetensors_files(tmp_path, dtype_name):
    """The port's reader on a file of the ``safetensors`` package (its
    numpy writer where numpy has the dtype, its torch writer for bf16),
    an empty and a 0-d tensor among them: names, shapes, dtypes and
    bytes."""
    from safetensors.numpy import save_file as np_save
    from safetensors.torch import save_file as pt_save
    want = {"a.weight": _sample(dtype_name, (3, 5, 7), 0),
            "b": _sample(dtype_name, (11,), 1),
            "empty": _sample(dtype_name, (0, 4), 2),
            "scalar": _sample(dtype_name, (), 3)}
    path = str(tmp_path / "x.safetensors")
    if dtype_name == "BF16":
        pt_save(want, path, metadata={"k": "v"})
    else:
        np_save({k: v.numpy() for k, v in want.items()}, path,
                metadata={"k": "v"})
    f = tck.SafetensorsFile(path)
    assert sorted(f.keys()) == sorted(want) and f.metadata == {"k": "v"}
    for k, v in want.items():
        got = f.get(k)
        assert got.dtype == v.dtype and tuple(got.shape) == tuple(v.shape)
        np.testing.assert_array_equal(_bits(got), _bits(v))
    # Writable, and the file untouched by a write.
    got = f.get("b")
    got.zero_()
    np.testing.assert_array_equal(
        _bits(tck.SafetensorsFile(path).get("b")), _bits(want["b"]))


@pytest.mark.parametrize("dtype_name", FORMAT_DTYPES + ("BOOL",))
def test_writer_read_by_safe_open(tmp_path, dtype_name):
    """``safetensors.safe_open`` on the port's writer, bit for bit, the
    tensors given as views (a transpose, a slice) and on their own
    storage, beside tensors of other widths."""
    from safetensors import safe_open
    if dtype_name == "BOOL":
        gen = torch.Generator().manual_seed(0)
        base = torch.rand(6, 4, generator=gen) > 0.5
    else:
        base = _sample(dtype_name, (6, 4), 0)
    want = {"t": base.t(), "slice": base[1:4], "plain": base,
            "wide": torch.arange(5, dtype=torch.float64),
            "narrow": torch.arange(3, dtype=torch.uint8),
            "empty": base[:0]}
    path = str(tmp_path / "y.safetensors")
    n = tck.save_file(want, path, metadata={"format": "pt"})
    assert n == sum(v.numel() * v.element_size() for v in want.values())
    with safe_open(path, framework="pt") as f:
        assert sorted(f.keys()) == sorted(want)
        assert f.metadata() == {"format": "pt"}
        for k, v in want.items():
            got = f.get_tensor(k)
            assert got.dtype == v.dtype and got.shape == v.shape
            np.testing.assert_array_equal(_bits(got), _bits(v))


def test_checkpoint_module_imports_no_format_package():
    """The card has torch and numpy only: the checkpoint module imports
    the standard library, numpy, torch and the port itself."""
    import sys
    path = ROOT / "xllm_service_tpu_torch" / "runtime" / "checkpoint.py"
    tree = ast.parse(path.read_text(encoding="utf-8"))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add((node.module or "").split(".")[0])
    allowed = set(sys.stdlib_module_names) | {
        "numpy", "torch", "xllm_service_tpu_torch", "__future__"}
    assert names <= allowed, names - allowed


# ---------------------------------------------------------------------------
# The families
# ---------------------------------------------------------------------------

FAMILIES = {
    "llama_tied": {"tie_word_embeddings": True},
    "llama": {},
    "qwen2": {"attention_bias": True},
    "qwen3": {"qk_norm": True},
    "phi3": {"fused_proj": True, "sliding_window": 9},
    "mistral": {"sliding_window": 9},
    "gemma2": {"gemma": True, "sliding_window": 6,
               "layer_sliding": (True, False),
               "attn_logit_softcapping": 30.0,
               "final_logit_softcapping": 20.0,
               "query_pre_attn_scalar": 32, "tie_word_embeddings": True},
    "mixtral": {"num_experts": 4, "moe_capacity_factor": 0.0},
    "qwen3_moe": {"num_experts": 4, "qwen_moe": True, "qk_norm": True,
                  "moe_intermediate_size": 48, "moe_capacity_factor": 0.0},
    # Layouts of the directory, on llama's tree.
    "vlm_nested": {},
    "two_shards": {},
}


def _jax_cfg(family: str, dtype: str) -> JaxModelConfig:
    return dataclasses.replace(JaxModelConfig.tiny(vocab_size=96),
                               **FAMILIES[family], dtype=dtype)


def _perturbed_jax_params(cfg: JaxModelConfig, seed: int):
    """JAX ``init_params`` with the norms and biases moved off their
    ones and zeros, as numpy float32."""
    params = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for k, v in list(params["layers"].items()):
        if "norm" in k or "bias" in k or k == "sinks":
            params["layers"][k] = (v + 0.3 * rng.standard_normal(v.shape)
                                   ).astype(np.float32)
    params["final_norm"] = (params["final_norm"] + 0.3 * rng.standard_normal(
        params["final_norm"].shape)).astype(np.float32)
    return params


def _relayout(model_dir: str, family: str) -> None:
    """Nest the text stack under ``model.language_model.*`` (a VLM's
    file), or cut the file into two shards with an index."""
    from safetensors.numpy import load_file, save_file
    if family not in ("vlm_nested", "two_shards"):
        return
    path = os.path.join(model_dir, "model.safetensors")
    tensors = load_file(path)
    os.remove(path)
    if family == "vlm_nested":
        save_file({("model.language_model." + k[len("model."):]
                    if k.startswith("model.") else k): v
                   for k, v in tensors.items()}, path)
        return
    names = sorted(tensors)
    shards = {"model-00001-of-00002.safetensors": names[::2],
              "model-00002-of-00002.safetensors": names[1::2]}
    weight_map = {}
    for fname, keys in shards.items():
        save_file({k: tensors[k] for k in keys},
                  os.path.join(model_dir, fname))
        weight_map.update({k: fname for k in keys})
    with open(os.path.join(model_dir, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)


@pytest.fixture(scope="module")
def family_dirs(tmp_path_factory):
    """Each family's directory, written by the JAX ``save_checkpoint``
    from float32 weights."""
    out = {}
    for i, family in enumerate(FAMILIES):
        d = str(tmp_path_factory.mktemp(family))
        cfg = _jax_cfg(family, "float32")
        jck.save_checkpoint(_perturbed_jax_params(cfg, i), cfg, d)
        _relayout(d, family)
        out[family] = d
    return out


def _both_configs(model_dir: str, dtype: str):
    """The directory's config as each package resolves it, in ``dtype``,
    the dense oracle for MoE (capacity off, on both sides)."""
    jcfg = jax_worker.resolve_model_config("m", model_dir)
    tcfg = torch_worker.resolve_model_config("m", model_dir)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    kw = {"dtype": dtype}
    if jcfg.is_moe:
        kw["moe_capacity_factor"] = 0.0
    return (dataclasses.replace(jcfg, **kw),
            dataclasses.replace(tcfg, **kw))


def _prefill_logits(jparams, jcfg, tparams, tcfg):
    """One prefill window (B = 2, lengths 16 and 11) through both
    packages' forwards, write-then-attend."""
    rng = np.random.default_rng(7)
    P, ps, B, MP = 16, 8, 2, 4
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    win = rng.integers(3, jcfg.vocab_size, size=(B, 16)).astype(np.int32)
    lens = np.array([16, 11], np.int32)
    st = np.zeros(B, np.int32)
    jl, _, _ = jtf.forward_prefill(
        jparams, jcfg, jnp.asarray(win), jnp.asarray(st), jnp.asarray(lens),
        jtf.init_kv_cache(jcfg, P, ps), jnp.asarray(pt),
        write_then_attend=True)
    tl, _ = ttf.forward_prefill(
        tparams, tcfg, torch.from_numpy(win).long(), torch.from_numpy(st),
        torch.from_numpy(lens), ttf.init_kv_cache(tcfg, P, ps, "cpu"),
        torch.from_numpy(pt))
    return np.asarray(jl), tl.numpy()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_loads_as_jax(family_dirs, family):
    """bf16 leaves bit-equal to the JAX loader's from the same float32
    file; float32 leaves give the JAX forward's logits."""
    d = family_dirs[family]
    jcfg, tcfg = _both_configs(d, "bfloat16")
    stats = {}
    _same_leaves(tck.load_checkpoint(d, tcfg, "cpu", stats=stats),
                 jck.load_checkpoint(d, jcfg))
    files = tck.checkpoint_files(d)
    assert stats["bytes_read"] == sum(
        os.path.getsize(f) for f in files) - sum(
        8 + int.from_bytes(open(f, "rb").read(8), "little") for f in files)
    jcfg, tcfg = _both_configs(d, "float32")
    jparams = jck.load_checkpoint(d, jcfg)
    tparams = tck.load_checkpoint(d, tcfg, "cpu")
    _same_leaves(tparams, jparams)
    if family == "llama":
        # Tied without saying so: no lm_head in the file, config untied.
        from safetensors.numpy import load_file, save_file
        path = os.path.join(d, "model.safetensors")
        tensors = load_file(path)
        untied_dir = d + "_untied"
        os.makedirs(untied_dir)
        save_file({k: v for k, v in tensors.items()
                   if k != "lm_head.weight"},
                  os.path.join(untied_dir, "model.safetensors"))
        with open(os.path.join(d, "config.json")) as f, \
                open(os.path.join(untied_dir, "config.json"), "w") as g:
            g.write(f.read())
        ucfg_j, ucfg_t = _both_configs(untied_dir, "bfloat16")
        mine = tck.load_checkpoint(untied_dir, ucfg_t, "cpu")
        _same_leaves(mine, jck.load_checkpoint(untied_dir, ucfg_j))
        assert mine["lm_head"].is_contiguous()
    jl, tl = _prefill_logits(jax.tree_util.tree_map(jnp.asarray, jparams),
                             jcfg, tparams, tcfg)
    np.testing.assert_allclose(tl, jl, **TOL)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

MLA_CASES = {
    "q_lora_none_dense1": {"q_lora_rank": None, "first_k_dense_replace": 1},
    "q_lora_24_dense1": {"q_lora_rank": 24, "first_k_dense_replace": 1},
    "q_lora_none_dense0": {"q_lora_rank": None, "first_k_dense_replace": 0},
    "q_lora_24_dense0": {"q_lora_rank": 24, "first_k_dense_replace": 0},
}


def _deepseek_dir(path: str, seed: int, **kw) -> str:
    from transformers import DeepseekV2Config, DeepseekV2ForCausalLM
    torch.manual_seed(seed)
    cfg = DeepseekV2Config(
        vocab_size=96, hidden_size=64, intermediate_size=96,
        moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=4, n_routed_experts=4, num_experts_per_tok=2,
        n_shared_experts=1, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, max_position_embeddings=256,
        **kw)
    model = DeepseekV2ForCausalLM(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(0.3 * torch.randn_like(p))
    model.save_pretrained(path)
    return path


@pytest.mark.parametrize("case", sorted(MLA_CASES))
def test_mla_loads_as_jax(tmp_path, case):
    """DeepSeek-V2 directories of ``transformers``: bit-equal leaves,
    both ``q_lora_rank`` forms, ``first_k_dense_replace`` 1 and 0 (an
    empty dense stack, which the forward walks zero times), and the
    JAX forward's logits."""
    d = _deepseek_dir(str(tmp_path / case), 3, **MLA_CASES[case])
    jcfg, tcfg = _both_configs(d, "bfloat16")
    assert tcfg.mla
    _same_leaves(tck.load_checkpoint(d, tcfg, "cpu"),
                 jck.load_checkpoint(d, jcfg))
    jcfg, tcfg = _both_configs(d, "float32")
    tparams = tck.load_checkpoint(d, tcfg, "cpu")
    if not MLA_CASES[case]["first_k_dense_replace"]:
        assert tparams["layers"]["input_norm"].shape[0] == 0
    jl, tl = _prefill_logits(jck.load_checkpoint(d, jcfg), jcfg, tparams,
                             tcfg)
    np.testing.assert_allclose(tl, jl, **TOL)


def test_deepseek_v3_selection_bias_loads_as_jax(tmp_path):
    """V3's ``e_score_correction_bias`` (float32, its own leaf) beside the
    sigmoid gate, in the JAX loader's layout."""
    from safetensors.numpy import load_file, save_file
    d = _deepseek_dir(str(tmp_path / "v3"), 4, q_lora_rank=24,
                      first_k_dense_replace=1)
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    hf.update(model_type="deepseek_v3", n_group=2, topk_group=1,
              topk_method="noaux_tc", scoring_func="sigmoid",
              norm_topk_prob=True, routed_scaling_factor=2.5)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf, f)
    path = os.path.join(d, "model.safetensors")
    tensors = load_file(path)
    rng = np.random.default_rng(0)
    for i in (1, 2):
        tensors[f"model.layers.{i}.mlp.gate.e_score_correction_bias"] = \
            rng.standard_normal(4).astype(np.float32)
    save_file(tensors, path)
    jcfg, tcfg = _both_configs(d, "bfloat16")
    assert tcfg.moe_scoring == "sigmoid"
    mine = tck.load_checkpoint(d, tcfg, "cpu")
    assert mine["layers_moe"]["router_bias"].dtype == torch.float32
    _same_leaves(mine, jck.load_checkpoint(d, jcfg))


# ---------------------------------------------------------------------------
# The writer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(set(FAMILIES) - {
    "vlm_nested", "two_shards"}) + ["llama3_rope", "bf16"])
def test_save_checkpoint_writes_what_jax_writes(tmp_path, family):
    """Same tensors, bit for bit, and the same ``config.json``; the
    port's file round-trips through its own loader."""
    from safetensors import safe_open
    if family == "llama3_rope":
        jcfg = dataclasses.replace(
            JaxModelConfig.tiny(vocab_size=96), dtype="float32",
            rope_scaling=("llama3", 8.0, 1.0, 4.0, 64))
    elif family == "bf16":
        jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=96),
                                   attention_bias=True, qk_norm=True)
    else:
        jcfg = _jax_cfg(family, "float32")
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jparams = _perturbed_jax_params(jcfg, 5)
    if jcfg.dtype == "bfloat16":
        import ml_dtypes
        jparams = jax.tree_util.tree_map(
            lambda x: x.astype(ml_dtypes.bfloat16), jparams)
    tparams = params_from_jax(jparams, tcfg, "cpu")
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jck.save_checkpoint(jparams, jcfg, jd)
    assert tck.save_checkpoint(tparams, tcfg, td) > 0
    with open(os.path.join(jd, "config.json")) as f, \
            open(os.path.join(td, "config.json")) as g:
        assert json.load(g) == json.load(f)
    with safe_open(os.path.join(jd, "model.safetensors"), "pt") as a, \
            safe_open(os.path.join(td, "model.safetensors"), "pt") as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a.keys():
            x, y = a.get_tensor(k), b.get_tensor(k)
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(_bits(y), _bits(x), err_msg=k)
    back = tck.load_checkpoint(td, dataclasses.replace(tcfg), "cpu")
    # The Gemma fold round-trips within one rounding of its +1 / -1.
    if not jcfg.gemma:
        _same_leaves(back, jparams if jcfg.dtype == "float32" else
                     jck.load_checkpoint(jd, jcfg))


def test_save_checkpoint_refuses_mla_and_gptoss(tmp_path):
    for cfg in (ModelConfig.deepseek_v2_lite(), ModelConfig.gpt_oss_20b()):
        with pytest.raises(NotImplementedError):
            tck.save_checkpoint({}, cfg, str(tmp_path))
        with pytest.raises(NotImplementedError):
            jck.save_checkpoint({}, JaxModelConfig(**dataclasses.asdict(cfg)),
                                str(tmp_path))


# ---------------------------------------------------------------------------
# The worker on a model directory
# ---------------------------------------------------------------------------

def _bpe_tokenizer(path: str) -> None:
    """A tiny byte-level BPE (its vocabulary within the model's 512),
    with an end-of-text token, as ``tokenizer.json``."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, \
        trainers
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=320, special_tokens=["<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    corpus = ["the page table holds the kernel's pages",
              "a decode step reads every cached token once",
              "prefill windows write their keys and values"] * 20
    tok.train_from_iterator(corpus, trainer)
    tok.save(path)


@pytest.fixture(scope="module")
def served_dir(tmp_path_factory):
    """A tiny llama directory: a float32 checkpoint of the JAX writer
    and a BPE ``tokenizer.json``."""
    d = str(tmp_path_factory.mktemp("served"))
    cfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=512),
                              dtype="float32")
    jck.save_checkpoint(_perturbed_jax_params(cfg, 11), cfg, d)
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    hf["torch_dtype"] = "float32"
    hf["eos_token_id"] = 0
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf, f)
    _bpe_tokenizer(os.path.join(d, "tokenizer.json"))
    return d


PROMPTS = ("the page table", "a decode step reads", "prefill windows")


def _completions(addr: str):
    out = []
    for p in PROMPTS:
        status, resp = http_json("POST", addr, "/v1/completions", {
            "model": "m", "prompt": p, "max_tokens": 8,
            "temperature": 0.0, "ignore_eos": True}, timeout=120.0)
        assert status == 200, resp
        out.append(resp["choices"][0]["text"])
    return out


def _float32(mp):
    """Both packages' ``from_hf_config`` pinned to float32 (the
    directory's weights), so that the engines compute alike."""
    for mod in (jax_worker, torch_worker):
        orig = mod.resolve_model_config

        def pinned(name, model_dir="", orig=orig):
            return dataclasses.replace(orig(name, model_dir),
                                       dtype="float32")
        mp.setattr(mod, "resolve_model_config", pinned)


def test_worker_serves_a_model_directory_as_jax(served_dir):
    """The port worker on ``model_dir``: the JAX worker's config, its
    tokenizer, its temperature-0 texts; after /sleep + /wakeup (warm)
    and a cold wake from disk, the boot's weights."""
    jcfg = jax_worker.resolve_model_config("m", served_dir)
    tcfg = torch_worker.resolve_model_config("m", served_dir)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    mp = pytest.MonkeyPatch()
    _float32(mp)
    tw = torch_worker.Worker(
        torch_worker.WorkerOptions(model="m", device="cpu",
                                   model_dir=served_dir),
        engine_cfg=EngineConfig(**ENGINE)).start()
    jw = jax_worker.Worker(
        jax_worker.WorkerOptions(port=0, model="m", model_dir=served_dir,
                                 instance_type=JaxInstanceType.DEFAULT),
        JaxInMemoryStore(sweep_interval_s=0.05),
        engine_cfg=JaxEngineConfig(**ENGINE)).start()
    try:
        assert type(tw.tokenizer).__name__ == "HFTokenizer"
        assert tw.tokenizer.encode("the page") == \
            jw.tokenizer.encode("the page")
        rt = tw.primary_runtime()
        assert rt.timings["source"] == "checkpoint"
        assert rt.timings["load_bytes"] > 0
        boot = tck.param_digests(tw.engine.params)
        want = tck.param_digests(tck.load_checkpoint(
            served_dir, dataclasses.replace(tcfg, dtype="float32"), "cpu"))
        assert boot == want
        status, body = http_json("GET", tw.name, "/admin/weights?model=m")
        assert status == 200 and body["digests"] == boot
        assert body["source"] == "checkpoint"
        texts = _completions(tw.name)
        assert texts == _completions(jw.name)
        for route in ("/sleep", "/wakeup"):
            status, resp = http_json("POST", tw.name, route, {"model": "m"},
                                     timeout=120.0)
            assert status == 200, resp
        assert rt.timings["source"] == "parked"
        assert tck.param_digests(tw.engine.params) == boot
        assert _completions(tw.name) == texts
        # A cold wake: the parked copy gone, the weights come from disk.
        status, _ = http_json("POST", tw.name, "/sleep", {"model": "m"})
        assert status == 200
        rt._host_params = None
        status, resp = http_json("POST", tw.name, "/wakeup", {"model": "m"},
                                 timeout=120.0)
        assert status == 200, resp
        assert rt.timings["source"] == "checkpoint"
        assert rt.timings["load_s"] >= 0 and rt.timings["load_bytes"] > 0
        assert tck.param_digests(tw.engine.params) == boot
        assert _completions(tw.name) == texts
    finally:
        tw.stop()
        jw.stop()
        mp.undo()


def test_worker_without_safetensors_random_inits(tmp_path):
    """A directory with a config and no ``*.safetensors``: the config's
    model, random from seed 0 (the JAX ``_load_params`` falls back the
    same way), and the CLI takes ``--model-dir`` with any ``--model``."""
    cfg = ModelConfig.tiny(vocab_size=512)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(tck.hf_config(cfg), f)
    args = torch_worker.parse_args(["--model", "anything", "--model-dir",
                                    str(tmp_path), "--device", "cpu",
                                    "--no-warmup"])
    w = torch_worker.build_worker(args)
    try:
        rt = w.primary_runtime()
        assert rt.timings["source"] == "random"
        assert rt.model_cfg.hidden_size == cfg.hidden_size
        ref = ttf.init_params(dataclasses.replace(rt.model_cfg),
                              torch.Generator().manual_seed(0), "cpu")
        assert tck.param_digests(w.engine.params) == tck.param_digests(ref)
    finally:
        w.stop()


def test_weights_digests_hashed_outside_the_engine_lock(monkeypatch):
    """``GET /admin/weights`` takes only the parameters' reference under
    the engine lock and hashes them outside it, so the streams keep
    stepping while a large model is hashed; ``build_worker`` serves the
    config it is given."""
    args = torch_worker.parse_args(["--model", "tiny", "--device", "cpu",
                                    "--no-warmup"])
    cfg = dataclasses.replace(ModelConfig.tiny(vocab_size=512), num_layers=1)
    w = torch_worker.build_worker(args, model_cfg=cfg)
    held, real = [], tck.param_digests

    def digests(params):
        held.append(w._engine_lock.locked())
        return real(params)
    monkeypatch.setattr(torch_worker.checkpoint, "param_digests", digests)
    try:
        assert w.engine.cfg.num_layers == 1
        body = w.weights_body("")
        assert held == [False]
        assert body["digests"] == real(w.engine.params)
        assert body["source"] == "random"
    finally:
        w.stop()


# ---------------------------------------------------------------------------
# F6: the model catalog
# ---------------------------------------------------------------------------

def test_f6_fork_master_stages_the_jax_catalog():
    """``POST /fork_master`` with every name of the JAX worker's catalog,
    to a port worker and to a JAX worker: the same status and ``created``
    list, and each staged config equal to the JAX preset (the tiny MoE:
    all but ``vocab_size``, which the byte tokenizer needs at 512), each
    accepted by the port (Gemma-3's per-layer rope bases included) and
    left asleep."""
    names = sorted(jax_worker._MODEL_REGISTRY)
    body = {"models": names}
    tw = torch_worker.Worker(
        torch_worker.WorkerOptions(model="tiny", device="cpu"),
        engine_cfg=EngineConfig(**ENGINE)).start()
    jw = jax_worker.Worker(
        jax_worker.WorkerOptions(port=0, model="tiny",
                                 instance_type=JaxInstanceType.DEFAULT),
        JaxInMemoryStore(sweep_interval_s=0.05),
        engine_cfg=JaxEngineConfig(**ENGINE)).start()
    try:
        got = http_json("POST", tw.name, "/fork_master", body)
        want = http_json("POST", jw.name, "/fork_master", body)
        assert got == want
        assert got[0] == 200 and got[1]["created"] == [
            n for n in names if n != "tiny"]
        for n in names:
            mine = dataclasses.asdict(tw.runtimes[n].model_cfg)
            ref = dataclasses.asdict(jw.runtimes[n].model_cfg)
            if n == "tiny-moe":
                assert mine.pop("vocab_size") == 512
                ref.pop("vocab_size")
            elif n == "tiny":
                continue                # the primary: both workers' own
            assert mine == ref, n
            assert tw.runtimes[n].state == "asleep"
        # Gemma-3 is served now. Its wake would build a 12 B-parameter
        # model here: what is checked instead is that the staged config is
        # the JAX catalog's (its per-layer rope bases included) and that
        # the port accepts it.
        g3 = tw.runtimes["gemma3-12b"].model_cfg
        assert dataclasses.asdict(g3) == dataclasses.asdict(
            jax_worker._MODEL_REGISTRY["gemma3-12b"]())
        assert g3.rope_local_base_freq == 10000.0
        ttf.check_supported(g3)
        assert tw.runtimes["gemma3-12b"].state == "asleep"
    finally:
        tw.stop()
        jw.stop()
