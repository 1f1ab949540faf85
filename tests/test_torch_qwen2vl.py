"""The port's Qwen2-VL and Qwen2.5-VL vision towers, their host geometry
and the vision reader, against the JAX package on the CPU.

Both checkpoints are written by ``transformers`` itself (random init,
tiny towers of ``tests/test_qwen2vl_vision.py``, saved once a module):
the port's reader must give every leaf bit-equal to the JAX reader's,
and the towers (float32) the JAX towers' embeddings within 1e-5 on the
same patches and grids. ``config.from_hf_config`` must give the JAX
loader's ``ModelConfig`` for both families.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

# transformers imports TensorFlow when it is installed; the towers here
# need only its PyTorch models.
os.environ.setdefault("USE_TF", "0")

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import qwen2vl_vision as jqv
from xllm_service_tpu.runtime.checkpoint import \
    load_qwen2vl_vision as jax_load_vision
from xllm_service_tpu_torch.config import ModelConfig
from xllm_service_tpu_torch.models import qwen2vl_vision as tqv
from xllm_service_tpu_torch.models.transformer import init_params
from xllm_service_tpu_torch.models.weights import vision_params_from_jax
from xllm_service_tpu_torch.runtime import checkpoint

from tests.test_qwen2vl_vision import _VC, _VC25, _make_hf_vlm, \
    _make_hf_vlm25
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

# Float32 towers on the same weights and patches: the einsum and matmul
# orders differ between XLA and PyTorch, nothing else.
TOWER_TOL = 1e-5


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    out = {}
    for name, make in (("qwen2vl", _make_hf_vlm), ("qwen25vl",
                                                    _make_hf_vlm25)):
        d = str(tmp_path_factory.mktemp(name))
        make().save_pretrained(d, safe_serialization=True)
        out[name] = d
    return out


@pytest.fixture(scope="module")
def towers(dirs):
    """(JAX vcfg, JAX params as numpy, port vcfg, port params) per
    family, both read from the same directory at a 32-pixel grid."""
    out = {}
    for name, d in dirs.items():
        jv, jp = jax_load_vision(d, image_size=32)
        tv, tp = checkpoint.load_qwen2vl_vision(d, "cpu", image_size=32)
        out[name] = (jv, jax.tree_util.tree_map(np.asarray, jp), tv, tp)
    return out


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("name", ["qwen2vl", "qwen25vl"])
def test_vision_reader_leaves_bit_equal_to_jax(towers, name):
    jv, jp, tv, tp = towers[name]
    assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
    mine = dict(_leaves(tp))
    ref = dict(_leaves(jp))
    assert sorted(mine) == sorted(ref)
    for k, v in ref.items():
        assert tuple(mine[k].shape) == v.shape, k
        assert mine[k].dtype == torch.float32, k
        np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)


def test_vision_reader_none_without_tower(tmp_path):
    cfg = ModelConfig.tiny(vocab_size=64)
    assert checkpoint.load_qwen2vl_vision(str(tmp_path), "cpu") is None
    checkpoint.save_checkpoint(
        init_params(cfg, torch.Generator().manual_seed(0), "cpu"), cfg,
        str(tmp_path))
    assert checkpoint.load_qwen2vl_vision(str(tmp_path), "cpu") is None
    assert checkpoint.has_text_weights(str(tmp_path))


@pytest.mark.parametrize("name", ["qwen2vl", "qwen25vl"])
def test_vision_writer_round_trips(towers, tmp_path, name):
    """``save_qwen2vl_vision`` writes the ``visual.*`` names the reader
    (and the JAX reader) takes back bit for bit."""
    _, jp, tv, tp = towers[name]
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        vc = dict(_VC) if name == "qwen2vl" else dict(_VC25)
        json.dump({"model_type": "qwen2_vl", "vision_config": vc}, f)
    checkpoint.save_qwen2vl_vision(tp, tv, str(tmp_path / "v.safetensors"))
    jv2, jp2 = jax_load_vision(str(tmp_path), image_size=32)
    assert type(jv2).__name__ == type(tv).__name__
    for k, v in _leaves(jax.tree_util.tree_map(np.asarray, jp2)):
        np.testing.assert_array_equal(dict(_leaves(jp))[k], v, err_msg=k)
    assert not checkpoint.has_text_weights(str(tmp_path))


@pytest.mark.parametrize("grids", [[(1, 4, 4)], [(1, 4, 4), (1, 8, 4)],
                                   [(2, 4, 8)]])
def test_qwen2vl_geometry_matches_jax(towers, grids):
    jv, _, tv, _ = towers["qwen2vl"]
    np.testing.assert_array_equal(tqv.rot_pos_ids(grids, 2),
                                  jqv.rot_pos_ids(grids, 2))
    np.testing.assert_array_equal(tqv.segment_ids(grids),
                                  jqv.segment_ids(grids))
    for a, b in zip(tqv.rotary_cos_sin(tv, grids),
                    jqv.rotary_cos_sin(jv, grids)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("grids", [[(1, 8, 8)], [(1, 6, 4)],
                                   [(1, 8, 8), (1, 4, 4)]])
def test_window_order_matches_jax(towers, grids):
    jv, _, tv, _ = towers["qwen25vl"]
    for a, b in zip(tqv.window_order(tv, grids), jqv.window_order(jv, grids)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("frames", [1, 2, 3])
def test_flatten_image_matches_jax(towers, frames):
    jv, _, tv, _ = towers["qwen2vl"]
    rng = np.random.default_rng(frames)
    px = rng.random((frames, 32, 32, 3), np.float32)
    if frames == 1:
        px = px[0]
    a, ga = tqv.flatten_image(px, tv)
    b, gb = jqv.flatten_image(px, jv)
    assert ga == gb
    np.testing.assert_array_equal(a, b)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("grids", [[(1, 4, 4)], [(1, 4, 4), (1, 8, 4)],
                                   [(2, 4, 8)]])
def test_qwen2vl_tower_matches_jax(towers, grids):
    jv, jp, tv, tp = towers["qwen2vl"]
    S = sum(t * h * w for t, h, w in grids)
    patches = np.random.default_rng(1).standard_normal(
        (S, jv.patch_dim)).astype(np.float32)
    cos, sin = jqv.rotary_cos_sin(jv, grids)
    seg = jqv.segment_ids(grids)
    ref = np.asarray(jqv.encode_patches(_jnp(jp), jv, jnp.asarray(patches),
                                        jnp.asarray(cos), jnp.asarray(sin),
                                        jnp.asarray(seg)))
    got = tqv.encode_patches(tp, tv, torch.from_numpy(patches),
                             torch.from_numpy(cos), torch.from_numpy(sin),
                             torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOWER_TOL, atol=TOWER_TOL)


@pytest.mark.parametrize("grids", [[(1, 8, 8)], [(1, 6, 4)],
                                   [(1, 8, 8), (1, 4, 4)]])
def test_qwen25vl_tower_matches_jax(towers, grids):
    jv, jp, tv, tp = towers["qwen25vl"]
    S = sum(t * h * w for t, h, w in grids)
    patches = np.random.default_rng(2).standard_normal(
        (S, jv.patch_dim)).astype(np.float32)
    m2 = jv.spatial_merge_size ** 2
    cos, sin = jqv.rotary_cos_sin(jv, grids)
    seg_full = jqv.segment_ids(grids)
    widx, seg_win = jqv.window_order(jv, grids)
    perm = (widx[:, None] * m2 + np.arange(m2)[None, :]).reshape(-1)
    rev = np.argsort(widx)
    args = (patches[perm], cos[perm], sin[perm], seg_full[perm], seg_win)
    ref = np.asarray(jqv.encode_patches_v25(
        _jnp(jp), jv, *[jnp.asarray(a) for a in args], jnp.asarray(rev)))
    got = tqv.encode_patches_v25(
        tp, tv, *[torch.from_numpy(np.ascontiguousarray(a)) for a in args],
        torch.from_numpy(rev)).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOWER_TOL, atol=TOWER_TOL)


@pytest.mark.parametrize("name", ["qwen2vl", "qwen25vl"])
def test_fixed_grid_entries_match_jax(towers, name):
    """The serving entries on two 32 x 32 images, and the JAX tree
    carried across by ``vision_params_from_jax``."""
    jv, jp, tv, _ = towers[name]
    pixels = np.random.default_rng(3).random((2, 32, 32, 3), np.float32)
    tp = vision_params_from_jax(jp, "cpu")
    if name == "qwen2vl":
        ref = jqv.encode_images_fixed_grid(_jnp(jp), jv, pixels)
        got = tqv.encode_images_fixed_grid(tp, tv, pixels)
    else:
        ref = jqv.encode_images_fixed_grid_v25(_jnp(jp), jv, pixels)
        got = tqv.encode_images_fixed_grid_v25(tp, tv, pixels)
    assert got.shape == (2, tv.tokens_per_image, tv.hidden_size)
    np.testing.assert_allclose(got, ref, rtol=TOWER_TOL, atol=TOWER_TOL)


def test_random_init_tree_matches_jax_shapes():
    """``init_vision_params`` gives the JAX tree's leaves and shapes
    (Qwen2-VL), norms ones and biases zeros."""
    cfg = tqv.Qwen2VLVisionConfig.tiny()
    mine = dict(_leaves(tqv.init_vision_params(
        cfg, torch.Generator().manual_seed(0), "cpu")))
    ref = dict(_leaves(jqv.init_vision_params(
        jqv.Qwen2VLVisionConfig.tiny(), jax.random.PRNGKey(0))))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert bool((mine["blocks.norm1_w"] == 1).all())
    assert bool((mine["merger.mlp2_b"] == 0).all())


@pytest.mark.parametrize("name", ["qwen2vl", "qwen25vl"])
def test_hf_config_matches_jax_loader(dirs, name):
    with open(os.path.join(dirs[name], "config.json")) as f:
        d = json.load(f)
    mine = ModelConfig.from_hf_config(d, name="m")
    ref = JaxModelConfig.from_hf_config(d, name="m")
    assert mine.is_mrope == ref.is_mrope
    for field in dataclasses.fields(mine):
        if hasattr(ref, field.name):
            assert getattr(mine, field.name) == getattr(ref, field.name), \
                field.name


def test_bad_image_size_refused():
    with pytest.raises(ValueError):
        tqv.Qwen2VLVisionConfig.from_hf_config(dict(_VC), image_size=30)
    with pytest.raises(ValueError):
        tqv.Qwen25VLVisionConfig.from_hf_config(dict(_VC25), image_size=0)
