"""Multimodal plumbing for the EPD (encode, prefill, decode) path: image
loading, placeholder expansion, the Qwen2-VL 3-D rope positions, image
digests and the embeddings' wire codecs. The JAX package's
``runtime/multimodal.py``, copied (numpy only).

The master's chat template turns OpenAI image content parts into one
``<|image_pad|>`` placeholder per image plus ``mm_inputs`` descriptors.
On the worker each placeholder span becomes ``tokens_per_image`` copies
of the model's image token id, and the vision encoder's embeddings are
spliced over the token embeddings at those positions
(``models/transformer.forward_prefill``'s ``mm_embeds``).
"""

from __future__ import annotations

import base64
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from xllm_service_tpu_torch.utils.hashing import image_digest  # noqa: F401 — the master derives it too

# The chat template's image placeholder (the JAX package's
# ``nlp/chat_template.IMAGE_PLACEHOLDER``).
IMAGE_PLACEHOLDER = "<|image_pad|>"


def image_token_id(vocab_size: int) -> int:
    """The splice marker: the last vocabulary id (tokenizers stop well
    short of padded vocabulary sizes)."""
    return vocab_size - 1


def load_image(spec: Any, image_size: int) -> np.ndarray:
    """One ``mm_inputs`` descriptor as pixels [H, W, 3] float32 in [0, 1],
    resized (nearest) to the encoder's fixed grid: ``"random:<seed>"``
    (deterministic synthetic pixels), a dict with ``pixels_b64`` and
    ``shape`` (raw float32), or a ``data:`` URI decoded with PIL where it
    is installed."""
    if isinstance(spec, dict) and spec.get("type") in ("image", "video"):
        spec = spec.get("data")
    if isinstance(spec, str) and spec.startswith("random:"):
        seed = int(spec.split(":", 1)[1] or 0)
        rng = np.random.default_rng(seed)
        return rng.random((image_size, image_size, 3), np.float32)
    if isinstance(spec, dict) and "pixels_b64" in spec:
        arr = np.frombuffer(base64.b64decode(spec["pixels_b64"]),
                            np.float32).reshape(spec["shape"])
        return _resize_nearest(arr, image_size)
    if isinstance(spec, str) and spec.startswith("data:"):
        try:
            from io import BytesIO

            from PIL import Image
        except ImportError as e:
            raise ValueError("data: URI images need PIL") from e
        payload = spec.split(",", 1)[1]
        img = Image.open(BytesIO(base64.b64decode(payload))).convert("RGB")
        img = img.resize((image_size, image_size))
        return np.asarray(img, np.float32) / 255.0
    raise ValueError(f"unsupported image spec: {type(spec)} "
                     f"{str(spec)[:60]!r}")


def _resize_nearest(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    yi = (np.arange(size) * h // size).clip(0, h - 1)
    xi = (np.arange(size) * w // size).clip(0, w - 1)
    return arr[yi][:, xi]


def expand_image_placeholders(token_ids: Sequence[int],
                              placeholder_ids: Sequence[int],
                              num_images: int, tokens_per_image: int,
                              img_tok: int) -> Tuple[List[int], List[int]]:
    """Replace each placeholder-id span with ``tokens_per_image`` image
    tokens. Returns (the new token ids, the splice positions: one per
    image token, in image order, aligned with the flattened embedding
    rows)."""
    if not placeholder_ids:
        raise ValueError("tokenizer produced empty placeholder encoding")
    out: List[int] = []
    positions: List[int] = []
    i = found = 0
    pl = list(placeholder_ids)
    n = len(token_ids)
    while i < n:
        if found < num_images and list(token_ids[i:i + len(pl)]) == pl:
            start = len(out)
            out.extend([img_tok] * tokens_per_image)
            positions.extend(range(start, start + tokens_per_image))
            i += len(pl)
            found += 1
        else:
            out.append(token_ids[i])
            i += 1
    if found != num_images:
        raise ValueError(
            f"found {found} image placeholders for {num_images} images")
    return out, positions


def mrope_positions(token_ids: Sequence[int], image_token: int,
                    grids: Sequence[Tuple[int, int, int]], merge: int
                    ) -> Tuple[np.ndarray, int]:
    """Qwen2-VL 3-D rope positions of one prompt (HF ``get_rope_index``):
    text tokens advance all three streams together; each run of
    ``image_token`` takes the next grid (t, h, w) and its positions are
    the merged grid's ids offset by the current base, which then
    advances by max(t, h/merge, w/merge). Returns ([3, T] int32, delta),
    ``delta`` the constant rope-minus-storage offset of every later
    (generated) token."""
    T = len(token_ids)
    out = np.zeros((3, T), np.int32)
    pos = gi = base = 0
    ids = list(token_ids)
    while pos < T:
        if ids[pos] == image_token:
            if gi >= len(grids):
                raise ValueError("more image-token runs than grids")
            t, h, w = grids[gi]
            gi += 1
            lh, lw = h // merge, w // merge
            n = t * lh * lw
            if pos + n > T or any(tok != image_token
                                  for tok in ids[pos:pos + n]):
                raise ValueError("image-token run shorter than its grid")
            out[0, pos:pos + n] = base + np.repeat(
                np.arange(t, dtype=np.int32), lh * lw)
            out[1, pos:pos + n] = base + np.tile(np.repeat(
                np.arange(lh, dtype=np.int32), lw), t)
            out[2, pos:pos + n] = base + np.tile(
                np.arange(lw, dtype=np.int32), t * lh)
            base += max(t, lh, lw)
            pos += n
        else:
            out[:, pos] = base
            base += 1
            pos += 1
    return out, base - T


def embeds_raw_meta(embeds: np.ndarray) -> Dict[str, Any]:
    """The meta line of the raw embedding wire (one JSON line, then the
    float32 payload, as ``/kv/blocks`` answers)."""
    arr = np.ascontiguousarray(embeds, dtype=np.float32)
    return {"shape": list(arr.shape), "dtype": "float32"}


def embeds_from_raw(meta: Dict[str, Any], payload: bytes) -> np.ndarray:
    return np.frombuffer(payload, np.float32).reshape(meta["shape"]).copy()


def embeds_to_wire(embeds: np.ndarray) -> Dict[str, Any]:
    arr = np.ascontiguousarray(embeds, dtype=np.float32)
    return {"embeds_b64": base64.b64encode(arr.tobytes()).decode("ascii"),
            "shape": list(arr.shape)}


def embeds_from_wire(d: Dict[str, Any]) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["embeds_b64"]),
                         np.float32).reshape(d["shape"]).copy()
