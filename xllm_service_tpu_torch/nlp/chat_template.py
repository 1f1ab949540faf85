"""Chat templating: jinja templates with tools + multimodal content.

A copy of the JAX package's ``nlp/chat_template.py``: the same behaviour
and names, importing only this package (and no device code).

Rebuild of ``chat_template/jinja_chat_template.{h,cpp}`` (SURVEY.md §2
#15): applies the model's ``chat_template.jinja`` (or the template string
from ``tokenizer_config.json``) to an OpenAI ``messages`` array, with a
``tools`` array and multimodal content-part flattening (image parts become
placeholder tokens for the EPD encode stage, jinja_chat_template.cpp:
26-120). Uses the jinja2 package (the reference vendors minja, a C++
jinja); a ChatML default covers models that ship no template.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_CHATML_TEMPLATE = (
    "{% for message in messages %}"
    "{{ '<|im_start|>' + message['role'] + '\n' + message['content'] "
    "+ '<|im_end|>' + '\n' }}"
    "{% endfor %}"
    "{% if add_generation_prompt %}"
    "{{ '<|im_start|>assistant\n' }}"
    "{% endif %}")

IMAGE_PLACEHOLDER = "<|image_pad|>"
VIDEO_PLACEHOLDER = "<|video_pad|>"


def _flatten_content(content: Any) -> Tuple[str, List[Dict[str, Any]]]:
    """OpenAI content parts → (flat text with placeholders, mm_inputs)."""
    if isinstance(content, str):
        return content, []
    if not isinstance(content, list):
        return str(content), []
    text_parts: List[str] = []
    mm_inputs: List[Dict[str, Any]] = []
    for part in content:
        ptype = part.get("type", "text")
        if ptype == "text":
            text_parts.append(part.get("text", ""))
        elif ptype in ("image_url", "image"):
            url = part.get("image_url", {})
            url = url.get("url", "") if isinstance(url, dict) else str(url)
            mm_inputs.append({"type": "image", "data": url})
            text_parts.append(IMAGE_PLACEHOLDER)
        elif ptype in ("video_url", "video"):
            url = part.get("video_url", {})
            url = url.get("url", "") if isinstance(url, dict) else str(url)
            mm_inputs.append({"type": "video", "data": url})
            text_parts.append(VIDEO_PLACEHOLDER)
    return "".join(text_parts), mm_inputs


class ChatTemplate:
    def __init__(self, template: Optional[str] = None,
                 bos_token: str = "", eos_token: str = "") -> None:
        import jinja2
        self._env = jinja2.Environment(
            loader=jinja2.BaseLoader(),
            undefined=jinja2.ChainableUndefined,
            trim_blocks=True, lstrip_blocks=True)
        self._env.globals["raise_exception"] = _raise_exception
        self._env.filters["tojson"] = lambda v, **kw: json.dumps(v, **kw)
        self._template = self._env.from_string(
            template or DEFAULT_CHATML_TEMPLATE)
        self.bos_token = bos_token
        self.eos_token = eos_token

    @classmethod
    def from_model_dir(cls, model_dir: str) -> "ChatTemplate":
        """Load ``chat_template.jinja`` or the ``chat_template`` field of
        ``tokenizer_config.json`` (reference tokenizer_args.cpp:30-72)."""
        template = None
        bos = eos = ""
        if model_dir:
            jinja_path = os.path.join(model_dir, "chat_template.jinja")
            if os.path.exists(jinja_path):
                with open(jinja_path, "r", encoding="utf-8") as f:
                    template = f.read()
            cfg_path = os.path.join(model_dir, "tokenizer_config.json")
            if os.path.exists(cfg_path):
                with open(cfg_path, "r", encoding="utf-8") as f:
                    cfg = json.load(f)
                template = template or cfg.get("chat_template")
                bos = _token_str(cfg.get("bos_token"))
                eos = _token_str(cfg.get("eos_token"))
        return cls(template, bos, eos)

    def apply(self, messages: List[Dict[str, Any]],
              tools: Optional[List[Dict[str, Any]]] = None,
              add_generation_prompt: bool = True
              ) -> Tuple[str, List[Dict[str, Any]]]:
        """messages (+tools) → (prompt string, multimodal inputs)
        (reference JinjaChatTemplate::apply, jinja_chat_template.h:66-85)."""
        mm_inputs: List[Dict[str, Any]] = []
        flat_messages = []
        for msg in messages:
            text, mm = _flatten_content(msg.get("content", ""))
            mm_inputs.extend(mm)
            out = dict(msg)
            out["content"] = text
            flat_messages.append(out)
        prompt = self._template.render(
            messages=flat_messages,
            tools=tools or None,
            add_generation_prompt=add_generation_prompt,
            bos_token=self.bos_token,
            eos_token=self.eos_token)
        return prompt, mm_inputs


def _token_str(v: Any) -> str:
    if isinstance(v, dict):
        return v.get("content", "")
    return v or ""


def _raise_exception(message: str) -> None:
    raise ValueError(f"chat template error: {message}")
