"""Tokenizer subsystem: one interface, four backends.

A copy of the JAX package's ``nlp/tokenizer.py``: the worker of this
package keeps its own so that it imports nothing of the JAX package.

Rebuild of the reference's ``tokenizer/`` (SURVEY.md §2 #13). The reference
factory picks between an HF-tokenizers Rust FFI, a re2-based tiktoken BPE,
and vendored sentencepiece (tokenizer_factory.cpp:9-33); here:

- ``HFTokenizer`` — ``tokenizer.json`` via the ``tokenizers`` package (the
  same Rust core the reference binds through its own FFI shim).
- ``TiktokenTokenizer`` — tiktoken-format rank files, re-implemented: ranks
  loaded from base64 lines, greedy BPE merge by rank, ``regex``-based
  pretokenization (the reference's re2 pattern, tiktoken_tokenizer.cpp).
- ``SentencePieceTokenizer`` — via the ``sentencepiece`` package when
  installed (gated import; absent in this image).
- ``ByteTokenizer`` — UTF-8 byte-level fallback with reserved specials; no
  model assets required (tests, demos, loadgen).

All are stateless after construction → trivially shareable across threads
(the reference clones per-thread instead, scheduler.cpp:192-195; these
backends are immutable so sharing is safe without clones).

Incremental streaming detokenization (``IncrementalDecoder``) handles the
multi-byte/UTF-8 boundary problem: bytes of a partially decoded character
are withheld until complete.
"""

from __future__ import annotations

import abc
import base64
import functools
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple


class Tokenizer(abc.ABC):
    """Reference ``tokenizer/tokenizer.h:28-47``."""

    @abc.abstractmethod
    def encode(self, text: str) -> List[int]: ...

    @abc.abstractmethod
    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str: ...

    @property
    @abc.abstractmethod
    def vocab_size(self) -> int: ...

    @property
    def eos_token_ids(self) -> Tuple[int, ...]:
        return ()

    @property
    def bos_token_id(self) -> Optional[int]:
        return None


class ByteTokenizer(Tokenizer):
    """UTF-8 bytes + reserved special ids. id = byte + 3;
    0=pad, 1=bos, 2=eos."""

    PAD, BOS, EOS = 0, 1, 2
    _OFFSET = 3

    def __init__(self, add_bos: bool = False) -> None:
        self.add_bos = add_bos

    def encode(self, text: str) -> List[int]:
        ids = [b + self._OFFSET for b in text.encode("utf-8")]
        return [self.BOS] + ids if self.add_bos else ids

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        # Ids outside [OFFSET, OFFSET+256) — specials or out-of-range
        # samples from a larger model vocab — are dropped.
        data = bytes(i - self._OFFSET for i in ids
                     if self._OFFSET <= i < self._OFFSET + 256)
        return data.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return 256 + self._OFFSET

    @property
    def eos_token_ids(self) -> Tuple[int, ...]:
        return (self.EOS,)

    @property
    def bos_token_id(self) -> Optional[int]:
        return self.BOS


class HFTokenizer(Tokenizer):
    """``tokenizer.json`` via the HF ``tokenizers`` Rust core."""

    def __init__(self, path: str,
                 eos_ids: Tuple[int, ...] = ()) -> None:
        from tokenizers import Tokenizer as _T
        self._tok = _T.from_file(path)
        self._eos = eos_ids

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text).ids

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids),
                                skip_special_tokens=skip_special_tokens)

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    @property
    def eos_token_ids(self) -> Tuple[int, ...]:
        return self._eos


# cl100k-style pretokenization pattern (tiktoken's public pattern; the
# reference compiles the same class of pattern into re2,
# tiktoken_tokenizer.cpp).
_TIKTOKEN_PAT = (
    r"""'(?i:[sdmt]|ll|ve|re)|[^\r\n\p{L}\p{N}]?+\p{L}+|\p{N}{1,3}|"""
    r""" ?[^\s\p{L}\p{N}]++[\r\n]*|\s*[\r\n]|\s+(?!\S)|\s+""")


class TiktokenTokenizer(Tokenizer):
    """tiktoken-format BPE: file of ``<base64 token> <rank>`` lines."""

    def __init__(self, path: str, pattern: str = _TIKTOKEN_PAT,
                 special_tokens: Optional[Dict[str, int]] = None) -> None:
        import regex
        self._pat = regex.compile(pattern)
        self._ranks: Dict[bytes, int] = {}
        with open(path, "rb") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                tok_b64, rank = line.split()
                self._ranks[base64.b64decode(tok_b64)] = int(rank)
        self._id_to_bytes = {v: k for k, v in self._ranks.items()}
        self._special = dict(special_tokens or {})
        for name, sid in self._special.items():
            self._id_to_bytes[sid] = name.encode("utf-8")
        self._max_id = max(self._id_to_bytes) + 1

    def _bpe(self, piece: bytes) -> List[int]:
        if piece in self._ranks:
            return [self._ranks[piece]]
        parts: List[bytes] = [bytes([b]) for b in piece]
        while len(parts) > 1:
            best_rank, best_i = None, -1
            for i in range(len(parts) - 1):
                r = self._ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out = []
        for p in parts:
            r = self._ranks.get(p)
            if r is None:
                # Unknown byte sequence: fall back to per-byte ranks where
                # they exist; skip otherwise.
                out.extend(self._ranks[bytes([b])] for b in p
                           if bytes([b]) in self._ranks)
            else:
                out.append(r)
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for m in self._pat.finditer(text):
            ids.extend(self._bpe(m.group().encode("utf-8")))
        return ids

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        special_ids = set(self._special.values())
        buf = b""
        for i in ids:
            if skip_special_tokens and i in special_ids:
                continue
            buf += self._id_to_bytes.get(i, b"")
        return buf.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return self._max_id

    @property
    def eos_token_ids(self) -> Tuple[int, ...]:
        return tuple(sid for name, sid in self._special.items()
                     if "end" in name.lower() or "eot" in name.lower())


class SentencePieceTokenizer(Tokenizer):
    """``tokenizer.model`` via the sentencepiece package (optional)."""

    def __init__(self, path: str) -> None:
        try:
            import sentencepiece as spm
        except ImportError as e:  # pragma: no cover - absent in this image
            raise RuntimeError(
                "sentencepiece is not installed; convert the model to "
                "tokenizer.json or install sentencepiece") from e
        self._sp = spm.SentencePieceProcessor(model_file=path)

    def encode(self, text: str) -> List[int]:
        return list(self._sp.encode(text))

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        return self._sp.decode(list(ids))

    @property
    def vocab_size(self) -> int:
        return self._sp.vocab_size()

    @property
    def eos_token_ids(self) -> Tuple[int, ...]:
        return (self._sp.eos_id(),) if self._sp.eos_id() >= 0 else ()


class TokenizerFactory:
    """File-sniffing factory (reference tokenizer_factory.cpp:9-33):
    ``tokenizer.json`` → HF; ``*.tiktoken`` → tiktoken;
    ``tokenizer.model`` → sentencepiece; nothing → byte-level."""

    @staticmethod
    @functools.lru_cache(maxsize=8)
    def create_tokenizer(model_dir: str = "") -> Tokenizer:
        if not model_dir:
            return ByteTokenizer()
        hf = os.path.join(model_dir, "tokenizer.json")
        if os.path.exists(hf):
            eos = _eos_from_config(model_dir)
            return HFTokenizer(hf, eos)
        for fname in sorted(os.listdir(model_dir)):
            if fname.endswith(".tiktoken"):
                return TiktokenTokenizer(os.path.join(model_dir, fname))
        sp = os.path.join(model_dir, "tokenizer.model")
        if os.path.exists(sp):
            return SentencePieceTokenizer(sp)
        return ByteTokenizer()


def _eos_from_config(model_dir: str) -> Tuple[int, ...]:
    """eos ids from config.json / generation_config.json
    (reference tokenizer_args.cpp:30-72 reads tokenizer_config.json)."""
    for fname in ("generation_config.json", "config.json"):
        path = os.path.join(model_dir, fname)
        if not os.path.exists(path):
            continue
        try:
            with open(path, "r", encoding="utf-8") as f:
                cfg = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        eos = cfg.get("eos_token_id")
        if eos is None:
            continue
        return tuple(eos) if isinstance(eos, list) else (int(eos),)
    return ()


class IncrementalDecoder:
    """Streaming detokenizer for one sequence: feeds token ids, emits only
    complete UTF-8 text (held-back bytes flushed once the char completes).

    Decodes a bounded trailing window, not the whole accumulated id list:
    ``_prefix`` marks the window start and advances on every successful
    emit, so per-token cost stays O(window) instead of O(generated) — the
    per-token host hot path must not be quadratic in generation length."""

    _CONTEXT_TOKENS = 4

    def __init__(self, tokenizer: Tokenizer) -> None:
        self._tok = tokenizer
        self._ids: List[int] = []
        self._prefix = 0             # window start (context for BPE joins)
        self._win_emitted = 0        # chars of decode(window) already out

    def feed(self, new_ids: Sequence[int]) -> str:
        self._ids.extend(new_ids)
        full = self._tok.decode(self._ids[self._prefix:])
        # A trailing replacement char usually means a split multi-byte
        # sequence: hold it back until the char completes; anything before
        # it is final and emitted now.
        safe = len(full)
        while safe > 0 and full[safe - 1] == "�":
            safe -= 1
        delta = full[self._win_emitted:safe] \
            if safe > self._win_emitted else ""
        self._win_emitted = max(self._win_emitted, safe)
        if safe == len(full):
            # Window fully emitted: slide it forward, keeping a few tokens
            # of context (boundary-marker tokenizers like SentencePiece
            # mis-decode a word-start token with no left context).
            new_prefix = max(len(self._ids) - self._CONTEXT_TOKENS, 0)
            if new_prefix > self._prefix:
                self._prefix = new_prefix
                self._win_emitted = len(
                    self._tok.decode(self._ids[self._prefix:]))
        return delta

    def flush(self) -> str:
        full = self._tok.decode(self._ids[self._prefix:])
        delta = full[self._win_emitted:]
        self._prefix = len(self._ids)
        self._win_emitted = 0
        return delta
