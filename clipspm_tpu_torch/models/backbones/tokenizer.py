"""Byte-level BPE tokenizer compatible with OpenAI CLIP.

A copy of ``clipspm_tpu/models/backbones/tokenizer.py`` (the port imports
nothing of the JAX package). The merges table is data: it is read in place
from ``$CLIP_BPE_PATH`` or ``clipspm_tpu/assets/bpe_simple_vocab_16e6.txt.gz``
and never written; without it a deterministic synthetic vocabulary keeps the
pipeline running (text features then differ from OpenAI CLIP's).

``ftfy`` is optional: without it, text cleanup is ``html.unescape`` + strip,
which is the same for ASCII class names.
"""

from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import regex as re

try:
    import ftfy  # type: ignore

    def _fix_text(text: str) -> str:
        return ftfy.fix_text(text)
except ImportError:  # pragma: no cover
    def _fix_text(text: str) -> str:
        return text

_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+"""
    r"""|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE)

CONTEXT_LENGTH = 77

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
# the shared asset, read in place from the JAX package's assets directory
BPE_ASSET = os.path.join(_REPO, "clipspm_tpu", "assets",
                         "bpe_simple_vocab_16e6.txt.gz")


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (the GPT-2/CLIP table)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _word_pairs(word: Tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def default_bpe_path() -> Optional[str]:
    for c in (os.environ.get("CLIP_BPE_PATH"), BPE_ASSET):
        if c and os.path.isfile(c):
            return c
    return None


def _load_merges(bpe_path: str, limit: int) -> List[Tuple[str, str]]:
    opener = gzip.open if bpe_path.endswith(".gz") else open
    with opener(bpe_path, "rb") as f:
        lines = f.read().decode("utf-8").split("\n")
    # line 0 is a version header; merges follow
    lines = lines[1: limit + 1]
    return [tuple(line.split()) for line in lines if line.strip()]


def _synthetic_merges(limit: int) -> List[Tuple[str, str]]:
    """Deterministic fallback vocabulary: frequent English bigram merges."""
    base = list(bytes_to_unicode().values())
    merges: List[Tuple[str, str]] = []
    common = ["th", "he", "in", "er", "an", "re", "on", "at", "en", "nd",
              "ti", "es", "or", "te", "of", "ed", "is", "it", "al", "ar",
              "st", "to", "nt", "ng", "se", "ha", "as", "ou", "io", "le"]
    for pair in common:
        merges.append((pair[0], pair[1]))
        merges.append((pair[0], pair[1] + "</w>"))
    for ch in base[:min(len(base), max(0, limit - len(merges)))]:
        if len(merges) >= limit:
            break
        merges.append((ch, "</w>"))
    return merges[:limit]


class SimpleTokenizer:
    """CLIP byte-level BPE."""

    def __init__(self, bpe_path: Optional[str] = None,
                 vocab_size: int = 49408):
        if bpe_path is None:
            bpe_path = default_bpe_path()
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        n_merges = vocab_size - 2 * len(self.byte_encoder) - 2
        if bpe_path is not None:
            merges = _load_merges(bpe_path, n_merges)
            self.using_openai_vocab = True
        else:
            merges = _synthetic_merges(n_merges)
            self.using_openai_vocab = False

        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _word_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _word_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    @staticmethod
    def _clean(text: str) -> str:
        text = _fix_text(text)
        text = html.unescape(html.unescape(text))
        text = re.sub(r"\s+", " ", text)
        return text.strip().lower()

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        for tok in re.findall(_PAT, self._clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return tokens

    def decode(self, tokens: List[int]) -> str:
        text = "".join(self.decoder[t] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@lru_cache(maxsize=None)
def get_tokenizer() -> SimpleTokenizer:
    """The process-wide default tokenizer (built once)."""
    return SimpleTokenizer()


def tokenize(texts: Union[str, List[str]],
             context_length: int = CONTEXT_LENGTH,
             truncate: bool = False,
             tokenizer: Optional[SimpleTokenizer] = None) -> np.ndarray:
    """Tokenize to a fixed ``[B, context_length]`` int32 array."""
    if isinstance(texts, str):
        texts = [texts]
    tk = tokenizer or get_tokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        toks = [tk.sot_token] + tk.encode(text) + [tk.eot_token]
        if len(toks) > context_length:
            if not truncate:
                raise RuntimeError(f"Input {text!r} is too long for context "
                                   f"length {context_length}")
            toks = toks[:context_length]
            toks[-1] = tk.eot_token
        result[i, : len(toks)] = toks
    return result
