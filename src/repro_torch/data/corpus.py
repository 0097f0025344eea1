"""Offline text corpus + byte-level tokenizer: the port's copy of the
reference's ``data/corpus.py``.

The training corpus is built from text that is always present offline: the
CPython standard library sources found on ``sys.path`` and then this repo's
own sources, in the reference's order (this file sits at the same depth of
the repo as the reference's, so ``parents[3]`` is the same root). The token
stream is byte for byte the reference's.
"""
from __future__ import annotations

import pathlib
import sys
from typing import List

import numpy as np

__all__ = ["ByteTokenizer", "build_corpus", "corpus_tokens"]


class ByteTokenizer:
    """UTF-8 byte tokenizer with BOS/EOS; vocab 256 + 2 specials."""

    vocab_size = 258
    bos = 256
    eos = 257

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8", errors="ignore"), np.uint8).astype(np.int32)

    def decode(self, ids) -> str:
        ids = np.asarray(ids)
        ids = ids[(ids >= 0) & (ids < 256)]
        return bytes(ids.astype(np.uint8)).decode("utf-8", errors="ignore")


def _source_files(max_files: int) -> List[pathlib.Path]:
    roots = [pathlib.Path(p) for p in sys.path
             if pathlib.Path(p).is_dir() and (pathlib.Path(p) / "encodings").exists()]
    roots.append(pathlib.Path(__file__).resolve().parents[3])  # this repo
    files: List[pathlib.Path] = []
    for root in roots:
        for f in sorted(root.rglob("*.py")):
            if "test" in f.name or "__pycache__" in str(f):
                continue
            files.append(f)
            if len(files) >= max_files:
                return files
    return files


def build_corpus(max_bytes: int = 8_000_000, max_files: int = 2000) -> str:
    chunks, total = [], 0
    for f in _source_files(max_files):
        try:
            text = f.read_text(errors="ignore")
        except OSError:
            continue
        chunks.append(text)
        total += len(text)
        if total >= max_bytes:
            break
    return "\n".join(chunks)[:max_bytes]


def corpus_tokens(max_bytes: int = 8_000_000, *, seed: int = 0) -> np.ndarray:
    """Tokenized corpus as one long int32 stream (deterministic; ``seed`` is
    kept for the reference's signature and draws nothing)."""
    del seed
    return ByteTokenizer().encode(build_corpus(max_bytes))
