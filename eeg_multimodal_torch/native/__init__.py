"""The C++ WordPiece engine, built with g++ at first use and bound with ctypes.

The port's copy of the JAX package's ``native/``: the same C++ source
(``wordpiece.cpp``, tokenization of serialized sensor rows on the host, the
reference's per-row Python of get_embedding.py:113-116) and the same
``NativeWordPiece`` contract as ``data.tokenizer.WordPiece``. The library is
built with ``g++ -O3 -shared -fPIC -std=c++17`` into
``.cache/native/<hash of the source and flags>/`` at the checkout's root
(git-ignored), never next to the sources, and loaded from there by later
calls. Where no ``g++`` exists (or the build fails) ``available()`` is False
and ``GetEmbedding`` tokenizes with the Python engine, which gives the same
ids: this is host tokenization, not the device path.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "wordpiece.cpp")
CACHE = os.path.join(os.path.dirname(os.path.dirname(_DIR)), ".cache", "native")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIB_NAME = "libwordpiece.so"


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def _build():
    """``(library, None)`` once built and loaded, or ``(None, reason)``."""
    out_dir = os.path.join(CACHE, _digest())
    lib_path = os.path.join(out_dir, LIB_NAME)
    try:
        if not os.path.exists(lib_path):
            cxx = shutil.which("g++")
            if cxx is None:
                return None, "g++ not found"
            os.makedirs(out_dir, exist_ok=True)
            work = tempfile.mkdtemp(dir=out_dir)
            try:
                tmp = os.path.join(work, LIB_NAME)
                res = subprocess.run([cxx, *FLAGS, SRC, "-o", tmp], capture_output=True,
                                     text=True)
                if res.returncode != 0:
                    return None, f"g++ failed with code {res.returncode}: {res.stderr}"
                os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
            finally:
                shutil.rmtree(work, ignore_errors=True)
        lib = ctypes.CDLL(lib_path)
    except OSError as e:  # an unwritable cache or an unloadable library
        return None, str(e)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 4
    lib.wp_destroy.restype = None
    lib.wp_destroy.argtypes = [ctypes.c_void_p]
    lib.wp_encode_batch.restype = ctypes.c_int
    lib.wp_encode_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, i32p, i32p]
    return lib, None


def available() -> bool:
    """Whether the C++ engine built and loaded here."""
    return _build()[0] is not None


def build_error() -> Optional[str]:
    """Why the engine is not available, or None."""
    return _build()[1]


class NativeWordPiece:
    """ctypes wrapper over the C++ WordPiece with the encode contract of
    ``data.tokenizer.WordPiece`` (int32 ids and attention mask, [CLS] /
    [SEP] / padding to ``max_length``)."""

    def __init__(self, vocab: dict, cls_id: int, sep_id: int, pad_id: int,
                 unk_id: int, word_memo: Optional[dict] = None):
        lib, err = _build()
        if lib is None:
            raise RuntimeError(f"the native WordPiece is unavailable: {err}")
        self._lib = lib
        lines = [f"{k}\t{v}" for k, v in vocab.items()]
        # memo entries are comma-terminated id lists (see wp_create): the
        # exact word -> ids table RecoveredWordPiece carries
        for w, run in (word_memo or {}).items():
            if run:
                lines.append(f"{w}\t{','.join(str(i) for i in run)},")
        self._h = lib.wp_create("\n".join(lines).encode(), cls_id, sep_id, pad_id, unk_id)
        self.pad_id = pad_id

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.wp_destroy(self._h)
            self._h = None

    def encode_batch(self, texts, max_length: int = 512):
        """(len(texts), max_length) int32 ids and mask."""
        n = len(texts)
        ids = np.empty((n, max_length), np.int32)
        mask = np.empty((n, max_length), np.int32)
        # the C side splits the joined texts at newlines and writes a row for
        # each part: n rows exactly, or it would write past the buffers
        if n == 0:
            return ids, mask
        if any("\n" in t for t in texts):
            raise ValueError("a text holds a newline")
        i32p = ctypes.POINTER(ctypes.c_int32)
        got = self._lib.wp_encode_batch(self._h, "\n".join(texts).encode(), max_length,
                                        ids.ctypes.data_as(i32p), mask.ctypes.data_as(i32p))
        if got != n:
            raise RuntimeError(f"the native WordPiece encoded {got} of {n} texts")
        return ids, mask

    def encode(self, text: str, max_length: int = 512):
        ids, mask = self.encode_batch([text], max_length)
        return ids[0], mask[0]

    @staticmethod
    def from_wordpiece(tok) -> "NativeWordPiece":
        """From a ``data.tokenizer.WordPiece``. A ``RecoveredWordPiece``'s word
        memo goes across whole (exact id runs for observed words, as the
        Python engine has them); unseen words take greedy longest-match over
        the piece vocab, as in Python."""
        return NativeWordPiece(dict(tok.vocab), tok.cls_id, tok.sep_id, tok.pad_id, tok.unk_id,
                               word_memo=getattr(tok, "word_memo", None))
