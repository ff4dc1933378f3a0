"""Byte-level BPE tokenizer over the reference's vocab.bin
(``tnn_tpu.data.tokenizer``).

The vocab.bin format is ``<u32 count>`` then, per token, ``<u32 len>`` and
its raw bytes. ``encode`` merges byte pairs greedily by lowest token id:
in a vocabulary built in merge order (GPT-2's, and every ``train_bpe``
output) id order is merge rank, so this is true BPE. Ids come out the
same as the JAX package's on the same vocabulary and text.

A loaded vocabulary encodes through the native runtime's BPE
(``native.api.BpeTokenizer``) where the library is built: the same ids
as the Python merge loop, which stays the path without it. The JAX
package's ``from_tiktoken`` (a package and a download) is not ported.
"""
from __future__ import annotations

import re
import struct
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence

# GPT-2's pretokenization pattern; stdlib ``re`` has no \p classes, so
# letters are [^\W\d_] and the punctuation run is "not whitespace, not
# letter, not digit"
_PRETOKEN_RE = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:(?![^\W\d_])[^\s\d])+"
    r"|\s+(?!\S)|\s+")

_END_OF_TEXT = "<|endoftext|>"


class Tokenizer:
    """Byte-level BPE tokenizer over a vocab.bin."""

    def __init__(self):
        self._vocab: List[bytes] = []
        self._encoder: Dict[bytes, int] = {}
        self._special: Dict[str, int] = {}
        self._native = None     # the native encoder of a loaded vocab.bin

    def load(self, vocab_path: str) -> "Tokenizer":
        with open(vocab_path, "rb") as f:
            (count,) = struct.unpack("<I", f.read(4))
            self._vocab = []
            for _ in range(count):
                (n,) = struct.unpack("<I", f.read(4))
                self._vocab.append(f.read(n) if n else b"")
        self._build_encoder()
        from .. import native

        self._native = None
        if native.available():
            try:
                self._native = native.api.BpeTokenizer(vocab_path)
            except (ValueError, OSError):
                self._native = None
        return self

    def save(self, vocab_path: str) -> None:
        with open(vocab_path, "wb") as f:
            f.write(struct.pack("<I", len(self._vocab)))
            for tok in self._vocab:
                f.write(struct.pack("<I", len(tok)))
                f.write(tok)

    def _build_encoder(self) -> None:
        self._encoder = {}
        self._special = {}
        for i, b in enumerate(self._vocab):
            if b not in self._encoder:   # the first id of a byte string wins
                self._encoder[b] = i
        if _END_OF_TEXT.encode() in self._encoder:
            self._special[_END_OF_TEXT] = self._encoder[_END_OF_TEXT.encode()]

    @property
    def vocab_size(self) -> int:
        return len(self._vocab)

    @property
    def eot_token(self) -> Optional[int]:
        return self._special.get(_END_OF_TEXT)

    def decode_token(self, token_id: int) -> bytes:
        if 0 <= token_id < len(self._vocab):
            return self._vocab[token_id]
        return b"<unk>"

    def decode(self, ids: Sequence[int]) -> str:
        return b"".join(self.decode_token(int(i)) for i in ids).decode(
            "utf-8", errors="replace")

    def encode(self, text: str, allowed_special: bool = True) -> List[int]:
        if not self._vocab:
            raise RuntimeError("tokenizer not loaded")
        if self._native is not None and allowed_special:
            return self._native.encode(text).tolist()
        out: List[int] = []
        pieces = [text]
        if allowed_special and _END_OF_TEXT in self._special \
                and _END_OF_TEXT in text:
            pieces = _split_keep(text, _END_OF_TEXT)
        for piece in pieces:
            if piece == _END_OF_TEXT:
                out.append(self._special[_END_OF_TEXT])
                continue
            for word in _PRETOKEN_RE.findall(piece):
                out.extend(self._bpe(word.encode("utf-8")))
        return out

    def _bpe(self, word: bytes) -> List[int]:
        """Merge the adjacent pair with the lowest id until none merges."""
        parts: List[bytes] = [bytes([b]) for b in word]
        while len(parts) > 1:
            best_rank, best_i = None, None
            for i in range(len(parts) - 1):
                rank = self._encoder.get(parts[i] + parts[i + 1])
                if rank is not None and (best_rank is None
                                         or rank < best_rank):
                    best_rank, best_i = rank, i
            if best_i is None:
                break
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out = []
        for p in parts:
            if p in self._encoder:
                out.append(self._encoder[p])
            else:   # an unmergeable raw byte: its byte token
                out.extend(self._encoder[bytes([b])] for b in p)
        return out


def _split_keep(text: str, sep: str) -> List[str]:
    out: List[str] = []
    for i, piece in enumerate(text.split(sep)):
        if i:
            out.append(sep)
        if piece:
            out.append(piece)
    return out


def train_bpe(texts: Iterable[str], vocab_size: int = 1024,
              min_pair_count: int = 2) -> Tokenizer:
    """Learn a byte-level BPE vocabulary from raw text: ids 0-255 are the
    bytes, merged tokens follow in merge order, then <|endoftext|>. Each
    round merges the most frequent adjacent pair (``Counter.most_common``,
    so ties go to the pair counted first, as in the JAX package); it stops
    early when the best pair occurs fewer than ``min_pair_count`` times."""
    word_counts: Counter = Counter()
    for text in texts:
        for w in _PRETOKEN_RE.findall(text):
            word_counts[w.encode("utf-8")] += 1
    words = [[bytes([b]) for b in w] for w in word_counts]
    counts = list(word_counts.values())
    vocab: List[bytes] = [bytes([i]) for i in range(256)]
    n_merges = max(0, int(vocab_size) - 256 - 1)   # keep <|endoftext|>'s id
    for _ in range(n_merges):
        pair_counts: Counter = Counter()
        for parts, c in zip(words, counts):
            for a, b in zip(parts, parts[1:]):
                pair_counts[(a, b)] += c
        if not pair_counts:
            break
        (a, b), cnt = pair_counts.most_common(1)[0]
        if cnt < min_pair_count:
            break
        merged = a + b
        vocab.append(merged)
        for parts in words:
            if len(parts) < 2:
                continue
            out, i = [], 0
            while i < len(parts):
                if i + 1 < len(parts) and parts[i] == a and \
                        parts[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts[:] = out
    vocab.append(_END_OF_TEXT.encode())
    tok = Tokenizer()
    tok._vocab = vocab
    tok._build_encoder()
    return tok
