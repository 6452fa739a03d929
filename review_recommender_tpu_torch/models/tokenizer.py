"""Model tokenizers and sequence packing (host side).

A jax-free copy of `basic_tokenize`, `wordpiece`, `WordPieceTokenizer`,
`HashTokenizer`, `encode_seqs`, `pack_seqs`, `encode_batch` and `pad_bucket` from
`review_recommender_tpu/models/tokenizer.py` (the JAX package's
`models/__init__.py` loads its flax BERT). WordPieceTokenizer reads a
checkpoint's vocab.txt (id = line number) and splits each basic token
greedily, longest match first, with '##' continuations (BERT uncased).
"""
from __future__ import annotations

import re
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CLS, SEP, PAD, UNK, MASK = "[CLS]", "[SEP]", "[PAD]", "[UNK]", "[MASK]"


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


# Words of ASCII characters in one regex pass: the control characters
# basic_tokenize_chars drops (category Cc but tab, newline and carriage
# return), then each punctuation character alone and each run of other
# non-blank characters. A word that holds any other character (split off at
# ASCII blanks, which the character rules split at too) takes those rules.
_ASCII_CONTROL = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f\x7f]")
_ASCII_TOKEN = re.compile(r"[!-/:-@\[-`{-~]|[^ \t\n\r!-/:-@\[-`{-~]+")
_NON_ASCII_WORD = re.compile(r"(?<![^ \t\n\r])([^ \t\n\r]*[^\x00-\x7f][^ \t\n\r]*)")


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """BERT BasicTokenizer: clean, CJK-isolate, lowercase+strip accents,
    split on punctuation and whitespace. The character rules act on each
    blank-separated word alone, so each run of ASCII-only words takes one
    regex pass (ASCII has no CJK, accents or other whitespace) and each word
    with a non-ASCII character goes through basic_tokenize_chars: the same
    tokens."""
    tokens: List[str] = []
    # (an ASCII text holds no such word: the split would return it whole)
    parts = [text] if text.isascii() else _NON_ASCII_WORD.split(text)
    for i, part in enumerate(parts):
        if i % 2:
            tokens += basic_tokenize_chars(part, lowercase)
        elif part:
            part = _ASCII_CONTROL.sub("", part)
            tokens += _ASCII_TOKEN.findall(part.lower() if lowercase else part)
    return tokens


def basic_tokenize_chars(text: str, lowercase: bool = True) -> List[str]:
    """basic_tokenize character by character, for any text."""
    out_chars: List[str] = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            out_chars.extend((" ", ch, " "))
        elif _is_whitespace(ch):
            out_chars.append(" ")
        else:
            out_chars.append(ch)
    tokens: List[str] = []
    for tok in "".join(out_chars).split():
        if lowercase:
            tok = tok.lower()
            tok = "".join(
                c for c in unicodedata.normalize("NFD", tok)
                if unicodedata.category(c) != "Mn"
            )
        cur: List[str] = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


def wordpiece(token: str, vocab: Dict[str, int], max_chars: int = 100) -> List[str]:
    """Greedy longest-match-first WordPiece split of one basic token; [UNK]
    for a token over max_chars or one with a piece the vocab lacks."""
    if len(token) > max_chars:
        return [UNK]
    pieces: List[str] = []
    start = 0
    while start < len(token):
        end = len(token)
        piece = None
        while start < end:
            sub = token[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                piece = sub
                break
            end -= 1
        if piece is None:
            return [UNK]
        pieces.append(piece)
        start = end
    return pieces


class WordPieceTokenizer:
    """Vocab-file-backed BERT-uncased tokenizer. mask_id falls back to
    [UNK] for a vocab without [MASK]."""

    def __init__(self, vocab: Dict[str, int], lowercase: bool = True):
        self.vocab = vocab
        self.lowercase = lowercase
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.mask_id = vocab.get(MASK, self.unk_id)

    @classmethod
    def from_vocab_file(cls, path, lowercase: bool = True) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(Path(path), encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, lowercase)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in basic_tokenize(text, self.lowercase):
            out.extend(wordpiece(tok, self.vocab))
        return out

    def token_ids(self, text: str) -> List[int]:
        return [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]


_ID_CACHE_MAX = 1 << 20  # tokens whose hash id a HashTokenizer keeps


class HashTokenizer:
    """Vocab-free tokenizer: basic tokenization + FNV-1a hash ids.

    Ids 0..4 are PAD/UNK/CLS/SEP/MASK; other tokens hash into
    [5, vocab_size). Deterministic across processes."""

    def __init__(self, vocab_size: int = 30522, lowercase: bool = True):
        if vocab_size <= 8:
            raise ValueError(f"vocab_size must be > 8, got {vocab_size}")
        self.vocab_size = vocab_size
        self.lowercase = lowercase
        self.pad_id, self.unk_id, self.cls_id, self.sep_id, self.mask_id = range(5)
        self._ids: Dict[str, int] = {}  # token -> id, emptied at _ID_CACHE_MAX

    @staticmethod
    def _fnv1a(s: str) -> int:
        h = 0xCBF29CE484222325
        for b in s.encode("utf-8"):
            h ^= b
            h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        return h

    def tokenize(self, text: str) -> List[str]:
        return basic_tokenize(text, self.lowercase)

    def token_ids(self, text: str) -> List[int]:
        span, cache = self.vocab_size - 5, self._ids
        out = []
        for t in self.tokenize(text):
            i = cache.get(t)
            if i is None:
                if len(cache) >= _ID_CACHE_MAX:
                    cache.clear()
                i = cache[t] = 5 + self._fnv1a(t) % span
            out.append(i)
        return out


def encode_seqs(
    tokenizer,
    texts: Sequence[str],
    pairs: Optional[Sequence[str]] = None,
    max_len: int = 512,
) -> List[Tuple[List[int], List[int]]]:
    """Tokenize texts (optionally as (text, pair) inputs) into per-item
    (ids, token_types).

    Single: [CLS] A [SEP]            types 0...
    Pair:   [CLS] A [SEP] B [SEP]    types 0...0 1...1
    Pair truncation is longest-first (HF 'longest_first'): drop from the
    longer side, the pair side on ties."""
    seqs: List[Tuple[List[int], List[int]]] = []
    for i, text in enumerate(texts):
        a = tokenizer.token_ids(text)
        if pairs is not None:
            b = tokenizer.token_ids(pairs[i])
            budget = max_len - 3
            while len(a) + len(b) > budget:
                if len(a) > len(b):
                    a = a[:-1]
                else:
                    b = b[:-1]
            ids = [tokenizer.cls_id] + a + [tokenizer.sep_id] + b + [tokenizer.sep_id]
            types = [0] * (len(a) + 2) + [1] * (len(b) + 1)
        else:
            a = a[: max_len - 2]
            ids = [tokenizer.cls_id] + a + [tokenizer.sep_id]
            types = [0] * len(ids)
        seqs.append((ids, types))
    return seqs


def pack_seqs(
    tokenizer,
    seqs: Sequence[Tuple[List[int], List[int]]],
    pad_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack (ids, types) items into padded (input_ids, attention_mask,
    token_type_ids) int32 arrays."""
    longest = max((len(s) for s, _ in seqs), default=1)
    width = pad_to if pad_to is not None else longest
    if width < longest:
        raise ValueError(f"pad_to={width} is shorter than the longest item ({longest})")

    n = len(seqs)
    input_ids = np.full((n, width), tokenizer.pad_id, dtype=np.int32)
    attn = np.zeros((n, width), dtype=np.int32)
    ttype = np.zeros((n, width), dtype=np.int32)
    for i, (ids, types) in enumerate(seqs):
        input_ids[i, : len(ids)] = ids
        attn[i, : len(ids)] = 1
        ttype[i, : len(types)] = types
    return input_ids, attn, ttype


def encode_batch(
    tokenizer,
    texts: Sequence[str],
    pairs: Optional[Sequence[str]] = None,
    max_len: int = 512,
    pad_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """encode_seqs + pack_seqs in one call (the trainers' batches)."""
    return pack_seqs(tokenizer, encode_seqs(tokenizer, texts, pairs, max_len), pad_to)


def pad_bucket(n: int, buckets: Sequence[int] = (16, 32, 64, 128, 256, 512)) -> int:
    """Smallest bucket >= n (the last bucket when n exceeds them all)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
