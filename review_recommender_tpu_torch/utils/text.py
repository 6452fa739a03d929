"""Text helpers: query and document tokenizers, attribute vocabularies,
gate groups.

A jax-free copy of the parts of `review_recommender_tpu/utils/text.py` that
the query path and the index builder call (the JAX package's
`utils/__init__.py` imports its numerics module, which loads jax). The copy
stays: the port imports nothing of the JAX package, whose files this round
leaves as they are. The query featurizer's C++ route
(native/featurizer.cc) reads these tables. The document tokenizer runs the
C++ route (native/tokenizer.cc) unless the caller asks for the Python one;
unlike the JAX package, it never switches route by itself.
"""
from __future__ import annotations

import re
from typing import Dict, List, Set

TOKEN_RE = re.compile(r"[a-z0-9]+(?:'[a-z0-9]+)?")

STOP_WORDS = {
    "a", "an", "the", "and", "or", "of", "for", "to", "in", "on", "with",
    "is", "are", "it", "this", "that",
}

SYNONYMS: Dict[str, Set[str]] = {
    "sock": {"sock", "socks"},
    "headphone": {"headphone", "headphones", "earphone", "earphones",
                  "earbud", "earbuds", "headset"},
    "keyboard": {"keyboard", "keyboards"},
    "wireless": {"wireless", "bluetooth"},
    "noise": {"noise cancelling", "noise-canceling", "noise canceling", "anc"},
    "cat": {"cat", "cats", "kitten", "kittens", "kitty"},
    "dog": {"dog", "dogs", "puppy", "puppies"},
    "design": {"design", "pattern", "print", "graphic", "artwork", "motif",
               "theme"},
}

COLORS: Dict[str, Set[str]] = {
    "yellow": {"yellow", "mustard", "lemon", "gold", "golden"},
    "red": {"red", "scarlet", "crimson", "maroon"},
    "blue": {"blue", "navy", "cobalt", "azure"},
    "green": {"green", "emerald", "olive"},
    "black": {"black"},
    "white": {"white", "ivory"},
    "pink": {"pink", "rose"},
    "purple": {"purple", "violet", "lavender"},
    "orange": {"orange", "amber"},
    "brown": {"brown", "tan", "beige", "khaki"},
    "gray": {"gray", "grey", "charcoal", "slate"},
}

# Bit i of a document's gate bitset is GATE_PHRASES[i]: the order is part of
# the index format and must match the JAX package's.
GATE_PHRASES: List[str] = sorted(
    {p for group in list(SYNONYMS.values()) + list(COLORS.values()) for p in group}
)
GATE_PHRASE_ID: Dict[str, int] = {p: i for i, p in enumerate(GATE_PHRASES)}

# the index tokenizer's stop list ("simple_en_v1": larger than the query's)
DOC_STOP_WORDS = {
    "a", "an", "and", "the", "is", "are", "am", "be", "been", "to", "for",
    "of", "in", "on", "at", "by",
    "it", "its", "this", "that", "with", "from", "as", "or", "if", "but",
    "than", "then", "so",
    "i", "you", "he", "she", "we", "they", "my", "your", "our", "their",
    "me", "him", "her", "us", "them",
    "was", "were", "will", "would", "should", "could", "may", "might",
    "can", "cannot", "cant", "won't",
}

DOC_TOKEN_CAP = 5000  # tokens kept per document


def tokenize_query(query: str) -> List[str]:
    """Lowercase regex tokens minus the query stop words."""
    tokens = TOKEN_RE.findall(query.lower())
    return [t for t in tokens if t not in STOP_WORDS]


def _tokenize_document_py(text: str, cap: int = DOC_TOKEN_CAP) -> List[str]:
    toks = [t for t in TOKEN_RE.findall(text.lower())
            if t not in DOC_STOP_WORDS and len(t) > 1]
    return toks[:cap]


def tokenize_document(text: str, cap: int = DOC_TOKEN_CAP, *, native: bool = True) -> List[str]:
    """The index tokenizer ("simple_en_v1"): regex tokens of the lowered
    text, minus DOC_STOP_WORDS and one-character tokens, the first `cap`.
    native=True (the default) runs the C++ tokenizer, building the port's
    native library on first use and raising if it cannot; native=False
    runs the Python version."""
    if not native:
        return _tokenize_document_py(text, cap)
    from review_recommender_tpu_torch.native import tokenize_document_native

    return tokenize_document_native(text, cap)


def build_gate_groups(query: str) -> List[Set[str]]:
    """Colour groups mentioned anywhere in the query, then synonym groups of
    known tokens, then singleton groups of tokens with >= 4 characters;
    deduplicated, capped at 6."""
    query_lower = query.lower()
    groups: List[Set[str]] = []

    for _color, color_synonyms in COLORS.items():
        if any(word in query_lower for word in color_synonyms):
            groups.append(color_synonyms)

    for token in tokenize_query(query):
        if token in SYNONYMS:
            groups.append(SYNONYMS[token])
        elif len(token) >= 4:
            groups.append({token})

    unique_groups: List[Set[str]] = []
    for group in groups:
        if group not in unique_groups:
            unique_groups.append(group)
    return unique_groups[:6]


def calculate_gate_factor(
    text: str, groups: List[Set[str]], penalty: float = 0.5
) -> tuple[float, int, int]:
    """Exact host gate: penalty^(#groups with no substring hit in text)."""
    text_lower = text.lower()
    hits = 0
    factor = 1.0
    for group in groups:
        if any(syn in text_lower for syn in group):
            hits += 1
        else:
            factor *= penalty
    return factor, hits, len(groups)
