"""MIND text tokenization, as far as serving needs it.

The port's copy of the tokenizer in the JAX package's ``data/mind.py``:
lowercase, delete digit characters, ``\\w+`` tokens, keep in-vocabulary
words. ``Recommender.tokenize_new_news`` uses it to turn the title of a news
item that was not in the corpus into word ids with the persisted word
dictionary. Preprocessing of the MIND TSVs is not ported yet (see
``ROADMAP.md``).
"""

from __future__ import annotations

import re
from typing import Dict, List

_TOKEN_RE = re.compile(r"\w+")
_DIGITS_TABLE = str.maketrans("", "", "0123456789")


def tokenize(text: str) -> List[str]:
    """Lowercase, delete digit chars, ``\\w+`` tokens."""
    return _TOKEN_RE.findall(text.lower().translate(_DIGITS_TABLE))


tokenize_for_ids = tokenize


def _to_ids(text: str, vocab: Dict[str, int], length: int) -> List[int]:
    """In-vocabulary word ids of ``text``, cut or zero-padded to ``length``."""
    ids = [vocab[w] for w in tokenize_for_ids(text) if w in vocab]
    ids = ids[:length]
    return ids + [0] * (length - len(ids))
