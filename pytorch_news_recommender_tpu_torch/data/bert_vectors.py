"""Offline per-news BERT sentence vectors (the ``nrms_bert`` news table).

The reference produces this artifact with a running bert-as-service server
(``data_processor.py:45-65`` of the MIND_2020 code): encode every news title
and abstract, average the two vectors, prepend a zero pad row, and save
``news_embeds_{dim}.npz`` under the ``embeddings`` key. Missing abstracts fall
back to the title (the reference's ``fillna(method='ffill', axis=1)``).

This version needs no serving daemon: it runs a local HuggingFace
``transformers`` encoder, on the CUDA card unless the caller asks for the
CPU, with masked mean pooling over the last hidden layer, bert-as-service's
default REDUCE_MEAN strategy. The artifact layout is the JAX package's, so
either package's ``preprocess --bert-npz`` reads it.
"""

from __future__ import annotations

import pathlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from pytorch_news_recommender_tpu_torch.data.mind import NewsTable


def _masked_mean(last_hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    m = attention_mask.unsqueeze(-1).to(last_hidden.dtype)
    return (last_hidden * m).sum(1) / m.sum(1).clamp(min=1.0)


def encode_texts(
    texts: Sequence[str],
    model,
    tokenizer,
    batch_size: int = 64,
    max_length: int = 64,
) -> np.ndarray:
    """Encode sentences -> ``[len(texts), dim]`` float32 (masked mean pool),
    on the device that holds ``model``."""
    model.eval()
    device = next(model.parameters()).device
    out: List[np.ndarray] = []
    with torch.no_grad():
        for i in range(0, len(texts), batch_size):
            chunk = [t if t else "." for t in texts[i:i + batch_size]]
            enc = tokenizer(chunk, padding=True, truncation=True,
                            max_length=max_length, return_tensors="pt").to(device)
            hidden = model(**enc).last_hidden_state
            out.append(_masked_mean(hidden, enc["attention_mask"])
                       .float().cpu().numpy())
    return np.concatenate(out, axis=0)


def encode_news_table(
    news: NewsTable,
    model,
    tokenizer,
    batch_size: int = 64,
    max_length: int = 64,
) -> np.ndarray:
    """``(title_vec + abstract_vec) / 2`` per news, zero row 0.

    Row ``i`` corresponds to news index ``i`` (1-based like every other
    per-news table; ``NewsTable.index``). Empty abstracts use the title,
    matching the reference's forward-fill.
    """
    titles = list(news.title)
    absts = [a if a.strip() else t for a, t in zip(news.abstract, titles)]
    tv = encode_texts(titles, model, tokenizer, batch_size, max_length)
    av = encode_texts(absts, model, tokenizer, batch_size, max_length)
    embeds = ((tv + av) / 2.0).astype(np.float32)
    return np.concatenate([np.zeros((1, embeds.shape[1]), np.float32),
                           embeds], axis=0)


def build_bert_vectors(
    news_tsv_paths: Sequence[str | pathlib.Path],
    model_path: str,
    out_npz: str | pathlib.Path,
    batch_size: int = 64,
    max_length: int = 64,
    device: Optional[str | torch.device] = None,
) -> np.ndarray:
    """End-to-end job: news TSVs -> ``news_embeds_{dim}.npz``.

    ``model_path`` is a local HF checkpoint directory (nothing is
    downloaded). News rows follow the same first-seen-dedup order as
    :func:`data.mind.build_dataset`, so indices line up with every other
    artifact. ``device`` None means the CUDA card, which must then exist.
    """
    from pytorch_news_recommender_tpu_torch.serve import resolve_device

    device = resolve_device(device)
    try:
        from transformers import AutoModel, AutoTokenizer
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "transformers is required for BERT vector generation") from e

    news = NewsTable()
    for p in news_tsv_paths:
        news.add_split(pathlib.Path(p))
    model = AutoModel.from_pretrained(model_path, local_files_only=True).to(device)
    tokenizer = AutoTokenizer.from_pretrained(model_path, local_files_only=True)
    embeds = encode_news_table(news, model, tokenizer, batch_size, max_length)
    out = pathlib.Path(out_npz)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, embeddings=embeds)
    return embeds
