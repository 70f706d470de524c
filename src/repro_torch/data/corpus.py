"""Tokenized corpora as lake tables.

Port of `repro/data/corpus.py`, written through the port's own lake writer:
the same arguments give the same bytes as the reference's files.

One row per token.  Columns chosen so every lakeformat encoding earns its
keep on real training data:

  token    BITPACK(ceil(log2 V))  — e.g. 18 bits for a 152k vocab: the
                                     host->device copy shrinks 1.78x vs int32
  doc_id   DELTA                  — monotone, ~1-2 bits/token
  quality  RLE                    — per-document score replicated per token:
                                     long runs; this is the pushdown column
  lang     RLE/DICT               — per-document label

Row groups default to 65,536 tokens = 16 bitpack blocks; zone maps on
quality/doc_id drive row-group pruning for quality-threshold pushdown.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from repro_torch.lakeformat.schema import ColumnSchema, TableSchema
from repro_torch.lakeformat.writer import write_table

LANGS = ["en", "de", "fr", "zh", "es", "ja", "ko", "pt"]


def corpus_schema() -> TableSchema:
    return TableSchema(
        "corpus",
        [
            ColumnSchema("token", "int32", "bitpack"),
            ColumnSchema("doc_id", "int32", "delta"),
            ColumnSchema("quality", "int32", "rle"),
            ColumnSchema("lang", "str"),
        ],
    )


def synth_corpus(n_tokens: int, vocab: int, seed: int = 0,
                 mean_doc: int = 2048) -> Dict[str, np.ndarray]:
    """Synthetic corpus with zipf-ish tokens and per-document metadata."""
    rng = np.random.default_rng(seed)
    # zipf-ish without scipy: inverse-CDF on 1/rank
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    tokens = rng.choice(vocab, size=n_tokens, p=probs).astype(np.int64)

    n_docs = max(1, n_tokens // mean_doc)
    doc_lens = rng.integers(mean_doc // 2, mean_doc * 3 // 2, size=n_docs)
    doc_ids = np.repeat(np.arange(n_docs), doc_lens)[:n_tokens]
    if doc_ids.shape[0] < n_tokens:
        doc_ids = np.pad(doc_ids, (0, n_tokens - doc_ids.shape[0]), constant_values=n_docs - 1)
    doc_quality = rng.integers(0, 101, size=n_docs + 1)
    quality = doc_quality[doc_ids]
    doc_lang = rng.integers(0, len(LANGS), size=n_docs + 1)
    lang = [LANGS[i] for i in doc_lang[doc_ids]]
    return {"token": tokens, "doc_id": doc_ids.astype(np.int64),
            "quality": quality.astype(np.int64), "lang": lang}


def write_corpus(dirpath: str, n_tokens: int, vocab: int, n_shards: int = 2,
                 seed: int = 0, row_group_size: int = 65536) -> List[str]:
    os.makedirs(dirpath, exist_ok=True)
    paths = []
    per = n_tokens // n_shards
    for s in range(n_shards):
        data = synth_corpus(per, vocab, seed=seed + s)
        p = os.path.join(dirpath, f"shard_{s:05d}.lake")
        write_table(p, corpus_schema(), data, row_group_size)
        paths.append(p)
    return paths
