"""Data-lake-backed training data pipeline (port of `repro.data`)."""

from repro_torch.data.corpus import corpus_schema, write_corpus, synth_corpus  # noqa: F401
from repro_torch.data.pipeline import TokenPipeline  # noqa: F401
