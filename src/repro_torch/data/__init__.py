"""Data substrate: the deterministic, resumable LM pipeline."""
from .pipeline import ByteCorpus, DataConfig, LMDataSource  # noqa: F401
