"""Data substrate: the deterministic, resumable LM pipeline and synthetic
batches for every ported family."""
from .pipeline import ByteCorpus, DataConfig, LMDataSource  # noqa: F401
from .synthetic import image_batch, lm_batch  # noqa: F401
