"""Optimizers and LR schedules (port of ``repro/optim``; gradient
compression is not ported yet)."""
from .adamw import (OptimizerConfig, clip_by_global_norm, global_norm,  # noqa: F401
                    init, update)
from .schedules import constant, warmup_cosine, warmup_linear  # noqa: F401
