"""Optimizers, LR schedules and int8 error-feedback gradient compression
(port of ``repro/optim``)."""
from .adamw import (OptimizerConfig, clip_by_global_norm, global_norm,  # noqa: F401
                    init, update)
from .schedules import constant, warmup_cosine, warmup_linear  # noqa: F401
from .compression import (compressed_psum_mean, ef_compress,  # noqa: F401
                          init_error_buffer)
