"""Ported architecture configs (one module per arch id). Importing this
package registers every config with ``repro_torch.config``."""
from . import (gemma_7b, granite_34b, lipconvnet_15, mamba2_130m,  # noqa: F401
               mistral_large_123b, phi35_moe_42b, pixtral_12b, qwen2_72b,
               qwen3_moe_30b, seamless_m4t_medium, zamba2_2p7b)
