"""Ported architecture configs (one module per arch id). Importing this
package registers every config with ``repro_torch.config``."""
from . import lipconvnet_15, mamba2_130m, qwen2_72b, zamba2_2p7b  # noqa: F401
