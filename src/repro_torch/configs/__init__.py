"""Ported architecture configs (one module per arch id). Importing this
package registers every config with ``repro_torch.config``."""
from . import qwen2_72b  # noqa: F401
