"""seamless-m4t-medium [audio]: 12L enc + 12L dec, d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206 — enc-dec; speech frontend is a STUB providing
precomputed frame embeddings (B, F, d). [arXiv:2308.11596; hf]

Vocab 256206 pads to 256208 for 16-way vocab sharding (DESIGN §5).
"""
from repro_torch.config import ModelConfig, register

FULL = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, enc_layers=12,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206,
    mlp_type="gelu", rope_theta=1e4,
    frontend="frames", frontend_dim=1024,
    source="arXiv:2308.11596",
)

SMOKE = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=2, enc_layers=2,
    d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    mlp_type="gelu", rope_theta=1e4,
    frontend="frames", frontend_dim=64,
    dtype="f32", param_dtype="f32", remat="none", attn_chunk=32,
)

register(FULL, SMOKE)
