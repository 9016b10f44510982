"""gemma-7b [dense]: 28L d_model=3072 16H (kv=16, MHA) d_ff=24576
vocab=256000 — GeGLU, head_dim=256, tied + scaled embeddings.
[arXiv:2403.08295; hf]"""
from repro_torch.config import ModelConfig, register

FULL = ModelConfig(
    name="gemma-7b", family="decoder",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000,
    mlp_type="geglu", rope_theta=1e4,
    tie_embeddings=True, embed_scale=True,
    source="arXiv:2403.08295",
)

SMOKE = ModelConfig(
    name="gemma-7b", family="decoder",
    num_layers=2, d_model=48, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=96, vocab_size=256,
    mlp_type="geglu", rope_theta=1e4,
    tie_embeddings=True, embed_scale=True,
    dtype="f32", param_dtype="f32", remat="none", attn_chunk=32,
)

register(FULL, SMOKE)
