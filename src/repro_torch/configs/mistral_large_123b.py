"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768. [hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from repro_torch.config import ModelConfig, register

FULL = ModelConfig(
    name="mistral-large-123b", family="decoder",
    num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=32768,
    mlp_type="swiglu", rope_theta=1e6,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)

SMOKE = ModelConfig(
    name="mistral-large-123b", family="decoder",
    num_layers=2, d_model=96, num_heads=6, num_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=256,
    mlp_type="swiglu", rope_theta=1e6,
    dtype="f32", param_dtype="f32", remat="none", attn_chunk=32,
)

register(FULL, SMOKE)
