"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — GQA with QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.config import ModelConfig, register

FULL = ModelConfig(
    name="qwen2-72b", family="decoder",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064,
    mlp_type="swiglu", qkv_bias=True, rope_theta=1e6,
    source="arXiv:2407.10671",
)

SMOKE = ModelConfig(
    name="qwen2-72b", family="decoder",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    mlp_type="swiglu", qkv_bias=True, rope_theta=1e6,
    dtype="f32", param_dtype="f32", remat="none", attn_chunk=32,
)

register(FULL, SMOKE)
