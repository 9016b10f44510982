"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) expert
d_ff=6400 vocab=32064, MoE 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.config import ModelConfig, register

FULL = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="decoder",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=6400, vocab_size=32064,
    moe_experts=16, moe_top_k=2, moe_d_ff=6400,
    mlp_type="swiglu", rope_theta=1e4,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)

SMOKE = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="decoder",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=256,
    moe_experts=4, moe_top_k=2, moe_d_ff=64,
    mlp_type="swiglu", rope_theta=1e4,
    dtype="f32", param_dtype="f32", remat="none", attn_chunk=32,
)

register(FULL, SMOKE)
