"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) expert
d_ff=768 vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.config import ModelConfig, register

FULL = ModelConfig(
    name="qwen3-moe-30b-a3b", family="decoder",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936,
    moe_experts=128, moe_top_k=8, moe_d_ff=768,
    mlp_type="swiglu", rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
)

SMOKE = ModelConfig(
    name="qwen3-moe-30b-a3b", family="decoder",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=256,
    moe_experts=8, moe_top_k=2, moe_d_ff=32,
    mlp_type="swiglu", rope_theta=1e6,
    dtype="f32", param_dtype="f32", remat="none", attn_chunk=32,
)

register(FULL, SMOKE)
