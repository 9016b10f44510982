"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 blocks + shared attention block every 6
layers (weights shared, caches per application). [arXiv:2411.15242; hf]"""
from repro_torch.config import ModelConfig, register

FULL = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_groups=1,
    attn_every=6, rope_theta=1e4, mlp_type="swiglu",
    source="arXiv:2411.15242",
)

SMOKE = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_groups=1,
    attn_every=2, rope_theta=1e4, mlp_type="swiglu",
    dtype="f32", param_dtype="f32", remat="none", attn_chunk=32, ssd_chunk=16,
)

register(FULL, SMOKE)
