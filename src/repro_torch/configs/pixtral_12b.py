"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT frontend (STUB: precomputed patch embeddings) +
mistral-nemo decoder. [hf:mistralai/Pixtral-12B-2409; unverified]"""
from repro_torch.config import ModelConfig, register

FULL = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    mlp_type="swiglu", rope_theta=1e6,
    frontend="patch", frontend_dim=1024, frontend_tokens=256,
    source="hf:mistralai/Pixtral-12B-2409",
)

SMOKE = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    mlp_type="swiglu", rope_theta=1e6,
    frontend="patch", frontend_dim=32, frontend_tokens=8,
    dtype="f32", param_dtype="f32", remat="none", attn_chunk=32,
)

register(FULL, SMOKE)
