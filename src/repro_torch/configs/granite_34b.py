"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — code model. [arXiv:2405.04324; hf]

Param-count note: 34B is only consistent with the GPTBigCode-style 2-matrix
GELU MLP (88 * 2 * 6144 * 24576 ~ 26.6B) + MQA attention + tied embeddings;
a SwiGLU MLP would put it at 47B. We follow the parameter math (and the
granite-code paper) over the assignment's "llama-arch" shorthand.
"""
from repro_torch.config import ModelConfig, register

FULL = ModelConfig(
    name="granite-34b", family="decoder",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
    mlp_type="gelu", rope_theta=1e4, tie_embeddings=True,
    source="arXiv:2405.04324",
)

SMOKE = ModelConfig(
    name="granite-34b", family="decoder",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256,
    mlp_type="gelu", rope_theta=1e4, tie_embeddings=True,
    dtype="f32", param_dtype="f32", remat="none", attn_chunk=32,
)

register(FULL, SMOKE)
