"""mamba2-130m [ssm]: 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.config import ModelConfig, register

FULL = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768,
    vocab_size=50280, tie_embeddings=True,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_groups=1,
    source="arXiv:2405.21060",
)

SMOKE = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=2, d_model=64,
    vocab_size=256, tie_embeddings=True,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_groups=1,
    dtype="f32", param_dtype="f32", remat="none", ssd_chunk=16,
)

register(FULL, SMOKE)
