"""Model configuration + the arch registry (port of ``repro/config.py``).

Only the fields the ported families read are kept: the decoder (dense,
with the swiglu / geglu / gelu MLPs and ``attn_impl``, and MoE with the
``moe_*`` fields), the ``ssm`` / ``hybrid`` Mamba2 families, the
``encdec`` family (``enc_layers``), the ``vlm`` family (the ``frontend*``
fields: its patches' width and count) and the ``image`` family. Their
names and defaults equal
``repro.config.ModelConfig``, so configs convert one for one.
``use_pallas`` stays a field for that reason alone: kernel choice in the
port follows the tensors' device, not this flag (``kernels/ops.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # decoder (dense or MoE) | encdec | ssm | hybrid
    #                          | vlm | image
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    mlp_type: str = "swiglu"         # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    embed_scale: bool = False
    logit_softcap: float = 0.0

    # MoE (models/moe.py)
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_segment: int = 2048          # token segment for dispatch transients

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    attn_every: int = 0              # hybrid: shared attn block every k layers

    # encoder-decoder
    enc_layers: int = 0

    # image family (1-Lipschitz GS-SOC convnet; models/image.py)
    image_size: int = 0              # input H = W
    in_channels: int = 3
    num_classes: int = 0
    base_width: int = 0              # stage-0 conv width (doubles per block)
    conv_layer: str = "gs_soc"       # gs_soc | soc
    conv_groups: Tuple[int, int] = (1, 1)   # GS group counts (g1, g2)
    conv_kernel: int = 3
    conv_terms: int = 6              # conv-exponential Taylor terms
    conv_activation: str = "maxmin"  # maxmin | maxmin_permuted
    paired_shuffle: bool = False

    # modality frontend stub (vlm / encdec: precomputed embeddings)
    frontend: str = "none"           # none | patch | frames
    frontend_dim: int = 0
    frontend_tokens: int = 0         # patches prepended (vlm)

    dtype: str = "bf16"
    param_dtype: str = "bf16"
    use_pallas: bool = False         # kept for one-for-one conversion; unread
    remat: str = "full"              # full | dots | none (training forward)
    attn_chunk: int = 1024
    ssd_chunk: int = 256
    attn_impl: str = "dense"         # dense | prefix_loop (causal prefill)
    seq_parallel: bool = False       # Megatron-SP: residual split on seq

    source: str = ""

    @property
    def d_head(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def act_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def weight_dtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    def padded_vocab(self, multiple: int = 16) -> int:
        v = self.vocab_size
        return ((v + multiple - 1) // multiple) * multiple

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: Dict[str, ModelConfig] = {}
_SMOKE: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke
    return cfg


def get_config(name: str) -> ModelConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    _load_all()
    if name not in _SMOKE:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_SMOKE)}")
    return _SMOKE[name]


def _load_all() -> None:
    from repro_torch import configs  # noqa: F401  (registers everything)


def parse_overrides(pairs) -> dict:
    """--set key=value CLI overrides with literal-ish parsing."""
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        for cast in (int, float):
            try:
                out[k] = cast(v)
                break
            except ValueError:
                continue
        else:
            out[k] = {"true": True, "false": False}.get(v.lower(), v)
    return out
