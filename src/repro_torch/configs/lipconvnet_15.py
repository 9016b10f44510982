"""lipconvnet-15 [image]: the paper's Table 3 certified-robustness model —
5 blocks x 3 GS-SOC orthogonal conv layers, base width 32 doubling per
block, MaxMinPermuted activations, spectral-normalized head; CIFAR-100
geometry (32x32x3, 100 classes). GS groups (4, 1): grouped 3x3 exp-conv +
paired channel shuffle + ungrouped 1x1 exp-conv (Table 3 row "4-1").

The smoke variant shrinks to depth 10 / width 8 / 10 classes in f32.
32x32 inputs are structural: five space-to-depth halvings need
image_size % 32 == 0. Same values as ``repro/configs/lipconvnet_15.py``.
"""
from repro_torch.config import ModelConfig, register

FULL = ModelConfig(
    name="lipconvnet-15", family="image",
    num_layers=15, d_model=32, base_width=32,
    image_size=32, in_channels=3, num_classes=100,
    conv_layer="gs_soc", conv_groups=(4, 1), conv_terms=6,
    conv_activation="maxmin_permuted", paired_shuffle=True,
    source="GorbunovYSANR24 Table 3",
)

SMOKE = ModelConfig(
    name="lipconvnet-15", family="image",
    num_layers=10, d_model=8, base_width=8,
    image_size=32, in_channels=3, num_classes=10,
    conv_layer="gs_soc", conv_groups=(2, 1), conv_terms=4,
    conv_activation="maxmin_permuted", paired_shuffle=True,
    dtype="f32", param_dtype="f32", remat="none",
)

register(FULL, SMOKE)
