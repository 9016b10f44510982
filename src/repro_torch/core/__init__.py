"""repro_torch.core — the paper's contribution: GS matrices, orthogonal
parametrization, projection (Algorithm 1), PEFT adapters and the serving
runtime, and the GS orthogonal convolutions (``core/conv.py``). The public
names of ``repro.core``."""
from .permutations import (PermSpec, apply_perm, apply_perm_T, gs_sigma,
                           paired_sigma, inverse_sigma, compose_sigma,
                           perm_matrix, is_permutation)
from .gs import (BlockDiagSpec, GSLayout, GSFactors, gsoft_layout,
                 pick_block_size, init_blocks, block_diag_matmul, gs_apply,
                 gs_apply_T, gs_matmul, gs_materialize, materialize_block_diag,
                 block_ranks, lowrank_blocks, gs_order_layout,
                 gs_factors_apply, gs_factors_materialize, min_factors_dense,
                 support_pattern, is_dense_class)
from .orthogonal import (skew, cayley, cayley_inverse, orthogonal_blocks,
                         orthogonality_error, project_orthogonal,
                         random_orthogonal_blocks)
from .projection import project_to_gs, gs_reconstruction_error
from .adapters import (AdapterSpec, init_adapter, materialize, merge,
                       num_adapter_params, butterfly_sigma,
                       apply_activation_side, gs_rotate_banked)
from .methods import MethodOps
from . import methods
from .peft import (PEFTConfig, init_peft, materialize_tree,
                   adapted_paths, count_params, flatten_paths,
                   trainable_and_frozen, DEFAULT_TARGETS, AdapterBank,
                   build_adapter_bank, AdapterContext, PrefillRequest,
                   BASE_ADAPTER)
