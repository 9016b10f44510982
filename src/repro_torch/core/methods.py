"""MethodOps registry (port of ``repro/core/methods.py``): gsoft,
double_gsoft, oft, boft, householder, givens and lora, one explicit record
each. ``core.adapters`` and ``core.peft`` dispatch only through
``get(name)``; an unknown method raises a KeyError listing what is
registered. This is the one module of the port that compares method
strings (``tests/test_torch_methods.py`` guards it, as
``tests/test_methods.py`` guards the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from . import adapters as _ad

# methods that mean "no adapters at all" — training regimes, never registered
NON_ADAPTER_METHODS = ("full", "none")


@dataclasses.dataclass(frozen=True)
class MethodOps:
    """The per-method call surface.

    * ``structure`` — one-liner for docs; ``orthogonal`` — capability flag
    * ``init_params(spec, generator, dtype, device)`` — identity-init params
    * ``materialize(spec, params, W)`` — W_eff (weight-side; unbatched
      unless ``stacked``)
    * ``stacked`` — ``materialize`` also takes a stack: W (lead..., d_in,
      d_out) with params (lead..., ...), one kernel launch per rotation for
      the whole stack (its slices the kernels' rows); otherwise
      ``adapters.materialize`` loops over the slices
    * ``apply_activation_side(spec, params, x)`` — x -> x Q, or None
    * ``param_count(spec)`` — analytic count
    * ``bank_build(spec, params_by_slot, device)`` — per-slot serving stacks,
      or None (``bank_unsupported`` says why)
    * ``bank_rotator(entry, slots, x)`` — per-row x Q_slot
    * ``quant_fuse(entry, slots, dtype)`` — the hand-off to the fused
      rotate + quantized matmul (GSOFT: its bank and the slot ids, for
      ``ops.gs_q_matmul_bank``), or None (the rotation then applies to the
      activations before ``q_matmul``)
    * ``quant_compatible`` — may serve over quantized base weights (the
      rotation applies activation-side, in float, before the int8 matmul)
    * ``banked_kernel`` — the kernel family the banked rotation rides
      ("gs" / "bdmm"; "" = plain torch only)
    * ``bank_shard_axes(factor, shape)`` — serve-time tensor parallelism:
      which axis of a built bank-factor stack may split over the mesh
      'model' axis (None / absent: replicate; ``sharding.specs.
      bank_spec_tree`` is its one reader)
    * ``bank_gather(entry, ids, width, all_gather)`` — the batch's slots of
      a stack split per ``bank_shard_axes``, whole, and the ids that read
      them (a rank holds only its part of every slot)
    """
    method: str
    structure: str
    orthogonal: bool
    init_params: Callable
    materialize: Callable
    param_count: Callable
    apply_activation_side: Optional[Callable] = None
    bank_build: Optional[Callable] = None
    bank_rotator: Optional[Callable] = None
    bank_unsupported: str = ""
    quant_fuse: Optional[Callable] = None
    quant_compatible: bool = False
    banked_kernel: str = ""
    bank_shard_axes: Optional[Callable] = None
    bank_gather: Optional[Callable] = None
    stacked: bool = False


_METHODS: Dict[str, MethodOps] = {}


def register(ops: MethodOps) -> MethodOps:
    _METHODS[ops.method] = ops
    return ops


def get(method: str) -> MethodOps:
    if method not in _METHODS:
        raise KeyError(f"unknown adapter method {method!r}; registered "
                       f"methods: {sorted(_METHODS)}")
    return _METHODS[method]


def registered():
    return sorted(_METHODS)


def is_adapter_method(method: str) -> bool:
    return method not in NON_ADAPTER_METHODS


def trainable_split(method: str, params, adapters):
    """(trainable, frozen) for the optimizer — the one place the
    ``full``/``none`` pseudo-methods are interpreted."""
    if method == "full":
        return params, adapters      # adapters empty; everything trains
    if method == "none":
        return {}, params
    get(method)                      # fail fast on unknown methods
    return adapters, params


register(MethodOps(
    method="gsoft",
    stacked=True,
    structure="Q = P^T L P R (two-factor GS, paper eq. 1)",
    orthogonal=True,
    init_params=_ad.gsoft_init,
    materialize=_ad.gsoft_materialize,
    param_count=_ad.gsoft_param_count,
    apply_activation_side=_ad.gsoft_apply_T,
    bank_build=_ad.gsoft_bank_build,
    bank_rotator=_ad.gs_rotate_banked,
    quant_fuse=_ad.gsoft_quant_fuse,
    bank_shard_axes=_ad.gsoft_bank_shard_axes,
    bank_gather=_ad.gsoft_bank_gather,
    quant_compatible=True,
    banked_kernel="gs",
))

register(MethodOps(
    method="double_gsoft",
    stacked=True,
    structure="W_eff = Q_U W Q_V (two-sided GS, paper §4)",
    orthogonal=True,
    init_params=_ad.double_gsoft_init,
    materialize=_ad.double_gsoft_materialize,
    param_count=_ad.double_gsoft_param_count,
    bank_unsupported=("its output-side factor Q_V rotates AFTER the base "
                      "matmul, which the per-request serving hook does not "
                      "carry yet — merge it offline instead"),
))

register(MethodOps(
    method="oft",
    stacked=True,
    structure="Q = diag(Q_1..Q_r) (block-diagonal, OFT)",
    orthogonal=True,
    init_params=_ad.oft_init,
    materialize=_ad.oft_materialize,
    param_count=_ad.oft_param_count,
    apply_activation_side=_ad.oft_apply_T,
    bank_build=_ad.oft_bank_build,
    bank_rotator=_ad.oft_rotate_banked,
    quant_compatible=True,
    banked_kernel="bdmm",
))

register(MethodOps(
    method="boft",
    stacked=True,
    structure="Q = B_m..B_1 (block butterfly, BOFT)",
    orthogonal=True,
    init_params=_ad.boft_init,
    materialize=_ad.boft_materialize,
    param_count=_ad.boft_param_count,
    apply_activation_side=_ad.boft_apply_T,
    bank_build=_ad.boft_bank_build,
    bank_rotator=_ad.boft_rotate_banked,
    quant_compatible=True,
    banked_kernel="bdmm",
))

register(MethodOps(
    method="householder",
    structure="Q = H_1..H_k, H_i = I - 2 v_i v_i^T (HOFT)",
    orthogonal=True,
    init_params=_ad.householder_init,
    materialize=_ad.householder_materialize,
    param_count=_ad.householder_param_count,
    apply_activation_side=_ad.householder_apply_T,
    bank_build=_ad.householder_bank_build,
    bank_rotator=_ad.householder_rotate_banked,
    quant_compatible=True,
))

register(MethodOps(
    method="givens",
    structure="Q = G_m..G_1 (brick-wall Givens rounds, GOFT)",
    orthogonal=True,
    init_params=_ad.givens_init,
    materialize=_ad.givens_materialize,
    param_count=_ad.givens_param_count,
    apply_activation_side=_ad.givens_apply_T,
    bank_build=_ad.givens_bank_build,
    bank_rotator=_ad.givens_rotate_banked,
    quant_compatible=True,
))

register(MethodOps(
    method="lora",
    stacked=True,
    structure="W + (alpha/r) A B (low-rank residual)",
    orthogonal=False,
    init_params=_ad.lora_init,
    materialize=_ad.lora_materialize,
    param_count=_ad.lora_param_count,
    bank_unsupported=("it is weight-side only — the low-rank residual "
                      "W + (alpha/r) A B is not an orthogonal rotation of "
                      "the inputs, so there is no activation-side form to "
                      "bank; merge it offline instead"),
))
