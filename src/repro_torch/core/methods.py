"""MethodOps registry (port of ``repro/core/methods.py``), holding the
methods ported so far: ``gsoft`` and ``double_gsoft``. ``core.adapters`` and
``core.peft`` dispatch only through ``get(name)``; an unknown method raises
a KeyError listing what is registered.
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

    * ``init_params(spec, generator, dtype, device)`` — identity-init params
    * ``materialize(spec, params, W)`` — W_eff (weight-side, unbatched)
    * ``apply_activation_side(spec, params, x)`` — x -> x Q
    * ``param_count(spec)`` — analytic count
    * ``bank_build(spec, params_by_slot, device)`` — per-slot serving stacks
    * ``bank_rotator(entry, slots, x)`` — per-row x Q_slot
    """
    method: str
    init_params: Callable
    materialize: Callable
    param_count: Callable
    apply_activation_side: Optional[Callable] = None
    bank_build: Optional[Callable] = None
    bank_rotator: Optional[Callable] = None
    bank_unsupported: str = ""


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
    method="gsoft",                  # Q = P^T L P R (paper eq. 1)
    init_params=_ad.gsoft_init,
    materialize=_ad.gsoft_materialize,
    param_count=_ad.gsoft_param_count,
    apply_activation_side=_ad.gsoft_apply_T,
    bank_build=_ad.gsoft_bank_build,
    bank_rotator=_ad.gs_rotate_banked,
))

register(MethodOps(
    method="double_gsoft",           # W_eff = Q_U W Q_V (paper §4)
    init_params=_ad.double_gsoft_init,
    materialize=_ad.double_gsoft_materialize,
    param_count=_ad.double_gsoft_param_count,
    bank_unsupported=("its output-side factor Q_V rotates AFTER the base "
                      "matmul, which the per-request serving hook does not "
                      "carry yet — merge it offline instead"),
))
