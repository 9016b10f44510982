"""Training the Mamba2 families in the port on the CPU, against the JAX
package: the SSD scan's gradients (the plain version the card's
``ssd_bwd`` kernel is held to) against ``jax.grad`` of JAX's plain scan,
a plain emulation of the kernel's chunked backward (reverse chunk chain,
the dloga terms) against autograd, and the ``mamba2-130m`` /
``zamba2-2.7b`` smoke GSOFT losses and adapter gradients against JAX's
``value_and_grad`` of the same loss, with ``remat`` full and none.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.data.synthetic import lm_batch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ssd as tssd  # noqa: E402
from repro_torch.train.steps import build_grad_fn  # noqa: E402

SHAPES = [(1, 64, 2, 8, 16), (2, 100, 3, 8, 16), (1, 1000, 2, 4, 8),
          (1, 5, 1, 3, 5)]


def _inputs(nb, t, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nb, t, h, p)).astype(np.float32),
            (-np.abs(rng.standard_normal((nb, t, h))) * 0.3).astype(np.float32),
            (rng.standard_normal((nb, t, h, n)) * 0.5).astype(np.float32),
            (rng.standard_normal((nb, t, h, n)) * 0.5).astype(np.float32),
            rng.standard_normal((nb, t, h, p)).astype(np.float32))


def _jax_grads(x, la, B, C, dy, chunk):
    def f(*a):
        return jnp.sum(jops.ssd(*a, chunk=chunk) * dy)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, la, B, C)))]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssd_gradients_equal_jax_grad(shape):
    """``ssd_bwd`` on CPU tensors (its plain version) and autograd through
    ``ops.ssd`` give JAX's ``jax.grad`` of its plain scan, ragged T
    included (T = 100, 1000, 5), within 2e-4 of each gradient's largest
    entry (fp32 sums in different orders)."""
    x, la, B, C, dy = _inputs(*shape)
    want = _jax_grads(x, la, B, C, dy, 64)
    got = tssd.ssd_bwd(*(torch.tensor(a) for a in (x, la, B, C, dy)), chunk=64)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, la, B, C)]
    tops.ssd(*leaves, chunk=64).backward(torch.tensor(dy))
    for w, g, a in zip(want, got, leaves):
        tol = 2e-4 * np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, atol=tol)
        np.testing.assert_allclose(a.grad.numpy(), w, atol=tol)


def test_ssd_gradients_in_bf16_follow_jax():
    """bf16 inputs: the plain version's gradients come back in bf16 and
    agree with JAX's on the same bf16 inputs to bf16's rounding (1e-2 of
    each gradient's largest entry)."""
    x, la, B, C, dy = _inputs(2, 130, 2, 8, 16, seed=3)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (x, la, B, C)]
    dyb = jnp.asarray(dy, jnp.bfloat16)

    def f(*a):
        return jnp.sum(jops.ssd(*a, chunk=64).astype(jnp.float32)
                       * dyb.astype(jnp.float32))
    want = [np.asarray(g, np.float32)
            for g in jax.grad(f, argnums=(0, 1, 2, 3))(*bf)]
    tb = [torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
          for a in bf]
    got = tssd.ssd_bwd(*tb, torch.tensor(np.asarray(dyb, np.float32))
                       .to(torch.bfloat16), chunk=64)
    for w, g in zip(want, got):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w,
                                   atol=1e-2 * np.abs(w).max())


def _emulate(x, la, B, C, dy, Q=64):
    """csrc/ssd_bwd.cu's arithmetic in fp64, chunk by chunk in reverse: the
    forward's chunk-start states, then per chunk G = (C B^T) o L, M =
    (dy x^T) o L, dx / dB / dC / dS_in and dcum from the scores, S_in and
    dS_out, dloga the reverse cumsum of dcum."""
    nb, T, H, P = x.shape
    N = B.shape[-1]
    nc = -(-T // Q)
    pad = lambda a: torch.cat([a, a.new_zeros((nb, nc * Q - T) + a.shape[2:])],
                              1).double()  # noqa: E731
    x, la, B, C, dy = map(pad, (x, la, B, C, dy))
    sin = []
    s = x.new_zeros(nb, H, N, P)
    for c in range(nc):
        sin.append(s)
        q = slice(c * Q, (c + 1) * Q)
        cum = la[:, q].cumsum(1)
        w = torch.exp(cum[:, -1:] - cum)
        s = (torch.exp(cum[:, -1])[..., None, None] * s
             + torch.einsum("zqhn,zqhp->zhnp", B[:, q] * w[..., None], x[:, q]))
    out = [torch.zeros_like(a) for a in (x, la, B, C)]
    dout = x.new_zeros(nb, H, N, P)
    tril = torch.tril(torch.ones(Q, Q, dtype=torch.bool))[None, :, :, None]
    for c in reversed(range(nc)):
        q = slice(c * Q, (c + 1) * Q)
        xq, Bq, Cq, dq = x[:, q], B[:, q], C[:, q], dy[:, q]
        cum = la[:, q].cumsum(1)
        tot = cum[:, -1]
        ecum, wdec = torch.exp(cum), torch.exp(tot[:, None] - cum)
        L = torch.exp((cum[:, :, None] - cum[:, None]).masked_fill(~tril, -1e300))
        G = torch.einsum("zthn,zshn->ztsh", Cq, Bq) * L
        D = torch.einsum("zthp,zshp->ztsh", dq, xq)
        M = D * L
        dcum = (G * D).sum(2) - (G * D).sum(1)
        dcum = dcum + ecum * (dq * torch.einsum("zthn,zhnp->zthp", Cq,
                                                 sin[c])).sum(-1)
        Z = torch.einsum("zshn,zhnp->zshp", Bq, dout)
        u = wdec * (xq * Z).sum(-1)
        dcum = dcum - u
        dcum[:, -1] += (torch.exp(tot) * (sin[c] * dout).sum((-1, -2))
                        + u.sum(1))
        out[0][:, q] = torch.einsum("ztsh,zthp->zshp", G, dq) + wdec[..., None] * Z
        out[1][:, q] = dcum.flip(1).cumsum(1).flip(1)
        out[2][:, q] = (torch.einsum("ztsh,zthn->zshn", M, Cq) + wdec[..., None]
                        * torch.einsum("zshp,zhnp->zshn", xq, dout))
        out[3][:, q] = (torch.einsum("ztsh,zshn->zthn", M, Bq) + ecum[..., None]
                        * torch.einsum("zthp,zhnp->zthn", dq, sin[c]))
        dout = (torch.exp(tot)[..., None, None] * dout
                + torch.einsum("zthn,zthp->zhnp", Cq * ecum[..., None], dq))
    return [a[:, :T] for a in out]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_arithmetic_equals_autograd(shape):
    """The backward kernel's formulas (emulated in fp64 at its chunk of 64)
    give autograd's gradients of the plain scan (fp32) to fp32 rounding."""
    args = [torch.tensor(a) for a in _inputs(*shape, seed=5)]
    want = tssd.ssd_bwd_plain(*[a.double() for a in args])
    got = _emulate(*args, Q=tssd.CHUNK)
    for w, g in zip(want, got):
        tol = 1e-5 * float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.double().numpy(), atol=tol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_case(arch):
    """JAX's params, random GSOFT adapters (b = 8), batch 4 x 16, and its
    jitted value_and_grad of the materialized loss, once per arch."""
    jcfg = jax_smoke_config(arch)
    params = japi.init_params(jcfg, jax.random.PRNGKey(0))
    jp = jpeft.PEFTConfig(method="gsoft", block_size=8)
    ads = jpeft.init_peft(jp, params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    ads = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32) * 0.05), ads)
    batch = lm_batch(jcfg, batch=4, seq=16)

    def jloss(a):
        return japi.loss_fn(jcfg, jpeft.materialize_tree(jp, params, a),
                            batch)[0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(ads)
    return _np(params), _np(ads), _np(batch), float(jl), _np(jg)


@pytest.mark.parametrize("remat", ("full", "none"))
@pytest.mark.parametrize("arch", ("mamba2-130m", "zamba2-2.7b"))
def test_gsoft_loss_and_adapter_gradients_equal_jax(arch, remat):
    """Random (non-identity) GSOFT adapters, b = 8, batch 4 x 16: the
    port's loss equals JAX's to 1e-5 relative, every adapter gradient
    within 1e-3 of its largest entry (JAX's value_and_grad of the same
    materialized loss)."""
    params, ads, batch, jl, jg = _jax_case(arch)
    cfg = get_smoke_config(arch).with_overrides(remat=remat)
    tp = tpeft.PEFTConfig(method="gsoft", block_size=8)
    frozen = convert.params_from_numpy(params, "cpu")
    trainable = convert.adapters_from_numpy(ads, "cpu")
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    loss, _, grads = build_grad_fn(cfg, tp)(trainable, frozen, tb)
    np.testing.assert_allclose(float(loss), jl, rtol=1e-5)
    want = tpeft.flatten_paths(jg)
    got = tpeft.flatten_paths(grads)
    assert want.keys() == got.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w,
                                   atol=1e-3 * np.abs(w).max() + 1e-12)
