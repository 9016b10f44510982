"""The image family's training objective (``models/image.py``
``image_loss``) and its gradients against ``jax.grad`` on the CPU, at the
``lipconvnet-15`` smoke config in f32: the port's params are carried to
JAX as numpy and the same images and labels go through both.

JAX's gradient is taken eagerly (op by op): a jitted ``jax.grad`` of this
net on the CPU is off by up to 7e-4 (on gradients up to 0.09) against a
float64 evaluation of the same function in the blocks with 8x8 or more
pixels, while the eager one and the port's agree with it to 3e-7. So the
gradients are held to ``GRAD_TOL`` (absolute), the loss to ``LOSS_TOL``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import image as jimage  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.core.peft import flatten_paths  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import image as timage  # noqa: E402

JCFG = jax_smoke_config("lipconvnet-15")
CFG = get_smoke_config("lipconvnet-15")
GRAD_TOL = 1e-5
LOSS_TOL = 1e-5


def _nest(flat):
    """{"a/b": leaf} -> {"a": {"b": leaf}}."""
    out = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def test_image_loss_and_grads_match_jax_grad():
    params = timage.init_image(CFG, 0, "cpu")
    x = np.random.default_rng(7).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    y = np.array([0, 3, 5, 9], np.int32)
    batch = {"images": jnp.asarray(x), "labels": jnp.asarray(y)}
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jimage.image_loss(JCFG, p, batch), has_aux=True)(
            jax.tree.map(jnp.asarray, convert.to_numpy(params)))
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in flatten_paths(params).items()}
    loss, m = api.loss_fn(CFG, _nest(leaves),
                          {"images": torch.from_numpy(x),
                           "labels": torch.from_numpy(y)})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert abs(float(loss.detach()) - float(jloss)) < LOSS_TOL
    for k in ("loss", "accuracy", "certified"):
        assert abs(float(m[k].detach()) - float(jm[k])) < LOSS_TOL, k
    jflat = flatten_paths(jax.tree.map(np.asarray, jg))
    assert set(jflat) == set(leaves)
    for path, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), jflat[path], atol=GRAD_TOL,
                                   rtol=0, err_msg=path)
    # FamilyOps.forward through the registry: (logits, aux = 0)
    logits, aux = api.forward(CFG, params, {"images": torch.from_numpy(x)})
    assert logits.shape == (4, CFG.num_classes) and float(aux) == 0.0
