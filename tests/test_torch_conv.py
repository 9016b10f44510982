"""The port's GS orthogonal convolutions (``core/conv.py``) and LipConvnet
(``models/lipconvnet.py``) against the JAX package on the CPU, in f32: the
same numpy inputs and kernels go through both and agree to ``TOL``
(absolute, on O(1) values: the two convolutions sum in another order);
permutations, activations and layout moves agree exactly. The isometries
(``conv_exponential`` of a skew kernel, ``gs_soc_layer``, ``space_to_depth``)
and the 1-Lipschitz net are checked in the port itself, as
tests/test_conv.py checks them in JAX."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import conv as jconv  # noqa: E402
from repro.models import lipconvnet as jlip  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import conv as tconv  # noqa: E402
from repro_torch.core.peft import flatten_paths  # noqa: E402
from repro_torch.models import lipconvnet as tlip  # noqa: E402

TOL = 1e-5                  # f32, absolute, O(1) values
LOSS_GRAD_TOL = 1e-4        # f32 gradients of the whole net (summed orders)


def _rng(seed):
    return np.random.default_rng(seed)


def _np(shape, seed, scale=1.0):
    return (scale * _rng(seed).normal(size=shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


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


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_skew_kernel_and_conv2d_match_jax(groups):
    ch = 8
    m = _np((3, 3, ch // groups, ch), 0, 0.3)
    k_t, k_j = tconv.skew_kernel(_t(m), groups), jconv.skew_kernel(
        jnp.asarray(m), groups)
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    x = _np((2, 6, 6, ch), 1)
    y = tconv.conv2d(_t(x), k_t, groups)
    _close(y, jconv.conv2d(jnp.asarray(x), k_j, groups))
    # skew: <L*X, Y> = -<X, L*Y>
    z = _t(_np((2, 6, 6, ch), 2))
    assert torch.allclose((y * z).sum(),
                          -(_t(x) * tconv.conv2d(z, k_t, groups)).sum(),
                          atol=1e-3)
    with pytest.raises(ValueError, match="bad grouped kernel"):
        tconv.skew_kernel(_t(m)[:, :, :, :ch - 1], groups)


def test_conv2d_one_by_one_and_strided_layout():
    """A 1x1 kernel (the GS-SOC layer's second conv) and a non-contiguous
    NHWC input (a channel slice) agree with JAX too."""
    x = _np((2, 5, 5, 16), 3)
    k = _np((1, 1, 8, 8), 4, 0.3)
    xs = _t(x)[..., :8]
    _close(tconv.conv2d(xs, _t(k)), jconv.conv2d(jnp.asarray(x[..., :8]),
                                                 jnp.asarray(k)))


@pytest.mark.parametrize("groups,terms", [(1, 6), (2, 4), (4, 14)])
def test_conv_exponential_matches_jax_and_is_an_isometry(groups, terms):
    ch = 8
    m = _np((3, 3, ch // groups, ch), 5, 0.05)
    x = _np((1, 5, 5, ch), 6)
    k_t = tconv.skew_kernel(_t(m), groups)
    y = tconv.conv_exponential(_t(x), k_t, groups, terms)
    _close(y, jconv.conv_exponential(
        jnp.asarray(x), jconv.skew_kernel(jnp.asarray(m), groups), groups,
        terms))
    if terms >= 14:      # truncation error below f32 rounding
        assert torch.isclose(torch.linalg.norm(y), torch.linalg.norm(_t(x)),
                             rtol=1e-4)


def test_grouped_conv_exponential_keeps_groups_apart():
    ch, g = 8, 2
    k = tconv.skew_kernel(_t(_np((3, 3, ch // g, ch), 7, 0.3)), g)
    x = _t(_np((1, 5, 5, ch), 8))
    x2 = x.clone()
    x2[..., : ch // g] += 1.0                 # perturb only group 0
    y, y2 = (tconv.conv_exponential(v, k, g, 6) for v in (x, x2))
    assert torch.allclose(y[..., ch // g:], y2[..., ch // g:], atol=1e-5)
    assert not torch.allclose(y[..., : ch // g], y2[..., : ch // g],
                              atol=1e-3)


def test_activations_match_jax():
    x = _np((16, 12), 9)
    for name in ("maxmin", "maxmin_permuted", "none"):
        np.testing.assert_array_equal(
            tconv.ACTIVATIONS[name](_t(x)).numpy(),
            np.asarray(jconv.ACTIVATIONS[name](jnp.asarray(x))))
    got = tconv.maxmin_permuted(torch.tensor([[3.0, 1.0, -2.0, 5.0]]))
    assert got.tolist() == [[3.0, 1.0, 5.0, -2.0]]
    # 1-Lipschitz and norm-preserving on directions (a.e.)
    y = _t(x) + 0.1 * _t(_np((16, 12), 10))
    for fn in (tconv.maxmin, tconv.maxmin_permuted):
        assert torch.all(torch.linalg.norm(fn(_t(x)) - fn(y), dim=-1)
                         <= torch.linalg.norm(_t(x) - y, dim=-1) + 1e-5)


@pytest.mark.parametrize("channels,k,paired", [(16, 4, True), (16, 4, False),
                                               (8, 8, True), (12, 2, True)])
def test_ch_shuffle_matches_jax(channels, k, paired):
    ts = tconv.ch_shuffle_spec(channels, k, paired)
    js = jconv.ch_shuffle_spec(channels, k, paired)
    assert (ts.kind, ts.k) == (js.kind, js.k)
    x = _np((2, 3, 3, channels), 11)
    np.testing.assert_array_equal(tconv.ch_shuffle(_t(x), ts).numpy(),
                                  np.asarray(jconv.ch_shuffle(
                                      jnp.asarray(x), js)))


@pytest.mark.parametrize("groups", [(4, 0), (4, 1), (4, 2), (4, 4), (1, 0)])
def test_gs_soc_layer_matches_jax_and_is_an_isometry(groups):
    spec_kw = dict(channels=8, groups1=groups[0], groups2=groups[1], terms=12)
    ts, js = tconv.GSSOCSpec(**spec_kw), jconv.GSSOCSpec(**spec_kw)
    assert ts.param_shapes() == js.param_shapes()
    assert ts.num_params == js.num_params
    jp = jconv.init_gs_soc(js, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x, y = _np((1, 6, 6, 8), 12), _np((1, 6, 6, 8), 13)
    fx = tconv.gs_soc_layer(ts, tp, _t(x))
    _close(fx, jconv.gs_soc_layer(js, jp, jnp.asarray(x)))
    fy = tconv.gs_soc_layer(ts, tp, _t(y))
    assert torch.isclose(torch.linalg.norm(fx - fy),
                         torch.linalg.norm(_t(x) - _t(y)), rtol=1e-3)


def test_init_gs_soc_shapes_and_scale():
    spec = tconv.GSSOCSpec(channels=64, groups1=4, groups2=1)
    gen = torch.Generator().manual_seed(0)
    p = tconv.init_gs_soc(spec, gen, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == spec.param_shapes()
    assert abs(float(p["m1"].std()) - 1 / np.sqrt(9 * 16)) < 0.01
    soc = tconv.soc_layer_spec(64)
    assert soc == tconv.GSSOCSpec(channels=64, groups1=1, groups2=0,
                                  paired=False)
    assert soc.num_params == jconv.soc_layer_spec(64).num_params == 9 * 64 * 64


def test_space_to_depth_power_iteration_certified_radius_match_jax():
    x = _np((2, 8, 8, 3), 14)
    s = tconv.space_to_depth(_t(x), 2)
    np.testing.assert_array_equal(s.numpy(),
                                  np.asarray(jconv.space_to_depth(
                                      jnp.asarray(x), 2)))
    assert s.shape == (2, 4, 4, 12)
    assert torch.isclose(torch.linalg.norm(s), torch.linalg.norm(_t(x)))
    w = _np((24, 10), 15)
    _close(tconv.power_iteration_sn(_t(w)),
           jconv.power_iteration_sn(jnp.asarray(w)), 1e-4)
    assert abs(float(tconv.power_iteration_sn(_t(w)))
               - float(np.linalg.norm(w, 2))) < 1e-2
    logits = _np((5, 10), 16)
    _close(tconv.certified_radius(_t(logits)),
           jconv.certified_radius(jnp.asarray(logits)))
    assert np.isclose(float(tconv.certified_radius(
        torch.tensor([[2.0, 0.5, 0.1]]))[0]), 1.5 / np.sqrt(2))


def _tiny(mod, **kw):
    kw.setdefault("depth", 5)
    kw.setdefault("base_width", 4)
    kw.setdefault("num_classes", 10)
    kw.setdefault("image_size", 32)
    kw.setdefault("groups", (2, 0))
    kw.setdefault("terms", 4)
    return mod.LipConvnetConfig(**kw)


@pytest.fixture(scope="module")
def lipnet():
    jcfg, tcfg = _tiny(jlip, groups=(2, 1)), _tiny(tlip, groups=(2, 1))
    # jitted: JAX's eager op-by-op dispatch of the whole net is 5-10x slower
    jp = jax.jit(lambda k: jlip.init_lipconvnet(jcfg, k))(
        jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_lipconvnet_forward_matches_jax(lipnet):
    jcfg, tcfg, jp, tp = lipnet
    x = _np((2, 32, 32, 3), 17)
    got = tlip.apply_lipconvnet(tcfg, tp, _t(x))
    assert got.shape == (2, 10)
    _close(got, jax.jit(lambda p, v: jlip.apply_lipconvnet(jcfg, p, v))(
        jp, jnp.asarray(x)), 1e-4)
    # the port's own init has the JAX tree's structure and shapes
    own = tlip.init_lipconvnet(tcfg, 0, "cpu")
    assert (jax.tree.map(lambda a: tuple(a.shape), own)
            == jax.tree.map(lambda a: tuple(a.shape), jp))
    assert tlip.head_features(tcfg) == jp["head"]["w"].shape[0]


def test_lipconvnet_loss_and_grads_match_jax(lipnet):
    jcfg, tcfg, jp, tp = lipnet
    x, y = _np((4, 32, 32, 3), 18), np.array([0, 1, 2, 3], np.int32)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlip.lipconvnet_loss(jcfg, p, jnp.asarray(x),
                                       jnp.asarray(y)), has_aux=True))(jp)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in flatten_paths(tp).items()}
    loss, m = tlip.lipconvnet_loss(tcfg, _nest(leaves), _t(x), _t(y).long())
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5
    assert float(m["accuracy"]) == float(jm["accuracy"])
    assert float(m["certified"]) == float(jm["certified"])
    jflat = flatten_paths(jax.tree.map(np.asarray, jg))
    for (path, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.numpy(), jflat[path],
                                   atol=LOSS_GRAD_TOL, rtol=0, err_msg=path)


def test_lipconvnet_is_lipschitz():
    cfg = _tiny(tlip, terms=10)
    params = tlip.init_lipconvnet(cfg, 0, "cpu")
    x = _t(_np((1, 32, 32, 3), 19))
    d = _t(_np((1, 32, 32, 3), 20))
    d = d / torch.linalg.norm(d) * 0.1
    l0 = tlip.apply_lipconvnet(cfg, params, x)
    l1 = tlip.apply_lipconvnet(cfg, params, x + d)
    assert float(torch.linalg.norm(l1 - l0)) <= 0.1 * 1.05


def test_conv_param_counts_match_jax():
    for kw in (dict(conv_layer="soc", depth=15),
               dict(conv_layer="gs", depth=15, groups=(4, 0)),
               dict(conv_layer="gs", depth=15, groups=(4, 1), base_width=32)):
        assert (tlip.count_conv_params(_tiny(tlip, **kw))
                == jlip.count_conv_params(_tiny(jlip, **kw)))
    with pytest.raises(ValueError, match="divisible by 5"):
        tlip.LipConvnetConfig(depth=7)
