"""Tensor-parallel serving of the Mamba2 families on the CPU at tp = 2:
two gloo ranks (``tests/torch_tp_runner.py``) serve mamba2-130m (``ssm``)
and zamba2-2.7b (``hybrid``: Mamba2 super-blocks and the shared attention
block) at their smoke configs, each rank holding its share of the SSD
heads (wz / wx / wdt columns, out_proj rows, the state's heads) and, for
zamba2, of the shared block's attention and MLP. Both ranks' greedy tokens
equal JAX's single-device engine's on the same params, exactly (f32 on
both sides); the JAX package's ``ssm`` / ``hybrid`` prefill leaves the
decode state as it was (ROADMAP Queue 3, caveats), and the port mirrors it
split or whole.
"""
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402

from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.runtime import ModelRuntime as JaxRuntime  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402

import torch_tp_refs as R  # noqa: E402
import torch_tp_runner as runner  # noqa: E402

ARCHS = ("mamba2-130m", "zamba2-2.7b")


@pytest.fixture(scope="module")
def tp2():
    """(JAX's tokens by arch, the two ranks' results)."""
    want, payload = {}, {}
    for arch in ARCHS:
        jrt = JaxRuntime(jax_smoke_config(arch), key=jax.random.PRNGKey(0))
        want[arch] = R.jax_tokens(jrt, {}, 6, 2)
        payload[arch] = dict(arch=arch, params=R.np_tree(jrt.params),
                             methods={}, n=6, seed=2)
    return want, runner.spawn(2, payload)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_mamba_families_equal_jax_single_device(tp2, arch):
    """Both ranks serve JAX's tokens; each holds half the SSD heads (and,
    for zamba2, half the shared attention's q heads)."""
    want, ranks = tp2
    assert [r[arch]["tokens"] for r in ranks] == [want[arch]] * 2
    cfg = get_smoke_config(arch)
    for r in ranks:
        loc = r[arch]["local"]
        assert loc["wz"][-1] == cfg.d_inner // 2
        assert loc["wo"][-2] == cfg.d_inner // 2
        assert loc["ssm"][-3] == cfg.ssm_heads // 2
        assert loc["conv"][-1] == (cfg.d_inner // 2
                                   + 2 * cfg.ssm_groups * cfg.ssm_state)
        if arch == "zamba2-2.7b":
            assert loc["shared_wq"][-1] == cfg.num_heads * cfg.d_head // 2
