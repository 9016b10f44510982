"""Tensor-parallel serving of the port on the CPU at tp = 4, where the
qwen2-72b smoke config's 2 kv heads are fewer than the ranks: K replicates
while the 4 q heads split, so each rank keeps only the kv head its q head
reads (q head h reads kv head h // (H / K)) — the mapping a wrong split
gets right at tp = 2 and wrong only here. Four gloo ranks
(``tests/torch_tp_runner.py``) serve a mixed-method eager bank through
the contiguous and the paged engine; every rank's greedy tokens equal
JAX's single-device engine's on the same params and adapters, exactly
(f32 on both sides). tests/test_torch_tp.py runs tp = 2.
"""
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import torch_tp_refs as R  # noqa: E402
import torch_tp_runner as runner  # noqa: E402

CFG = R.CFG


@pytest.fixture(scope="module")
def tp4():
    """(JAX's tokens, the four ranks' results). The paged engine serves
    the contiguous one's tenants and requests: paging moves where the KV
    lives, not what is computed, so both are held to the one JAX run."""
    jrt = R.jax_runtime()
    params = R.np_tree(jrt.params)
    mixed = R.adapters(params, R.MIXED)
    want = R.jax_tokens(jrt.attach(mixed, R.jcfgs(R.MIXED)), R.MIXED, 8, 1)
    case = dict(params=params, methods=R.MIXED, adapters=mixed, n=8, seed=1)
    return want, runner.spawn(4, {"bank": case,
                                  "paged": dict(case, paged=True)})


@pytest.mark.parametrize("case", ["bank", "paged"])
def test_tp4_with_fewer_kv_heads_than_ranks_equals_jax(tp4, case):
    """All four ranks serve JAX's tokens, contiguous and paged; wq holds
    H / 4 heads' columns, wk every kv head (replicated: K < tp), and the
    cache or page pool the one kv head the rank's q head reads."""
    want, ranks = tp4
    assert [r[case]["tokens"] for r in ranks] == [want] * 4
    H, K, hd = CFG.num_heads, CFG.num_kv_heads, CFG.d_head
    for r in ranks:
        local = r[case]["local"]
        assert local["wq"][-1] == H * hd // 4
        assert local["wk"][-1] == K * hd
        assert local["kv"][-2] == 1
