"""JAX-side helpers of tests/test_torch_tp.py and test_torch_tp4.py: the
single-device reference tokens and the numpy payloads the gloo ranks of
``torch_tp_runner`` serve from (that module stays JAX-free: the ranks
import it)."""
import numpy as np
import torch

import jax

from repro import quant as jquant
from repro.config import get_smoke_config as jax_smoke_config
from repro.core import peft as jpeft
from repro.core.runtime import ModelRuntime as JaxRuntime
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.config import get_smoke_config
from repro_torch.core import peft as tpeft
from repro_torch.launch.serve import make_demo_adapters

import torch_tp_runner as runner

CFG = get_smoke_config("qwen2-72b")
JCFG = jax_smoke_config("qwen2-72b")
MIXED = {"m0": "gsoft", "m1": "boft", "m2": "oft", "m3": "householder",
         "m4": "givens", "m5": "gsoft"}
GB = {"g0": "gsoft", "g1": "boft", "g2": "gsoft"}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jq_numpy(tree):
    """A quantized JAX tree with each QuantTensor as {"q", "scale",
    "dtype"} numpy (what ``convert.quant_params_from_numpy`` takes)."""
    return jax.tree_util.tree_map(
        lambda l: ({"q": np.asarray(l.q), "scale": np.asarray(l.scale),
                    "dtype": l.meta.dtype} if jquant.is_quant_tensor(l)
                   else np.asarray(l)),
        tree, is_leaf=jquant.is_quant_tensor)


def adapters(params_np, methods):
    """Random (non-identity) tenants of ``methods``, drawn by the port on
    the CPU (seeded) and handed to both packages as numpy."""
    tparams = convert.params_from_numpy(params_np, "cpu")
    cfgs = {n: tpeft.PEFTConfig(method=m, block_size=8)
            for n, m in methods.items()}
    ads = make_demo_adapters(list(methods), tparams, cfgs,
                             torch.device("cpu"), scale=0.3)
    return {n: {p: {k: v.numpy() for k, v in e.items()}
                for p, e in t.items()} for n, t in ads.items()}


def jcfgs(methods):
    return {n: jpeft.PEFTConfig(method=m, block_size=8)
            for n, m in methods.items()}


def jax_tokens(rt, methods, n, seed):
    """JAX's one-device ``ServeEngine`` over ``runner._requests``."""
    reqs = runner._requests(list(methods), n, seed)
    return runner._serve(JaxEngine(rt, max_batch=3, max_len=runner.MAX_LEN,
                                   eos_id=-1), reqs)


def jax_runtime():
    return JaxRuntime(JCFG, key=jax.random.PRNGKey(0))
