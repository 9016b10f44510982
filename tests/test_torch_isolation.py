"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX, nor ``ml_dtypes``, nor anything of the JAX package ``repro``."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

# `import jax`, `from jax...`, `import ml_dtypes`, `import repro` /
# `from repro.` / `from repro ` — but not the port's own `repro_torch` prefix
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+ml_dtypes\b"
    r"|from\s+ml_dtypes\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro\b(?!_torch))", re.MULTILINE)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.serve.engine, repro_torch.convert, "
            "repro_torch.kernels.build, repro_torch.kernels.dispatch, "
            "repro_torch.train.loop, repro_torch.launch.train, "
            "repro_torch.optim, repro_torch.data, repro_torch.runtime, "
            "repro_torch.quant, repro_torch.serve.kv, "
            "repro_torch.launch.serve, repro_torch.kernels.q_matmul, "
            "repro_torch.kernels.paged_attention, repro_torch.models.ssm, "
            "repro_torch.kernels.ssd, repro_torch.kernels.flash_attention, "
            "repro_torch.core, repro_torch.core.projection, "
            "repro_torch.checkpoint, repro_torch.store, repro_torch.obs, "
            "repro_torch.obs.trace, repro_torch.obs.slo, "
            "repro_torch.core.conv, repro_torch.models.lipconvnet, "
            "repro_torch.models.image, repro_torch.serve.image, "
            "repro_torch.data.synthetic, repro_torch.configs.lipconvnet_15, "
            "repro_torch.sharding.pipeline, repro_torch.optim.compression, "
            "repro_torch.distrib.tp, repro_torch.sharding.specs, "
            "repro_torch.models.encdec, repro_torch.models.encoder, "
            "repro_torch.models.api, repro_torch.configs.seamless_m4t_medium, "
            "repro_torch.configs.pixtral_12b; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'ml_dtypes' or m.startswith('ml_dtypes.')"
            " or m == 'repro' or m.startswith('repro.')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


def test_sources_import_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_forbidden_pattern_catches_what_it_should():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from repro.core import gs")
    assert FORBIDDEN.search("    import repro")
    assert FORBIDDEN.search("import ml_dtypes")
    assert FORBIDDEN.search("from ml_dtypes import bfloat16")
    assert not FORBIDDEN.search("from repro_torch.core import gs")
    assert not FORBIDDEN.search("import repro_torch")


def test_training_entry_points_raise_without_a_card(monkeypatch):
    """train() and the launcher default to the card: without one they raise
    instead of training on the CPU."""
    import torch
    from repro_torch import optim
    from repro_torch.config import get_smoke_config
    from repro_torch.core import peft
    from repro_torch.data import DataConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.train import loop, steps
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = steps.TrainStepConfig(peft=peft.PEFTConfig(block_size=8),
                                 opt=optim.OptimizerConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.train(get_smoke_config("qwen2-72b"), tcfg,
                   DataConfig(seq_len=8, global_batch=2),
                   loop.LoopConfig(steps=1), log_fn=lambda s: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "qwen2-72b", "--smoke", "--steps", "1"])


def test_serving_entry_points_raise_without_a_card(monkeypatch):
    """The serve launcher and the runtime default to the card too."""
    import torch
    from repro_torch.config import get_smoke_config
    from repro_torch.core.runtime import ModelRuntime
    from repro_torch.launch import serve as launch_serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--arch", "qwen2-72b", "--smoke", "--engine",
                           "paged", "--quantize", "int8"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRuntime(get_smoke_config("qwen2-72b"))


def test_image_and_static_entry_points_raise_without_a_card(monkeypatch):
    """The image lane and the static engine default to the card as well:
    the image family's runtime, its launcher lane, the static launcher
    lane, the GS-SOC initialiser and the synthetic batches raise without
    one."""
    import torch
    from repro_torch.config import get_smoke_config
    from repro_torch.core.conv import GSSOCSpec, init_gs_soc
    from repro_torch.core.runtime import ModelRuntime
    from repro_torch.data import image_batch, lm_batch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import image
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("lipconvnet-15")
    for call in (lambda: ModelRuntime(cfg),
                 lambda: image.init_image(cfg),
                 lambda: init_gs_soc(GSSOCSpec(channels=8),
                                     torch.Generator()),
                 lambda: image_batch(cfg, 2),
                 lambda: lm_batch(get_smoke_config("qwen2-72b"), 2, 8),
                 lambda: launch_serve.main(["--arch", "lipconvnet-15",
                                            "--smoke", "--family", "image"]),
                 lambda: launch_serve.main(["--arch", "qwen2-72b", "--smoke",
                                            "--engine", "static",
                                            "--peft-demo"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_scale_out_modules_load_no_jax():
    """The cluster, the serve mesh, the partition rules and the mesh
    factories import neither JAX nor the JAX package."""
    code = ("import sys, repro_torch.distrib, repro_torch.distrib.cluster, "
            "repro_torch.distrib.tp, repro_torch.sharding, "
            "repro_torch.sharding.specs, repro_torch.launch.mesh; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


def test_serve_mesh_and_meshed_runtime_raise_without_a_card(monkeypatch):
    """``serve_mesh`` and ``ModelRuntime(mesh=)`` default to the card: they
    raise without one before any process group starts, unless the CPU is
    asked for."""
    import torch
    import torch.distributed as dist
    from repro_torch.config import get_smoke_config
    from repro_torch.core.runtime import ModelRuntime
    from repro_torch.distrib.tp import serve_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_mesh(1)
    mesh = serve_mesh(1, device="cpu")
    assert dist.get_backend() == "gloo"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRuntime(get_smoke_config("qwen2-72b"), mesh=mesh)
    rt = ModelRuntime(get_smoke_config("qwen2-72b"), mesh=mesh, device="cpu")
    assert rt.shard is None and rt.mesh is mesh


SLICE16_ARCHS = ("gemma-7b", "granite-34b", "mistral-large-123b",
                 "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b",
                 "seamless-m4t-medium", "pixtral-12b")


@pytest.mark.parametrize("arch", SLICE16_ARCHS)
def test_decoder_and_moe_entry_points_raise_without_a_card(monkeypatch,
                                                           arch):
    """The dense decoders and the MoE configs default to the card too: the
    training and serving launchers and the runtime raise without one."""
    import torch
    from repro_torch.config import get_smoke_config
    from repro_torch.core.runtime import ModelRuntime
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: launch_train.main(["--arch", arch, "--smoke",
                                            "--steps", "1"]),
                 lambda: launch_serve.main(["--arch", arch, "--smoke"]),
                 lambda: ModelRuntime(get_smoke_config(arch))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("arch", ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"))
def test_moe_on_a_mesh_raises_not_implemented(arch):
    """An MoE config under ``--tp 2``, ``--mesh`` or a split mesh gets its
    experts split (expert parallelism): the launcher's MoE refusal is
    gone (in one process it stops at the world size, naming both sizes),
    ``model_shard`` builds a ``TPShard`` holding rank 0's experts (half of
    E, or every expert on half its d_ff where E does not divide) and
    ``build_train_step`` a step over it, PEFT and full fine-tuning; a
    data-only mesh splits nothing. A bank on the experts stays refused."""
    import torch
    from repro_torch import optim
    from repro_torch.config import get_smoke_config
    from repro_torch.core import peft
    from repro_torch.distrib import tp as tp_lib
    from repro_torch.launch import serve as launch_serve
    from repro_torch.sharding.specs import ShardingRules
    from repro_torch.train import steps
    for flags, n in ((["--tp", "2"], 2), (["--mesh", "2,1"], 2),
                     (["--mesh", "1,4"], 4)):
        with pytest.raises(ValueError, match=f"needs {n} ranks"):
            launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu"]
                              + flags)
    cfg = get_smoke_config(arch)
    E, fe = cfg.moe_experts, cfg.expert_d_ff
    for method in ("gsoft", "full"):
        tcfg = steps.TrainStepConfig(peft=peft.PEFTConfig(method=method,
                                                          block_size=8),
                                     opt=optim.OptimizerConfig())
        for mesh in ({"data": 1, "model": 2}, {"data": 2, "model": 1}):
            shard = tp_lib.model_shard(cfg, mesh)
            step = steps.build_train_step(cfg, tcfg, mesh=mesh)
            if mesh["model"] == 1:
                assert shard is None and step.split.shard is None
                continue
            for s in (shard, step.split.shard):
                assert s.experts_split and s.experts == (0, E // 2)
            assert ShardingRules(cfg, mesh).param_spec(
                "layers/moe/wi", (1, E, 1, fe)) == (None, "model", None, None)
    odd = cfg.with_overrides(moe_experts=E - 1)     # E does not divide 2
    shard = tp_lib.model_shard(odd, {"data": 1, "model": 2})
    assert shard.expert_ff_split and shard.experts == (0, E - 1)
    with pytest.raises(ValueError, match="MoE experts"):
        peft.bank_specs(peft.PEFTConfig(method="gsoft", block_size=8),
                        {"layers": {"moe": {"wi": torch.zeros(2, E, 64,
                                                               32)}}})


def test_encoder_classifier_and_frontends_raise_without_a_card(monkeypatch):
    """The encoder classifier's initialiser, the encdec / vlm initialisers
    and their synthetic batches default to the card as well."""
    import torch
    from repro_torch.config import get_smoke_config
    from repro_torch.data import lm_batch
    from repro_torch.models import encdec, encoder, transformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = encoder.encoder_config()
    for call in (lambda: encoder.init_encoder_classifier(cfg, 2),
                 lambda: encdec.init_encdec(
                     get_smoke_config("seamless-m4t-medium")),
                 lambda: transformer.init_lm(get_smoke_config("pixtral-12b")),
                 lambda: lm_batch(get_smoke_config("pixtral-12b"), 2, 16),
                 lambda: lm_batch(get_smoke_config("seamless-m4t-medium"), 2,
                                  16)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
