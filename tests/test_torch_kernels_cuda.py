"""The port's CUDA kernels against their plain versions, on the card.

Imports neither JAX nor the JAX package, so it runs on a machine with an
NVIDIA GPU and only PyTorch: ``python -m pytest -q tests/test_torch_kernels_cuda.py``.
The ``cuda``-marked tests skip without a card; the wrapper's argument
checks run everywhere."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import gs_fused as gk  # noqa: E402

# f32: fp32 sums in another order than the plain version's matmuls
F32_TOL = 1e-4
# bf16: the kernel keeps the intermediate in fp32 where the plain version
# rounds it to bf16 (2^-9 relative); both round y, |y| < 8 here (ulp 2^-5)
BF16_TOL = 2.0 ** -4


def _factors(rng, bsz, r, b):
    a = rng.normal(0, 0.3, size=(bsz, r, b, b))
    k = a - np.swapaxes(a, -1, -2)
    eye = np.eye(b)
    q = np.swapaxes(np.linalg.solve(eye + k, eye - k), -1, -2)
    return torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


# (B, T, r, b): decode rows (cluster-split), short prefill buckets at
# d = 8192 (cluster-split with 4 tokens per tile), prefill tiles, ragged T,
# r not a power of two, r < b, r > b, tiny d, and the qwen2-72b MLP width
CASES = [(4, 1, 256, 32), (1, 16, 256, 32), (1, 64, 256, 32),
         (1, 130, 256, 32), (2, 7, 6, 4), (3, 5, 3, 16), (1, 33, 24, 8),
         (2, 1, 231, 128), (1, 140, 924, 32), (1, 9, 2, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=lambda c: "B%d-T%d-r%d-b%d" % c)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["gs_fused_T", "gs_fused"])
def test_kernel_matches_plain(cuda, case, dtype, name):
    bsz, t, r, b = case
    rng = np.random.default_rng(bsz * 1000 + t * 10 + r + b)
    x = torch.from_numpy(rng.normal(size=(bsz, t, r * b)).astype(np.float32))
    L, R = _factors(rng, bsz, r, b), _factors(rng, bsz, r, b)
    args = [a.to(cuda, dtype) for a in (x, L, R)]
    fn, plain = ((gk.gs_fused_T, gk.gs_fused_T_plain) if name == "gs_fused_T"
                 else (gk.gs_fused, gk.gs_fused_plain))
    before = fn.launches
    y = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert torch.isfinite(y.float()).all()
    assert (y.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_short_prefill_runs_the_split_multi_token_variant(cuda):
    assert gk.launch_geometry("gs_fused_T", 1, 16, 8192) == (4, 8)
    assert gk.launch_geometry("gs_fused_T", 1, 128, 8192) == (4, 1)
    assert gk.launch_geometry("gs_fused_T", 1, 16, 29568) == (1, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gs_fused_T", "gs_fused"])
def test_empty_input_launches_nothing(cuda, name):
    fn = getattr(gk, name)
    L = torch.zeros((1, 8, 8, 8), device=cuda)
    before = fn.launches
    assert fn(torch.zeros((1, 0, 64), device=cuda), L, L).shape == (1, 0, 64)
    assert fn.launches == before


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((1, 2, 64), device=cuda, dtype=torch.float16)
    L = torch.zeros((1, 8, 8, 8), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or f32"):
        gk.gs_fused_T(x, L, L)
    x = torch.zeros((1, 64, 2), device=cuda).transpose(1, 2)
    L = torch.zeros((1, 8, 8, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gk.gs_fused_T(x, L, L)


def test_wrapper_checks_shapes_and_types_on_any_device():
    x = torch.zeros((2, 3, 64))
    L = torch.zeros((2, 8, 8, 8))
    with pytest.raises(ValueError, match="d = r \\* b"):
        gk.gs_fused_T(torch.zeros((2, 3, 60)), L, L)
    with pytest.raises(ValueError, match="expected x"):
        gk.gs_fused(torch.zeros((3, 64)), L, L)
    with pytest.raises(TypeError, match="one dtype"):
        gk.gs_fused_T(x, L.double(), L)
    with pytest.raises(ValueError, match="shape mismatch"):
        gk.gs_fused(torch.zeros((1, 3, 64)), L, L)


def test_cpu_tensors_take_the_plain_version_without_counting():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 3, 32)).astype(np.float32))
    L, R = _factors(rng, 2, 4, 8), _factors(rng, 2, 4, 8)
    before = (gk.gs_fused_T.launches, gk.gs_fused.launches)
    assert torch.equal(gk.gs_fused_T(x, L, R), gk.gs_fused_T_plain(x, L, R))
    assert torch.equal(gk.gs_fused(x, L, R), gk.gs_fused_plain(x, L, R))
    assert (gk.gs_fused_T.launches, gk.gs_fused.launches) == before
