"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerance: rtol 1e-5 / atol 1e-5 (the kernels sum over d in another order).
"""

import pytest
import torch

from repro_torch.kernels import coverage_accept as tca
from repro_torch.kernels import coverage_marginals as tcm
from repro_torch.kernels import ref

RTOL = ATOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_lane", [False, True])
def test_cuda_coverage_marginals_matches_plain(cuda_device, dtype, per_lane):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    L, C, d = 11, 1000, 300
    shape = (L, C, d) if per_lane else (C, d)
    x = (torch.rand(shape, generator=g, device=cuda_device) ** 2).to(dtype)
    state = torch.rand((L, d), generator=g, device=cuda_device) * 3
    w = torch.rand(d, generator=g, device=cuda_device)
    before = tcm.launches
    got = tcm.coverage_marginals(x, state, w)
    torch.cuda.synchronize()
    assert tcm.launches == before + 1
    torch.testing.assert_close(got, ref.coverage_marginals(x, state, w),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_coverage_accept_matches_plain(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    L, B, d = 7, 128, 256
    x = (torch.rand((L, B, d), generator=g, device=cuda_device) ** 2).to(dtype)
    state = torch.rand((L, d), generator=g, device=cuda_device) * 3
    elig = torch.rand((L, B), generator=g, device=cuda_device) < 0.9
    tau = ref.coverage_marginals(x, state).median(dim=1).values.contiguous()
    bud = torch.randint(0, B, (L,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    got = tca.coverage_accept(x, state, None, elig, tau, bud)
    torch.cuda.synchronize()
    want = ref.coverage_accept(x, state, None, elig, tau, bud)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got[2], want[2], rtol=RTOL, atol=ATOL)
