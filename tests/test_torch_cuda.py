"""The port's kernel and main path on the card.

Marked ``cuda``: each test needs an NVIDIA card and skips without one
(decided inside the test, never at import).  Run them on the machine
with the card:
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import BlasxContext
from repro_torch.core.runtime import RuntimeConfig
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels.ref import batched_contract_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


TOL = {torch.float64: 1e-12, torch.float32: 1e-4, torch.bfloat16: 2e-2,
       torch.float16: 2e-2}


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("shape", [(2, 3, 65, 33, 129), (1, 1, 1, 7, 5),
                                   (3, 2, 200, 97, 130)])
def test_kernel_matches_plain_version(card, dtype, shape):
    g, s, m, k, n = shape
    gen = torch.Generator(device=card).manual_seed(0)
    a = torch.randn((g, s, m, k), generator=gen, device=card).to(dtype)
    b = torch.randn((g, s, k, n), generator=gen, device=card).to(dtype)
    before = kmm.LAUNCHES
    got = kmm.batched_contract(a, b)
    torch.cuda.synchronize()
    assert kmm.LAUNCHES == before + 1
    want = batched_contract_ref(a, b)
    err = torch.linalg.norm((got - want).double()) / torch.linalg.norm(
        want.double())
    assert float(err) <= TOL[dtype]


def test_context_gemm_launches_match_ledger(card):
    rng = np.random.default_rng(1)
    A = rng.standard_normal((300, 200))
    B = rng.standard_normal((200, 250))
    with BlasxContext(RuntimeConfig(n_devices=2), tile=64) as ctx:
        before = kmm.LAUNCHES
        out = ctx.gemm(A, B)
        ls = ctx.stats()["launch"]
        assert kmm.LAUNCHES - before == ls["kernel_launches"]
        assert set(ls["engine_flops"]) <= {"cuda", "torch"}
        np.testing.assert_allclose(out.array(), A @ B, rtol=1e-12,
                                   atol=1e-12)
