"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and
skips without one. The file imports no jax, so it also runs on a machine
with the card and no JAX; there, skip tests/conftest.py (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerance rtol 2e-4 / atol 2e-5, as tests/test_pallas_kernels.py holds the
TPU kernel to its oracle: the kernel sums H*W cells and C products in
another order than ATen, and the pow/log/exp chain of GeM amplifies
last-bit differences by about p.
"""

import numpy as np
import pytest
import torch

from dirjax_torch.ops import gem_head

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _head_inputs(rng, device, B, H, W, C, D):
    """x, W as the (C, D) view of an nn.Linear (D, C) weight, b, mask."""
    x = torch.from_numpy((rng.random((B, H, W, C)) + 0.05).astype(np.float32))
    weight = torch.from_numpy((rng.normal(size=(D, C)) * 0.02).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(D,)) * 0.01).astype(np.float32))
    mask = torch.zeros((B, H, W), dtype=torch.bool)
    mask[0, :max(1, H - 3), :max(1, W - 2)] = True
    mask[1:] = True
    return x.to(device), weight.to(device).T, b.to(device), mask.to(device)


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
class TestGemHeadKernel:
    """K1 (csrc/gem_head.cu) against gem_head_reference."""

    @pytest.mark.parametrize("shape", [(2, 9, 5, 128, 256), (3, 4, 7, 300, 200),
                                       (9, 32, 24, 2048, 2048)])
    @pytest.mark.parametrize("masked", [False, True])
    def test_matches_reference(self, rng, cuda, shape, masked):
        x, w, b, mask = _head_inputs(rng, cuda, *shape)
        m = mask if masked else None
        p = torch.tensor([2.5], device=cuda)
        before = gem_head.launches
        got = gem_head.fused_gem_head(x, p, w, b, mask=m)
        assert gem_head.launches == before + 1
        _close(got, gem_head.gem_head_reference(x, m, p, w, b))

    def test_bf16_input(self, rng, cuda):
        x, w, b, mask = _head_inputs(rng, cuda, 4, 8, 6, 256, 384)
        xb = x.to(torch.bfloat16)
        got = gem_head.fused_gem_head(xb, 3.0, w, b, mask=mask)
        _close(got, gem_head.gem_head_reference(xb.float(), mask, 3.0, w, b))

    def test_rejects_bad_layout(self, rng, cuda):
        x, w, b, _ = _head_inputs(rng, cuda, 2, 4, 4, 64, 64)
        with pytest.raises(ValueError, match="contiguous"):
            gem_head.fused_gem_head(x.permute(0, 3, 1, 2), 3.0, w, b)
        with pytest.raises(ValueError, match="fp32"):
            gem_head.fused_gem_head(x, 3.0, w.double(), b)
        with pytest.raises(ValueError, match="linear.weight.T"):
            gem_head.fused_gem_head(x, 3.0, w.contiguous(), b)
