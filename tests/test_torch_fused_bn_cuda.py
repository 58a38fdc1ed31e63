"""The fused-BN Triton kernels against their plain PyTorch versions on a
CUDA device. Marked ``cuda``: each test skips without a card. This file
imports neither jax nor the JAX package, so it also runs on a card host
that has only PyTorch (``python -m pytest --noconftest -m cuda
tests/test_torch_fused_bn_cuda.py``)."""

import pytest
import torch

from tensorflowonspark_tpu_torch.ops import fused_bn


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and triton): run on the card")


def _close(got, want):
    """float32 sums added in another order: 1e-4 relative to the largest
    value (floor 1)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4 * max(1.0, float(r.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_ch", [(175, 32), (3136, 256), (50176, 64)])
def test_kernels_match_plain_versions_on_card(rows, n_ch):
    """Each kernel in float32, at a ragged row count too."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(rows, n_ch, device="cuda", generator=gen) * 2 + 0.5
    dy = torch.randn(rows, n_ch, device="cuda", generator=gen)
    g = torch.randn(n_ch, device="cuda", generator=gen)
    b = torch.randn(n_ch, device="cuda", generator=gen)
    mean, var = fused_bn.bn_stats_plain(x)
    dgamma, dbeta = fused_bn.bn_bwd_reduce_plain(x, dy, mean, var, 1e-5)
    before = fused_bn.launch_counts()
    _close(fused_bn.bn_stats(x), (mean, var))
    _close(fused_bn.bn_normalize(x, mean, var, g, b, 1e-5),
           fused_bn.bn_normalize_plain(x, mean, var, g, b, 1e-5))
    _close(fused_bn.bn_bwd_reduce(x, dy, mean, var, 1e-5), (dgamma, dbeta))
    _close(fused_bn.bn_bwd_dx(x, dy, mean, var, g, dgamma, dbeta, 1e-5),
           fused_bn.bn_bwd_dx_plain(x, dy, mean, var, g, dgamma, dbeta, 1e-5))
    after = fused_bn.launch_counts()
    assert all(after[k] == before[k] + 1 for k in after)


@pytest.mark.cuda
def test_module_gradients_match_autograd_through_plain_math_on_card():
    """FusedBatchNorm (kernels, custom backward) vs BatchNorm (autograd
    through the plain versions) on a channels-last activation."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(8, 14, 14, 128, device="cuda", generator=gen) * 1.5 + 0.3
    w = torch.randn(x.shape, device="cuda", generator=gen)
    grads = []
    for cls in (fused_bn.FusedBatchNorm, fused_bn.BatchNorm):
        bn = cls(128).cuda().train()
        xi = x.clone().requires_grad_()
        (bn(xi) * w).sum().backward()
        grads.append((xi.grad, bn.weight.grad, bn.bias.grad, bn.running_var.clone()))
    for a, r in zip(*grads):
        _close(a, r)


@pytest.mark.cuda
def test_cuda_tensor_of_unsupported_layout_raises():
    """A CUDA tensor never reaches the plain version: bad input raises."""
    _card()
    x = torch.randn(64, 32, device="cuda").t()  # not row-major
    with pytest.raises(ValueError, match="contiguous"):
        fused_bn.bn_stats(x)
