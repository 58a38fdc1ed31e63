"""The fused-BN kernels (the CUDA reductions and the Triton elementwise
passes) against their plain PyTorch versions on a CUDA device. Marked ``cuda``: each test skips without a card. This file
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


#: (rows, channels, dtype, base offset in elements): odd C and an offset
#: base take the reductions' scalar path; R = 1; the stem's shape
REDUCTION_CASES = [
    (1, 64, torch.float32, 0), (1, 3, torch.bfloat16, 0), (175, 3, torch.float32, 0),
    (3143, 37, torch.bfloat16, 0), (3143, 37, torch.float16, 0), (3136, 64, torch.float16, 0),
    (12544, 256, torch.float32, 1), (3136, 64, torch.bfloat16, 1), (3136, 2048, torch.bfloat16, 0),
    (802816, 64, torch.bfloat16, 0),
]


def _operand(rows, n_ch, dtype, offset, gen, scale=1.0, shift=0.0):
    """A contiguous [rows, n_ch] tensor whose base lies ``offset`` elements
    into its buffer (not 16-byte aligned for offset 1)."""
    buf = torch.randn(rows * n_ch + offset, device="cuda", generator=gen) * scale + shift
    return buf.to(dtype)[offset:].view(rows, n_ch)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_ch,dtype,offset", REDUCTION_CASES)
def test_reductions_match_plain_versions_and_repeat_bitwise(rows, n_ch, dtype, offset):
    """bn_stats and bn_bwd_reduce against their plain versions in each
    dtype, on both load paths, at R = 1 and at the stem's shape; a second
    call gives bitwise-equal outputs, and every strip's counter is back at
    0 after the launches."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = _operand(rows, n_ch, dtype, offset, gen, 2.0, 0.5)
    dy = _operand(rows, n_ch, dtype, offset, gen)
    vec = n_ch * x.element_size() % 16 == 0 and offset == 0
    assert fused_bn._vector_path(x, dy) == vec
    mean, var = fused_bn.bn_stats_plain(x)
    before = fused_bn.launch_counts()
    got = fused_bn.bn_stats(x)
    _close(got, (mean, var))
    red = fused_bn.bn_bwd_reduce(x, dy, mean, var, 1e-5)
    _close(red, fused_bn.bn_bwd_reduce_plain(x, dy, mean, var, 1e-5))
    for again, first in ((fused_bn.bn_stats(x), got), (fused_bn.bn_bwd_reduce(x, dy, mean, var, 1e-5), red)):
        assert all(torch.equal(a, b) for a, b in zip(again, first))
    after = fused_bn.launch_counts()
    assert after["bn_stats"] == before["bn_stats"] + 2
    assert after["bn_bwd_reduce"] == before["bn_bwd_reduce"] + 2
    torch.cuda.synchronize()
    assert not fused_bn._workspace(x, fused_bn._stream(x)).counters.any()


@pytest.mark.cuda
def test_one_workspace_serves_shapes_of_different_split_counts():
    """Layers of different strip and split counts, queued back to back on
    one stream through one workspace, each right: every launch's finishing
    CTA leaves its counters at 0 for the next."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = [(802816, 64), (3136, 2048), (175, 3), (50176, 512), (1, 64), (12544, 256), (3143, 37)]
    runs = []
    for rows, n_ch in shapes:
        x = _operand(rows, n_ch, torch.bfloat16, 0, gen, 2.0, 0.5)
        dy = _operand(rows, n_ch, torch.bfloat16, 0, gen)
        mean, var = fused_bn.bn_stats_plain(x)
        runs.append((x, dy, mean, var, fused_bn.bn_stats(x), fused_bn.bn_bwd_reduce(x, dy, mean, var, 1e-5)))
    geoms = {fused_bn.reduce_geometry(r, c, 2, n, c % 8 == 0)[4:6] for r, c in shapes for n in (1, 2)}
    assert len(geoms) >= 6  # (strips, splits) differ from layer to layer
    ws = fused_bn._workspace(runs[0][0], fused_bn._stream(runs[0][0]))
    torch.cuda.synchronize()
    for x, dy, mean, var, stats, red in runs:
        _close(stats, (mean, var))
        _close(red, fused_bn.bn_bwd_reduce_plain(x, dy, mean, var, 1e-5))
    assert fused_bn._workspace(runs[-1][0], fused_bn._stream(runs[-1][0])) is ws and not ws.counters.any()


@pytest.mark.cuda
def test_a_one_percent_fault_in_one_partial_fails_the_tolerance():
    """The finisher's mirror over the partials that the launch left in the
    workspace gives the kernel's outputs; the same with the largest partial
    off by 1% fails ``_close``, for both reductions."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, n_ch = 3136, 64
    x = _operand(rows, n_ch, torch.float32, 0, gen, 2.0, 0.5)
    dy = _operand(rows, n_ch, torch.float32, 0, gen)
    mean, var = fused_bn.bn_stats_plain(x)
    ws = fused_bn._workspace(x, fused_bn._stream(x))

    def partials(n_inputs):
        g = fused_bn.reduce_geometry(rows, n_ch, 4, n_inputs, True, ws.n_sms)
        torch.cuda.synchronize()
        return g, ws.partials[:2 * g.splits * n_ch].view(2, g.splits, n_ch).clone()

    def faulted(p):
        p = p.clone()
        flat = p.view(-1)
        flat[flat.abs().argmax()] *= 1.01
        return p

    def stats_from(g, s, q):
        return fused_bn.stats_from_sums(fused_bn.finish_plain(s, g).float(),
                                        fused_bn.finish_plain(q, g).float(), float(rows))

    got = fused_bn.bn_stats(x)
    g, p = partials(1)
    assert g.splits > 1
    torch.testing.assert_close(stats_from(g, p[0], p[1]), got)
    _close(got, (mean, var))
    with pytest.raises(AssertionError):
        _close(stats_from(g, p[0], faulted(p[1])), (mean, var))

    red = fused_bn.bn_bwd_reduce(x, dy, mean, var, 1e-5)
    g, p = partials(2)
    assert g.splits > 1
    mirror = (fused_bn.finish_plain(p[0], g).float(), fused_bn.finish_plain(p[1], g).float())
    torch.testing.assert_close(mirror, red)
    want = fused_bn.bn_bwd_reduce_plain(x, dy, mean, var, 1e-5)
    _close(red, want)
    with pytest.raises(AssertionError):
        _close((fused_bn.finish_plain(faulted(p[0]), g).float(), mirror[1]), want)
