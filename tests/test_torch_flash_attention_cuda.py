"""The flash-attention CUDA kernels against their plain PyTorch versions on
a CUDA device. Marked ``cuda``: each test skips without a card. This file
imports neither jax nor the JAX package, so it also runs on a card host
that has only PyTorch (``python -m pytest --noconftest -m cuda
tests/test_torch_flash_attention_cuda.py``)."""

import math

import pytest
import torch

from tensorflowonspark_tpu_torch.ops import flash_attention as fa

#: f32 outputs: both sides sum in f32 in another order (of the largest
#: value, floor 1)
F32_TOL = 1e-4
#: bf16 outputs, elementwise: |got - ref| <= tol * (|ref| + rms(ref)) (the
#: summands of dq, dk, dv cancel, so one bf16 ulp at their scale lands on
#: smaller values)
BF16_ELEM_TOL = 2.0 ** -5
#: bf16 outputs, as a norm ||got - ref|| / ||ref||: O differs most (p rounds
#: to bf16 against a running max in the kernel, the final max in the plain
#: version); dq, dk, dv round the same p and ds on both sides
BF16_NORM_TOL = {"o": 2.0 ** -8, "dq": 2.0 ** -10, "dk": 2.0 ** -10, "dv": 2.0 ** -10}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc): run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' einsums in full f32


def _packed_segments(b, length, gen, layout="packed"):
    """Segment ids on the card. ``packed``: segments of random lengths (some
    starting mid-block), then padding (id 0) over the last eighth of each
    row; ``alternating``: ids 1, 2, 1, 2, ... (non-contiguous: every block
    pair is visited, and most scores are fenced); ``pad_row``: the first row
    padding only, the others packed; ``reused``: in every 256 positions ids
    a, a+1, a, a+2 over [0, 40), [40, 90), [90, 150), [150, 256) (a fresh a
    each time), so the rows of id a+2 in the third 64-row block find their
    first visited kv block (the chunk's first) fully masked."""
    seg = torch.zeros(b, length, dtype=torch.int32)
    if layout == "alternating":
        seg[:, 0::2], seg[:, 1::2] = 1, 2
        return seg.cuda()
    if layout == "reused":
        for c0 in range(0, length, 256):
            a = 1 + 3 * (c0 // 256)
            for lo, hi, sid in ((0, 40, a), (40, 90, a + 1), (90, 150, a), (150, 256, a + 2)):
                seg[:, c0 + lo:c0 + hi] = sid
        return seg.cuda()
    for row in range(1 if layout == "pad_row" else 0, b):
        pos, sid = 0, 1
        while pos < length - length // 8:
            n = int(torch.randint(1, max(2, length // 3), (1,), generator=gen))
            seg[row, pos:min(pos + n, length - length // 8)] = sid
            pos, sid = pos + n, sid + 1
    return seg.cuda()


def _errors(name, got, want):
    """Failures of ``got`` against ``want`` under the limits above."""
    g, r = got.float(), want.float()
    if want.dtype == torch.float32:
        err, tol = float((g - r).abs().max()), F32_TOL * max(1.0, float(r.abs().max()))
        return [] if err <= tol else ["{}: max abs err {} > {}".format(name, err, tol)]
    rms = r.square().mean().sqrt()
    elem = float(((g - r).abs() / (r.abs() + rms)).max())
    norm = float((g - r).norm() / r.norm())
    failures = []
    if not elem <= BF16_ELEM_TOL:
        failures.append("{}: elementwise err {} > {}".format(name, elem, BF16_ELEM_TOL))
    if not norm <= BF16_NORM_TOL[name]:
        failures.append("{}: norm err {} > {}".format(name, norm, BF16_NORM_TOL[name]))
    return failures


def _close(name, got, want):
    failures = _errors(name, got, want)
    assert not failures, failures


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,heads,length,d,causal,segmented", [
    (2, 2, 256, 64, True, "packed"),
    (1, 3, 200, 64, True, "packed"),       # ragged L, a partial last block
    (2, 1, 130, 128, False, "packed"),     # D=128, ragged, not causal
    (1, 2, 320, 128, True, None),
    (1, 1, 64, 64, False, None),
    (2, 2, 256, 64, True, "alternating"),  # non-contiguous ids
    (3, 2, 200, 64, False, "pad_row"),     # a row of padding only
    (2, 4, 2048, 128, True, "packed"),     # D=128 at the slice's length
    (1, 8, 2048, 64, True, "reused"),      # rows whose first visited block is fully masked
    (1, 8, 2048, 64, False, "packed"),     # not causal, fenced: the whole row range is a candidate
])
def test_kernels_match_plain_versions_on_card(dtype, b, heads, length, d, causal, segmented):
    _card()
    gen = torch.Generator().manual_seed(length + d)
    q, k, v, do = (torch.randn(b * heads, length, d, generator=gen).cuda().to(dtype) for _ in range(4))
    seg = _packed_segments(b, length, gen, segmented) if segmented else None
    scale = 1.0 / math.sqrt(d)
    args = (seg, scale, causal, heads)
    before = fa.launch_counts()
    o, lse = fa.flash_fwd(q, k, v, *args)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, *args)
    _close("o", o, o_ref)
    _close("lse", lse, lse_ref)
    delta = (do.float() * o_ref.float()).sum(-1)
    bwd = (seg, do, lse_ref, delta, scale, causal, heads)
    _close("dq", fa.flash_bwd_dq(q, k, v, *bwd), fa.flash_bwd_dq_plain(q, k, v, *bwd))
    dk, dv = fa.flash_bwd_dkv(q, k, v, *bwd)
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(q, k, v, *bwd)
    _close("dk", dk, dk_ref)
    _close("dv", dv, dv_ref)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    assert all(after[n] == before[n] + 1 for n in after)


@pytest.mark.cuda
def test_autograd_matches_plain_math_on_card():
    """flash_attention's gradients (the three kernels) against autograd
    through the plain forward, f32, causal with packed segments."""
    _card()
    gen = torch.Generator().manual_seed(7)
    b, heads, length, d = 2, 4, 192, 64
    q, k, v, w = (torch.randn(b, heads, length, d, generator=gen).cuda() for _ in range(4))
    seg = _packed_segments(b, length, gen)
    grads = []
    for use_kernels in (True, False):
        qi, ki, vi = (t.clone().requires_grad_() for t in (q, k, v))
        if use_kernels:
            out = fa.flash_attention(qi, ki, vi, causal=True, segment_ids=seg)
        else:
            merge = lambda t: t.reshape(b * heads, length, d)  # noqa: E731
            o, _ = fa.flash_fwd_plain(merge(qi), merge(ki), merge(vi), seg, 1 / math.sqrt(d), True, heads)
            out = o.reshape(b, heads, length, d)
        (out * w).sum().backward()
        grads.append((out.detach(), qi.grad, ki.grad, vi.grad))
    for name, got, want in zip(("o", "dq", "dk", "dv"), *grads):
        _close(name, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("output", ["o", "dq", "dk", "dv"])
def test_bf16_check_catches_a_one_percent_fault_on_card(output):
    """The bf16 limits pass the kernel's output and fail it off by 1%."""
    _card()
    gen = torch.Generator().manual_seed(11)
    b, heads, length, d = 2, 2, 256, 64
    q, k, v, do = (torch.randn(b * heads, length, d, generator=gen).cuda().to(torch.bfloat16)
                   for _ in range(4))
    seg = _packed_segments(b, length, gen)
    scale = 1.0 / math.sqrt(d)
    o_ref, lse = fa.flash_fwd_plain(q, k, v, seg, scale, True, heads)
    bwd = (seg, do, lse, (do.float() * o_ref.float()).sum(-1), scale, True, heads)
    got, want = {
        "o": (fa.flash_fwd(q, k, v, seg, scale, True, heads)[0], o_ref),
        "dq": (fa.flash_bwd_dq(q, k, v, *bwd), fa.flash_bwd_dq_plain(q, k, v, *bwd)),
        "dk": (fa.flash_bwd_dkv(q, k, v, *bwd)[0], fa.flash_bwd_dkv_plain(q, k, v, *bwd)[0]),
        "dv": (fa.flash_bwd_dkv(q, k, v, *bwd)[1], fa.flash_bwd_dkv_plain(q, k, v, *bwd)[1]),
    }[output]
    assert not _errors(output, got, want)
    assert _errors(output, got.float() * 1.01, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 96])
def test_unsupported_head_dim_raises_on_card(d):
    """A CUDA tensor never reaches the plain version: an unsupported head
    dim raises."""
    _card()
    q = torch.randn(2, 128, d, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q, q, q, None, 0.1, True, 1)
