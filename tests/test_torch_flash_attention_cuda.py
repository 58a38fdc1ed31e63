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
    (2, 2, 256, 32, True, "packed"),       # D=32: zero-padded to the D=64 kernels
    (1, 3, 200, 48, True, "packed"),       # D=48, ragged: padded to 64
    (2, 2, 256, 96, False, "packed"),      # D=96: padded to the D=128 kernels
    (1, 2, 256, 256, True, "packed"),      # D=256
    (2, 1, 200, 256, False, "packed"),     # D=256, ragged, not causal
    (1, 3, 200, 256, True, "reused"),      # D=256, ragged, a first visited block fully masked
    (1, 2, 2048, 256, True, "packed"),     # D=256 at the slice's length
    (2, 2, 256, 160, True, "packed"),      # D=160: padded to the D=256 kernels
    (1, 3, 200, 192, False, "pad_row"),    # D=192, ragged, a row of padding: padded to 256
    (1, 2, 256, 320, True, "packed"),      # D=320: the split-D kernels, a 256 and a 64-wide chunk
    (2, 1, 200, 384, False, "pad_row"),    # D=384, ragged, not causal, a row of padding
    (1, 3, 200, 512, True, "reused"),      # D=512, ragged, a first visited block fully masked
    (1, 1, 2048, 512, True, "packed"),     # D=512 at the slice's length
    (1, 2, 130, 300, True, "packed"),      # D=300: zero-padded to the split-D width 304
    (1, 1, 256, 1024, True, "packed"),     # D=1024: four chunks
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
@pytest.mark.parametrize("d", [0])
def test_unsupported_head_dim_raises_on_card(d):
    """A CUDA tensor never reaches the plain version: a head dim the
    kernels do not take (below 1: every head dim above runs) raises, and
    launches nothing."""
    _card()
    q = torch.randn(2, 128, d, device="cuda")
    before = fa.launch_counts()
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q, q, q, None, 0.1, True, 1)
    assert fa.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256, 320, 512])
def test_key_ids_and_f32_outputs_on_card(d):
    """A ring hop's launch: the keys carry ids of their own (every query id
    among them, so every row attends a key) and the bf16 kernels write f32
    outputs, against the plain versions cast to the input dtype; and the
    f32 outputs before any cast (O against the forward's own online
    rounding, ``flash_fwd_online_plain``) within 2^-12 as a norm, a limit
    that the same launch's bf16 outputs cast up to f32 exceed."""
    _card()
    gen = torch.Generator().manual_seed(13)
    b, heads, length = 2, 2, 256
    q, k, v, do = (torch.randn(b * heads, length, d, generator=gen).cuda().to(torch.bfloat16)
                   for _ in range(4))
    seg = torch.full((b, length), 2, dtype=torch.int32)
    seg[:, :100] = 1
    seg_k = torch.full((b, length), 2, dtype=torch.int32)
    seg_k[:, 40:120], seg_k[:, :8] = 1, 0
    seg, seg_k = seg.cuda(), seg_k.cuda()
    scale, kw = 1.0 / math.sqrt(d), {"seg_k": seg_k, "out_dtype": torch.float32}
    o, lse = fa.flash_fwd(q, k, v, seg, scale, False, heads, **kw)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, seg, scale, False, heads, **kw)
    assert o.dtype == torch.float32
    _close("o", o.to(torch.bfloat16), o_ref.to(torch.bfloat16))
    _close("lse", lse, lse_ref)
    bwd = (seg, do, lse_ref, (do.float() * o_ref).sum(-1), scale, False, heads)
    _close("dq", fa.flash_bwd_dq(q, k, v, *bwd, **kw).to(torch.bfloat16),
           fa.flash_bwd_dq_plain(q, k, v, *bwd, **kw).to(torch.bfloat16))
    for name, got, want in zip(("dk", "dv"), fa.flash_bwd_dkv(q, k, v, *bwd, **kw),
                               fa.flash_bwd_dkv_plain(q, k, v, *bwd, **kw)):
        _close(name, got.to(torch.bfloat16), want.to(torch.bfloat16))
    norm = lambda g, r: float((g.float() - r).norm() / r.norm())  # noqa: E731
    f32_refs = {"o": (o, fa.flash_fwd(q, k, v, seg, scale, False, heads, seg_k=seg_k)[0],
                      fa.flash_fwd_online_plain(q, k, v, seg, scale, False, heads, seg_k=seg_k)[0]),
                "dq": (fa.flash_bwd_dq(q, k, v, *bwd, **kw), fa.flash_bwd_dq(q, k, v, *bwd, seg_k=seg_k),
                       fa.flash_bwd_dq_plain(q, k, v, *bwd, **kw))}
    for name, got, control, want in zip(("dk", "dv"), fa.flash_bwd_dkv(q, k, v, *bwd, **kw),
                                        fa.flash_bwd_dkv(q, k, v, *bwd, seg_k=seg_k),
                                        fa.flash_bwd_dkv_plain(q, k, v, *bwd, **kw)):
        f32_refs[name] = (got, control, want)
    for name, (got, control, want) in f32_refs.items():
        assert got.dtype == torch.float32 and control.dtype == torch.bfloat16, name
        assert norm(got, want) <= 2.0 ** -12, (name, norm(got, want))
        assert norm(control, want) > 2.0 ** -12, (name, norm(control, want))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 512])
def test_ring_of_four_matches_whole_sequence_flash_on_card(d):
    """The one-process ring (4 members, causal, packed) launches each
    kernel 10 times a direction and matches whole-sequence flash; at
    D = 512 through the split-D kernels, their hops with f32 outputs."""
    from tensorflowonspark_tpu_torch.ops.flash_attention import flash_attention
    from tensorflowonspark_tpu_torch.parallel.ring_attention import ring_attention_local

    _card()
    gen = torch.Generator().manual_seed(14)
    b, heads, length = 2, 4, 512
    q, k, v, do = (torch.randn(b, heads, length, d, generator=gen).cuda().to(torch.bfloat16) for _ in range(4))
    seg = _packed_segments(b, length, gen)
    outs = []
    for fn in (lambda *t: ring_attention_local(*t, 4, causal=True, segment_ids=seg),
               lambda *t: flash_attention(*t, causal=True, segment_ids=seg)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fa.reset_launch_counts()
        o = fn(*leaves)
        outs.append((o.detach(),) + torch.autograd.grad(o, leaves, do))
        if len(outs) == 1:
            assert fa.launch_counts() == {"flash_fwd": 10, "flash_bwd_dq": 10, "flash_bwd_dkv": 10}
    for name, got, want in zip(("o", "dq", "dk", "dv"), *outs):
        g, r = got.float(), want.float()
        assert float((g - r).norm() / r.norm()) <= 2.0 ** -8, name
