"""The port's flash attention (CPU path: the kernels' plain versions behind
the same ``autograd.Function``) against the JAX package's Pallas kernels in
interpret mode, and the port's ``plain_attention`` against the JAX one. The
inputs come from numpy with a seed; the tolerances are the JAX package's
own flash-attention tests'."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.ops import flash_attention as jfa
from tensorflowonspark_tpu.parallel.ring_attention import plain_attention as jplain
from tensorflowonspark_tpu_torch.ops import flash_attention as fa
from tensorflowonspark_tpu_torch.parallel.ring_attention import plain_attention

B, H, L, D = 2, 2, 256, 64


def _qkv(seed, b=B, h=H, length=L, d=D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, length, d)).astype(np.float32) for _ in range(3)]


def _segments(b, length, spans):
    """Ids 1..n over ``spans`` ((start, stop) pairs), 0 (padding) elsewhere."""
    seg = np.zeros((b, length), np.int32)
    for i, (lo, hi) in enumerate(spans, start=1):
        seg[:, lo:hi] = i
    return seg


#: a segment starting mid-block (at 100 with 64-row blocks) and a padded tail
SPANS = ((0, 100), (100, 171), (171, 230))


def _t(x, requires_grad=False):
    return torch.tensor(x, requires_grad=requires_grad)


@pytest.mark.parametrize("block", [512, 64], ids=["one-block", "multi-block"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("segmented", [False, True])
def test_forward_o_and_lse_match_pallas_interpret(block, causal, segmented):
    launches = fa.launch_counts()  # process-wide: other files may share the worker
    q, k, v = _qkv(0)
    seg = _segments(B, L, SPANS) if segmented else None
    merge = lambda x: x.reshape(B * H, L, D)  # noqa: E731
    jseg = None if seg is None else jnp.asarray(np.repeat(seg, H, axis=0))
    jo, jlse = jfa._flash_fwd(
        jnp.asarray(merge(q)), jnp.asarray(merge(k)), jnp.asarray(merge(v)), jseg,
        1 / math.sqrt(D), causal, block, block, True,
    )
    o, lse = fa.flash_fwd(_t(merge(q)), _t(merge(k)), _t(merge(v)),
                          None if seg is None else _t(seg), 1 / math.sqrt(D), causal, H)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, 0], atol=2e-5)
    # CPU tensors take the plain versions: no kernel launched in this test
    assert fa.launch_counts() == launches
    assert set(launches) == {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("segmented", [False, True])
def test_gradients_through_autograd_function_match_jax_grad(causal, segmented):
    q, k, v = _qkv(1)
    w = np.random.default_rng(2).standard_normal((B, H, L, D)).astype(np.float32)
    seg = _segments(B, L, SPANS) if segmented else None

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal,
                                segment_ids=None if seg is None else jnp.asarray(seg),
                                block_q=64, block_k=64, interpret=True)
        return jnp.sum(o * w)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (_t(x, True) for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal, segment_ids=None if seg is None else _t(seg))
    (out * _t(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)


def test_bf16_forward_matches_pallas_interpret():
    q, k, v = _qkv(3)
    seg = _segments(B, L, SPANS)
    jo = jfa.flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=True,
                             segment_ids=jnp.asarray(seg), block_q=64, block_k=64, interpret=True)
    o = fa.flash_attention(*(_t(x).bfloat16() for x in (q, k, v)), causal=True, segment_ids=_t(seg))
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), np.asarray(jo, np.float32), atol=0.05)


@pytest.mark.parametrize("causal", [True, False])
def test_packed_equals_unpacked(causal):
    """Each packed sequence attends as if it were alone (the fence), also
    for the one that starts mid-block."""
    q, k, v = _qkv(4)
    seg = _segments(B, L, SPANS)
    out = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal, segment_ids=_t(seg)).numpy()
    for lo, hi in SPANS:
        alone = jplain(*(jnp.asarray(x[:, :, lo:hi]) for x in (q, k, v)), causal=causal)
        np.testing.assert_allclose(out[:, :, lo:hi], np.asarray(alone), atol=2e-5)


@pytest.mark.parametrize("segmented", [False, True])
def test_ragged_length_matches_plain_attention(segmented):
    """L=200 is no multiple of any block: the port runs it unpadded."""
    q, k, v = _qkv(5, length=200)
    seg = _segments(B, 200, ((0, 70), (70, 181))) if segmented else None
    tseg = None if seg is None else _t(seg)
    out = fa.flash_attention(_t(q), _t(k), _t(v), causal=True, segment_ids=tseg)
    want = plain_attention(_t(q), _t(k), _t(v), causal=True, segment_ids=tseg)
    jwant = jplain(*(jnp.asarray(x) for x in (q, k, v)), causal=True,
                   segment_ids=None if seg is None else jnp.asarray(seg))
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-5)
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant), atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_matches_jax_plain_attention(dtype):
    q, k, v = _qkv(6, length=96, d=32)
    seg = _segments(B, 96, ((0, 40), (40, 90)))
    jout = jplain(*(jnp.asarray(x, dtype) for x in (q, k, v)), causal=True, segment_ids=jnp.asarray(seg))
    out = plain_attention(*(_t(x).to(getattr(torch, dtype)) for x in (q, k, v)), causal=True,
                          segment_ids=_t(seg))
    assert out.dtype == getattr(torch, dtype)
    # bf16: both compute in f32 from the same bf16 inputs; the outputs round
    # to bf16 (8 significant bits) from sums taken in another order
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32),
                               atol=2e-5 if dtype == "float32" else 2e-2)


def test_cpu_tensors_take_the_plain_versions_at_any_head_dim():
    """The CPU path is the plain versions at any head dim (the kernels take
    64 and 128 only, and raise on a CUDA tensor of another)."""
    q, k, v = _qkv(7, length=40, d=16)
    out = fa.flash_attention(_t(q), _t(k), _t(v), causal=True)
    want = plain_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-5)


def _layout(kind, b, length, seed):
    """Segment ids ``[b, length]`` of one packed layout (``seed`` draws the
    random ones)."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, length), np.int32)
    if kind == "mid_block":  # ids starting mid-block, a pad-0 tail
        return _segments(b, length, ((0, 100), (100, 171), (171, min(230, length - 1))))
    if kind == "packed":  # random lengths, then padding over the last eighth
        for row in range(b):
            pos, sid = 0, 1
            while pos < length - length // 8:
                n = int(rng.integers(1, max(2, length // 3)))
                seg[row, pos:min(pos + n, length - length // 8)] = sid
                pos, sid = pos + n, sid + 1
    elif kind == "one_long":  # one segment over many blocks, a short pad tail
        seg[:, :length - 9] = 1
    elif kind == "alternating":  # non-contiguous ids: 1, 2, 1, 2, ...
        seg[:, 0::2], seg[:, 1::2] = 1, 2
    elif kind == "reused":  # an id that comes back after others
        seg[:, :40], seg[:, 40:90], seg[:, 90:150], seg[:, 150:] = 1, 2, 1, 3
    elif kind == "all_pad":  # a row of padding only, beside a packed one
        seg[1:] = _layout("packed", b - 1, length, seed + 1)
    elif kind != "no_ids":
        raise ValueError(kind)
    return seg


LAYOUTS = ["mid_block", "packed", "one_long", "alternating", "reused", "all_pad", "no_ids"]


@pytest.mark.parametrize("length", [256, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", LAYOUTS)
def test_visited_blocks_never_drop_an_attended_pair(kind, causal, length):
    """Every (q block, kv block) pair that holds an attended (q, k) pair
    (equal ids, and k <= q when causal) is visited; causal pairs above the
    diagonal never are; without a fence every causal pair is."""
    for seed in range(3):
        seg = _layout(kind, 2, length, seed)
        visit = fa.visited_blocks(_t(seg), causal).numpy()
        n = -(-length // 64)
        assert visit.shape == (2, n, n)
        attended = seg[:, :, None] == seg[:, None, :]
        if causal:
            attended &= np.tril(np.ones((length, length), bool))
        pad = n * 64 - length
        blocks = np.pad(attended, ((0, 0), (0, pad), (0, pad))).reshape(2, n, 64, n, 64).any((2, 4))
        assert not (blocks & ~visit).any()
        if causal:
            assert not (visit & ~np.tril(np.ones((n, n), bool))).any()
        if kind in ("no_ids", "one_long", "alternating"):
            assert (visit == blocks).all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["mid_block", "packed", "alternating", "reused", "all_pad"])
def test_plain_versions_skipping_unvisited_blocks_match_pallas_interpret(kind, causal, monkeypatch):
    """The plain versions with every score of a block pair that the kernels
    skip forced to the sentinel (what the skip computes) equal the JAX
    package's flash attention in interpret mode: o and lse within 2e-5,
    the gradients within 5e-4."""
    q, k, v = _qkv(8)
    w = np.random.default_rng(9).standard_normal((B, H, L, D)).astype(np.float32)
    seg = _layout(kind, B, L, 10)
    masked_scores = fa._masked_scores

    def skipping(q, k, seg, scale, causal, heads, seg_k=None):
        s = masked_scores(q, k, seg, scale, causal, heads, seg_k=seg_k)
        visit = fa.visited_blocks(seg, causal, seg_k=seg_k).repeat_interleave(64, 1).repeat_interleave(64, 2)
        visit = visit[:, :s.shape[1], :s.shape[2]].repeat_interleave(heads, 0)
        return torch.where(visit, s, fa.NEG_BIG)

    monkeypatch.setattr(fa, "_masked_scores", skipping)
    merge = lambda x: x.reshape(B * H, L, D)  # noqa: E731
    jo, jlse = jfa._flash_fwd(
        jnp.asarray(merge(q)), jnp.asarray(merge(k)), jnp.asarray(merge(v)),
        jnp.asarray(np.repeat(seg, H, axis=0)), 1 / math.sqrt(D), causal, 64, 64, True,
    )
    o, lse = fa.flash_fwd(_t(merge(q)), _t(merge(k)), _t(merge(v)), _t(seg), 1 / math.sqrt(D), causal, H)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, 0], atol=2e-5)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, segment_ids=jnp.asarray(seg),
                                block_q=64, block_k=64, interpret=True)
        return jnp.sum(o * w)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (_t(x, True) for x in (q, k, v))
    (fa.flash_attention(tq, tk, tv, causal=causal, segment_ids=_t(seg)) * _t(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)


def test_kernel_resources_reads_registers_and_spills_from_the_ptxas_log(tmp_path):
    """The build report's parser, on a log in ``nvcc -Xptxas -v``'s format."""
    log = tmp_path / "flash.log"
    log.write_text(
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_125flash_bwd_dq_wgmma_kernelILi64ELi3EEEv14CUtensorMap_stS1_S1_S1_PKiPKfS5_"
        "P13__nv_bfloat16iifb' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_125flash_bwd_dq_wgmma_kernelILi64ELi3EEE\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 154 registers, used 1 barriers, 992 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi128ELi2EEEv14CUtensorMap_stS1_S1_PKiP13__nv_bfloat16Pfiifb'"
        " for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi128ELi2EEE\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 808 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_120flash_bwd_dkv_kernelIfLi128EEEvPKT_S3_S3_PKiS3_PKfS7_PS1_S8_iifb' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_bwd_dkv_kernelIfLi128EEE\n"
        "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers, 432 bytes cmem[0]\n"
    )
    assert fa.kernel_resources(str(log)) == [
        {"kernel": "flash_bwd_dq_wgmma_kernel", "dtype": "bfloat16", "head_dim": 64, "registers": 154,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "flash_fwd_wgmma_kernel", "dtype": "bfloat16", "head_dim": 128, "registers": 168,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "flash_bwd_dkv_kernel", "dtype": "float32", "head_dim": 128, "registers": 255,
         "spill_stores": 12, "spill_loads": 16},
    ]


LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def _forward_kernel_loop(q, k, v, seg, scale, causal, heads, block=64):
    """A blockwise twin of the bf16 forward kernel's loop
    (``flash_fwd_wgmma_kernel``): per q block, only the kv blocks that
    ``visited_blocks`` keeps, scores in the log2 domain, the sentinel set
    after scaling and -inf past L, m starting at the sentinel, l summed from
    the f32 p, and p rounded to the input dtype before P·V; then
    ``O = acc / max(l, 1e-30)`` and ``lse = m·ln 2 + log(max(l, 1e-30))``."""
    bh, length, d = q.shape
    n = -(-length // block)
    ids = torch.zeros(bh // heads, length, dtype=torch.int32) if seg is None else seg
    visit = fa.visited_blocks(ids, causal, block)
    pad = n * block - length
    kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad)) for t in (k, v))
    ids_k = torch.nn.functional.pad(ids, (0, pad), value=-1)
    pos = torch.arange(n * block)
    o = torch.empty(bh, length, d)
    lse = torch.empty(bh, length)
    for b in range(bh):
        for qb in range(n):
            qi = pos[qb * block:min((qb + 1) * block, length)]
            m = torch.full((len(qi),), fa.NEG_BIG)
            l = torch.zeros(len(qi))
            acc = torch.zeros(len(qi), d)
            for kb in range(qb + 1 if causal else n):
                if not visit[b // heads, qb, kb]:
                    continue
                kj = pos[kb * block:(kb + 1) * block]
                x = q[b, qi].float() @ kf[b, kj].T * (scale * LOG2E)
                drop = torch.zeros(len(qi), block, dtype=torch.bool)
                if causal:
                    drop |= kj[None] > qi[:, None]
                if seg is not None:
                    drop |= ids_k[b // heads, kj][None] != ids[b // heads, qi][:, None]
                x = torch.where(drop, fa.NEG_BIG, x)
                x = torch.where(kj[None] >= length, -math.inf, x)
                m_new = torch.maximum(m, x.amax(1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(x - m_new[:, None])
                l = l * corr + p.sum(1)
                acc = acc * corr[:, None] + p.to(q.dtype).float() @ vf[b, kj]
                m = m_new
            den = l.clamp_min(1e-30)
            o[b, qi] = acc / den[:, None]
            lse[b, qi] = m * LN2 + torch.log(den)
    return o.to(q.dtype), lse


def _first_visited_block_masked(seg, causal, length, block=64):
    """Rows (of any batch row) that attend no key of the first kv block
    their q block visits: the sentinel-garbage rows that the correction
    exp2(sentinel - m) = 0 must wipe."""
    visit = fa.visited_blocks(_t(seg), causal, block).numpy()
    rows = 0
    for b in range(seg.shape[0]):
        for qb in range(visit.shape[1]):
            kb = int(np.argmax(visit[b, qb]))
            qi = np.arange(qb * block, min((qb + 1) * block, length))
            kj = np.arange(kb * block, min((kb + 1) * block, length))
            attend = seg[b, qi][:, None] == seg[b, kj][None]
            if causal:
                attend &= kj[None] <= qi[:, None]
            rows += int((~attend.any(1)).sum())
    return rows


@pytest.mark.parametrize("length", [256, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["mid_block", "reused", "all_pad"])
def test_forward_kernel_loop_twin_matches_pallas_interpret(kind, causal, dtype, length):
    """The bf16 forward kernel's loop, written blockwise in the log2 domain
    over the visited blocks only, against the JAX package's forward in
    interpret mode: o and lse within 2e-5 (f32) or 0.05 (bf16), the JAX
    tests' tolerances. The mid_block and reused layouts hold rows whose
    first visited block is fully masked for them."""
    q, k, v = _qkv(12, length=length)
    seg = _layout(kind, B, length, 13)
    if kind in ("mid_block", "reused"):
        assert _first_visited_block_masked(seg, causal, length) > 0
    merge = lambda x: x.reshape(B * H, length, D)  # noqa: E731
    jo, jlse = jfa._flash_fwd(
        *(jnp.asarray(merge(x), dtype) for x in (q, k, v)), jnp.asarray(np.repeat(seg, H, axis=0)),
        1 / math.sqrt(D), causal, 64, 64, True,
    )
    o, lse = _forward_kernel_loop(*(_t(merge(x)).to(getattr(torch, dtype)) for x in (q, k, v)), _t(seg),
                                  1 / math.sqrt(D), causal, H)
    tol = 2e-5 if dtype == "float32" else 0.05
    np.testing.assert_allclose(o.float().numpy(), np.asarray(jo, np.float32), atol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, 0], atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["mid_block", "reused", "all_pad"])
def test_online_mirror_matches_forward_kernel_loop_twin(kind, causal, dtype):
    """``flash_fwd_online_plain`` (every kv block at once over all rows, the
    card's reference for the bf16 forward's f32 output) gives the blockwise
    twin's o and lse: a block the kernel skips adds exactly nothing, and p is
    rounded against the same running max (o within 2^-12 as a norm, the
    card's limit, lse within 1e-5)."""
    q, k, v = _qkv(15)
    seg = _t(_layout(kind, B, L, 16))
    merge = lambda x: _t(x.reshape(B * H, L, D)).to(getattr(torch, dtype))  # noqa: E731
    args = (merge(q), merge(k), merge(v), seg, 1 / math.sqrt(D), causal, H)
    o, lse = fa.flash_fwd_online_plain(*args)
    o_twin, lse_twin = _forward_kernel_loop(*args)
    assert o.dtype == torch.float32
    g, r = o.to(o_twin.dtype).float(), o_twin.float()
    assert float((g - r).norm() / r.norm()) <= 2.0 ** -12
    np.testing.assert_allclose(lse.numpy(), lse_twin.numpy(), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_online_mirror_with_key_ids_matches_plain_forward(causal):
    """With the keys' ids of their own (a ring hop) and f32 inputs, where
    rounding p changes nothing, the online mirror equals ``flash_fwd_plain``
    within 2e-5 on the rows that attend a key."""
    q, k, v = _qkv(17)
    seg = _t(_segments(B, L, SPANS))
    seg_k = _t(_segments(B, L, ((0, 40), (40, 150), (150, 256))))
    merge = lambda x: _t(x.reshape(B * H, L, D))  # noqa: E731
    args = (merge(q), merge(k), merge(v), seg, 1 / math.sqrt(D), causal, H)
    o, lse = fa.flash_fwd_online_plain(*args, seg_k=seg_k)
    o_ref, lse_ref = fa.flash_fwd_plain(*args, seg_k=seg_k)
    attend = seg[:, :, None] == seg_k[:, None, :]
    if causal:
        attend &= torch.ones(L, L, dtype=torch.bool).tril()
    rows = attend.any(-1).repeat_interleave(H, 0)
    assert bool(rows.any()) and not bool(rows.all())
    np.testing.assert_allclose(o[rows].numpy(), o_ref[rows].numpy(), atol=2e-5)
    np.testing.assert_allclose(lse[rows].numpy(), lse_ref[rows].numpy(), atol=2e-5)


def test_launch_counts_stay_exact_when_threads_launch_at_once():
    """The wrappers count under a lock (``Pipeline1F1B``'s stage threads
    launch at once): 8 threads x 2,000 counts with a short switch interval
    lose none."""
    import sys
    import threading

    before = fa.flash_fwd.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [fa._count(fa.flash_fwd) for _ in range(2000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert fa.flash_fwd.launches - before == 16000
