"""The port's flash attention (CPU path: the kernels' plain versions behind
the same ``autograd.Function``) against the JAX package's Pallas kernels in
interpret mode, and the port's ``plain_attention`` against the JAX one. The
inputs come from numpy with a seed; the tolerances are the JAX package's
own flash-attention tests'."""

import functools
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


#: the JAX package's forward and backward kernels in interpret mode,
#: compiled once a configuration (eager interpret takes about twice as long)
_jax_flash_fwd = jax.jit(jfa._flash_fwd, static_argnums=(4, 5, 6, 7, 8))
_jax_flash_bwd = jax.jit(jfa._flash_bwd, static_argnums=(7, 8, 9, 10, 11))


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
    jo, jlse = _jax_flash_fwd(
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

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
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


@pytest.mark.parametrize("d", [16, 300])
def test_cpu_tensors_take_the_plain_versions_at_any_head_dim(d):
    """The CPU path is the plain versions at any head dim (the kernels run
    any head dim: up to 256 through the padding route, above it through
    the split-D kernels), here one below the compiled widths and one above
    256 that is not a multiple of 8."""
    q, k, v = _qkv(7, length=40, d=d)
    out = fa.flash_attention(_t(q), _t(k), _t(v), causal=True)
    want = plain_attention(_t(q), _t(k), _t(v), causal=True)
    assert out.shape == want.shape
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
    jo, jlse = _jax_flash_fwd(
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

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
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


def test_kernel_resources_names_the_split_kernels(tmp_path):
    """The split-D kernels (no template: any D above 256) by name and
    dtype, with no head dim."""
    log = tmp_path / "flash.log"
    log.write_text(
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_132flash_bwd_dkv_split_wgmma_kernelE14CUtensorMap_stS0_S0_S0_PKiS2_PKfS4_PvS5_iiifbb'"
        " for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 222 registers, used 1 barriers, 1080 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_122flash_fwd_split_kernelEPKfS1_S1_PKiS3_PfS4_iiifb' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers, 424 bytes cmem[0]\n"
    )
    assert fa.kernel_resources(str(log)) == [
        {"kernel": "flash_bwd_dkv_split_wgmma_kernel", "dtype": "bfloat16", "head_dim": None, "registers": 222,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "flash_fwd_split_kernel", "dtype": "float32", "head_dim": None, "registers": 96,
         "spill_stores": 0, "spill_loads": 0},
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
    jo, jlse = _jax_flash_fwd(
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


# -- head dims the kernels are not compiled for: the padding route -------------


def test_head_width_pads_up_to_the_next_compiled_width():
    """Up to 256 the next compiled width; above it the split-D kernels'
    width, the next multiple of 8 (no upper bound); below 1 a refusal."""
    assert [fa.head_width(d) for d in (1, 32, 48, 64, 65, 96, 128)] == [64, 64, 64, 64, 128, 128, 128]
    assert [fa.head_width(d) for d in (129, 160, 192, 255, 256)] == [256] * 5
    assert [fa.head_width(d) for d in (257, 300, 320, 384, 511, 512, 1024, 4100)] == [
        264, 304, 320, 384, 512, 512, 1024, 4104]
    for d in (0, -3):
        with pytest.raises(ValueError, match="any head_dim from 1"):
            fa.head_width(d)


@pytest.mark.parametrize("d", [32, 48, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_padding_route_matches_pallas_interpret_at_the_real_head_dim(d, causal):
    """The launch functions' route for a head dim the kernels are not
    compiled for: the operands zero-padded to the next compiled width, the
    kernel (here its plain version) run there with the real D's scale, the
    outputs sliced back. O, lse, dq, dk, dv against the JAX package's
    Pallas kernels at the real D, in interpret mode."""
    bh, length = B * H, 192
    rng = np.random.default_rng(d)
    q, k, v, do = (rng.standard_normal((bh, length, d)).astype(np.float32) for _ in range(4))
    seg = _segments(B, length, ((0, 70), (70, 161)))
    scale = 1 / math.sqrt(d)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jseg = jnp.asarray(np.repeat(seg, H, axis=0))
    jo, jlse = _jax_flash_fwd(jq, jk, jv, jseg, scale, causal, 64, 64, True)
    jdq, jdk, jdv = _jax_flash_bwd(jq, jk, jv, jseg, jdo, jo, jlse, scale, causal, 64, 64, True)

    tq, tk, tv, tdo, tseg = _t(q), _t(k), _t(v), _t(do), _t(seg)
    o, lse = fa.padded_fwd(fa.flash_fwd_plain, tq, tk, tv, tseg, scale, causal, H)
    assert o.shape == (bh, length, d)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, 0], atol=2e-5)
    delta = (tdo * o).sum(-1)  # over the real D, as the autograd function takes it
    bwd = (tseg, tdo, lse, delta, scale, causal, H)
    dq = fa.padded_bwd_dq(fa.flash_bwd_dq_plain, tq, tk, tv, *bwd)
    dk, dv = fa.padded_bwd_dkv(fa.flash_bwd_dkv_plain, tq, tk, tv, *bwd)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.shape == (bh, length, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("d", [160, 192, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("route", ["plain", "padded"])
def test_wide_head_dims_match_pallas_interpret_at_a_ragged_length(route, causal, d):
    """Head dims above 128 at a ragged L = 200 with packed segments and a
    padded tail: the plain versions at the real D (the CPU path) and the
    padding route to the D = 256 kernels' width (their plain versions
    there; D = 256 pads nothing) against the JAX package's Pallas kernels
    at the real D in interpret mode (blocks of 40, which tile 200). O,
    lse, dq, dk and dv within 2e-5."""
    bh, length = B * H, 200
    rng = np.random.default_rng(d + causal)
    q, k, v, do = (rng.standard_normal((bh, length, d)).astype(np.float32) for _ in range(4))
    seg = _segments(B, length, ((0, 70), (70, 133), (133, 181)))
    scale = 1 / math.sqrt(d)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jseg = jnp.asarray(np.repeat(seg, H, axis=0))
    jo, jlse = _jax_flash_fwd(jq, jk, jv, jseg, scale, causal, 40, 40, True)
    jdq, jdk, jdv = _jax_flash_bwd(jq, jk, jv, jseg, jdo, jo, jlse, scale, causal, 40, 40, True)

    tq, tk, tv, tdo, tseg = _t(q), _t(k), _t(v), _t(do), _t(seg)
    if route == "plain":
        fwd, bwd_dq, bwd_dkv = fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv
    else:
        fwd = lambda *a: fa.padded_fwd(fa.flash_fwd_plain, *a)  # noqa: E731
        bwd_dq = lambda *a: fa.padded_bwd_dq(fa.flash_bwd_dq_plain, *a)  # noqa: E731
        bwd_dkv = lambda *a: fa.padded_bwd_dkv(fa.flash_bwd_dkv_plain, *a)  # noqa: E731
    o, lse = fwd(tq, tk, tv, tseg, scale, causal, H)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, 0], atol=2e-5, rtol=0)
    bwd = (tseg, tdo, lse, (tdo * o).sum(-1), scale, causal, H)
    dq = bwd_dq(tq, tk, tv, *bwd)
    dk, dv = bwd_dkv(tq, tk, tv, *bwd)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        assert got.shape == (bh, length, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0, err_msg=name)


def test_ring_at_head_dim_192_matches_whole_sequence_plain_attention(monkeypatch):
    """``ring_attention_local`` on 4 members at D = 192, each member's
    operands padded once to the D = 256 kernels' width as on the card
    (``widen_heads``; their plain versions here), causal with packed
    segments: O, dq, dk and dv against the port's dense ``plain_attention``
    over the whole sequence within 2e-5."""
    from tensorflowonspark_tpu_torch.parallel.ring_attention import ring_attention_local

    d = 192
    rng = np.random.default_rng(19)
    q, k, v, do = (rng.standard_normal((B, H, 96, d)).astype(np.float32) for _ in range(4))
    seg = _t(_segments(B, 96, ((0, 30), (30, 71), (71, 90))))

    def run(fn):
        tq, tk, tv = (_t(x, requires_grad=True) for x in (q, k, v))
        o = fn(tq, tk, tv)
        o.backward(_t(do))
        return o.detach(), tq.grad, tk.grad, tv.grad

    want = run(lambda *t: plain_attention(*t, causal=True, segment_ids=seg))
    widths = []
    monkeypatch.setattr(fa, "widen_heads", lambda t: widths.append(fa.head_width(t.shape[-1]))
                        or fa._widen(t, fa.head_width(t.shape[-1])))
    got = run(lambda *t: ring_attention_local(*t, 4, causal=True, segment_ids=seg))
    assert set(widths) == {256}
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("d", [32, 96])
@pytest.mark.parametrize("ring", [False, True], ids=["flash", "ring"])
def test_autograd_and_ring_pad_each_operand_once(monkeypatch, d, ring):
    """The card's route through the autograd function and the ring's
    members: q, k, v and dO padded to the compiled width once (not once a
    kernel), every kernel launched there, the outputs cut back. Here the
    CPU takes it (``widen_heads`` pads) and matches the unpadded run: O,
    dq, dk, dv within 1e-5; the autograd function pads 4 operands a step."""
    from tensorflowonspark_tpu_torch.parallel.ring_attention import ring_attention_local

    rng = np.random.default_rng(d)
    q, k, v, do = (rng.standard_normal((B, H, 64, d)).astype(np.float32) for _ in range(4))
    seg = _t(_segments(B, 64, ((0, 20), (20, 57))))

    def run():
        tq, tk, tv = (_t(x, requires_grad=True) for x in (q, k, v))
        if ring:
            o = ring_attention_local(tq, tk, tv, 4, causal=True, segment_ids=seg)
        else:
            o = fa.flash_attention(tq, tk, tv, causal=True, segment_ids=seg)
        o.backward(_t(do))
        return o.detach(), tq.grad, tk.grad, tv.grad

    want = run()
    pads, widths = [], []
    monkeypatch.setattr(fa, "widen_heads", lambda t: pads.append(t.shape) or fa._widen(t, fa.head_width(d)))
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        monkeypatch.setattr(fa, name, lambda q, *a, _real=getattr(fa, name), **kw:
                            widths.append(q.shape[-1]) or _real(q, *a, **kw))
    got = run()
    assert set(widths) == {fa.head_width(d)} and len(widths) >= 3
    if not ring:
        assert len(pads) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0)


def _padded_wrappers(monkeypatch):
    """Make the CPU wrappers take the padding route the card takes (the
    plain versions at the compiled width), so a whole model runs it."""
    monkeypatch.setattr(fa, "flash_fwd", lambda *a, **kw: fa.padded_fwd(fa.flash_fwd_plain, *a, **kw))
    monkeypatch.setattr(fa, "flash_bwd_dq", lambda *a, **kw: fa.padded_bwd_dq(fa.flash_bwd_dq_plain, *a, **kw))
    monkeypatch.setattr(fa, "flash_bwd_dkv",
                        lambda *a, **kw: fa.padded_bwd_dkv(fa.flash_bwd_dkv_plain, *a, **kw))


def test_lm_at_the_examples_defaults_matches_the_jax_package(monkeypatch):
    """The transformer example's own defaults (d_model 256, 8 heads of 32,
    2 layers, d_ff 1024, vocab 1024, 256 tokens, batch 8) with
    ``attention="flash"`` through the padding route, on weights converted
    from the JAX model: the loss within 1e-5 and every gradient within
    1e-5 of the JAX package's (its flash kernels in interpret mode)."""
    from tensorflowonspark_tpu.models import transformer as jtransformer
    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.examples.transformer import transformer_spark
    from tensorflowonspark_tpu_torch.models import transformer

    args = transformer_spark.build_parser().parse_args([])
    cfg = dict(vocab_size=args.vocab_size, d_model=args.d_model, n_layers=args.n_layers, n_heads=args.n_heads,
               d_ff=args.d_ff, max_seq_len=args.seq_len, attention="flash", dtype="float32")
    assert cfg["d_model"] // cfg["n_heads"] == 32 and args.batch_size == 8 and args.seq_len == 256
    jmodel = jtransformer.create_model(**cfg)
    params = jax.jit(jtransformer.make_init_fn(jmodel, sample_len=16))(jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(lambda a: np.array(a), jax.device_get(params))
    rng = np.random.default_rng(16)
    tokens = rng.integers(1, args.vocab_size, (args.batch_size, args.seq_len + 1)).astype(np.int32)
    seg = np.ones_like(tokens)
    seg[:, 100:] = 2
    seg[:, 240:] = 0
    pos = np.where(seg == 2, np.arange(tokens.shape[1]) - 100, np.arange(tokens.shape[1])).astype(np.int32)
    batch = {"tokens": tokens, "segment_ids": seg, "positions": pos}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jtransformer.make_loss_fn(jmodel), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = convert.convert_variables({"params": jax.tree.map(np.asarray, jgrads)})

    _padded_wrappers(monkeypatch)
    model = convert.load_variables(transformer.create_model(**cfg), {"params": params})
    loss, _ = transformer.make_loss_fn(model)(model, {k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5, rtol=0)
    grads = dict(model.named_parameters())
    assert set(grads) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(grads[name].grad.numpy(), g.numpy(), atol=1e-5, rtol=0, err_msg=name)


def test_lm_at_head_dim_256_matches_the_jax_package():
    """The port's transformer at ``d_model 256, n_heads 1`` (head dim 256,
    the D = 256 kernels' own width: nothing padded), 2 layers, with
    ``attention="flash"`` (the kernels' plain versions on the CPU) on
    weights converted from the JAX model: the loss within 1e-5 and every
    gradient within 1e-5 of the JAX package's (its flash kernels in
    interpret mode), on a packed batch."""
    from tensorflowonspark_tpu.models import transformer as jtransformer
    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.models import transformer

    cfg = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=1, d_ff=512, max_seq_len=128,
               attention="flash", dtype="float32")
    jmodel = jtransformer.create_model(**cfg)
    params = jax.jit(jtransformer.make_init_fn(jmodel, sample_len=16))(jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(lambda a: np.array(a), jax.device_get(params))
    rng = np.random.default_rng(17)
    tokens = rng.integers(1, cfg["vocab_size"], (4, 129)).astype(np.int32)
    seg = np.ones_like(tokens)
    seg[:, 50:] = 2
    seg[:, 120:] = 0
    pos = np.where(seg == 2, np.arange(tokens.shape[1]) - 50, np.arange(tokens.shape[1])).astype(np.int32)
    batch = {"tokens": tokens, "segment_ids": seg, "positions": pos}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jtransformer.make_loss_fn(jmodel), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = convert.convert_variables({"params": jax.tree.map(np.asarray, jgrads)})

    model = convert.load_variables(transformer.create_model(**cfg), {"params": params})
    assert model.cfg.head_dim == 256 and fa.head_width(model.cfg.head_dim) == 256
    loss, _ = transformer.make_loss_fn(model)(model, {k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5, rtol=0)
    grads = dict(model.named_parameters())
    assert set(grads) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(grads[name].grad.numpy(), g.numpy(), atol=1e-5, rtol=0, err_msg=name)


# -- head dims above 256: the split-D kernels -----------------------------------


def _wide_case(d, causal, length=200, block=40):
    """``[BH, L, D]`` operands and dO at head dim ``d`` with packed segments
    and a padded tail at a ragged L, and the JAX package's Pallas kernels'
    O, lse, dq, dk, dv on them at the real D in interpret mode (blocks of
    ``block``, which tile L); fresh tensors each call."""
    (q, k, v, do, seg, scale), want = _wide_case_arrays(d, causal, length, block)
    return (_t(q), _t(k), _t(v), _t(do), _t(seg), scale), want


@functools.lru_cache(maxsize=None)
def _wide_case_arrays(d, causal, length, block):
    """:func:`_wide_case`'s inputs and the JAX package's outputs as numpy
    arrays, computed once a configuration (both routes share them)."""
    bh = B * H
    rng = np.random.default_rng(d + causal)
    q, k, v, do = (rng.standard_normal((bh, length, d)).astype(np.float32) for _ in range(4))
    seg = _segments(B, length, ((0, 70), (70, 133), (133, 181)))
    scale = 1 / math.sqrt(d)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jseg = jnp.asarray(np.repeat(seg, H, axis=0))
    jo, jlse = _jax_flash_fwd(jq, jk, jv, jseg, scale, causal, block, block, True)
    jdq, jdk, jdv = _jax_flash_bwd(jq, jk, jv, jseg, jdo, jo, jlse, scale, causal, block, block, True)
    want = {"o": np.asarray(jo), "lse": np.asarray(jlse)[:, :, 0], "dq": np.asarray(jdq), "dk": np.asarray(jdk),
            "dv": np.asarray(jdv)}
    return (q, k, v, do, seg, scale), want


@pytest.mark.parametrize("d", [300, 320, 384, 512])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("route", ["split", "padded"])
def test_split_head_dims_match_pallas_interpret_at_a_ragged_length(route, causal, d):
    """Head dims above 256 at a ragged L = 200 with packed segments and a
    padded tail: the split-D kernels' plain mirrors (scores summed over
    64-column panels, each 256-column chunk of the outputs by itself, in
    the kernels' order) at the real D, and through the padding route to
    the split-D width (D = 300 runs at 304; 320, 384 and 512 pad nothing),
    against the JAX package's Pallas kernels at the real D in interpret
    mode (blocks of 40). O and lse within 2e-5, dq, dk and dv within
    1e-4."""
    (tq, tk, tv, tdo, tseg, scale), want = _wide_case(d, causal)
    fwd, bwd_dq, bwd_dkv = fa.flash_fwd_split_plain, fa.flash_bwd_dq_split_plain, fa.flash_bwd_dkv_split_plain
    if route == "padded":
        assert fa.head_width(d) == (304 if d == 300 else d)
        fwd = lambda *a: fa.padded_fwd(  # noqa: E731
            lambda *b: fa.flash_fwd_split_plain(*b[:7], seg_k=b[7]), *a)
        bwd_dq = lambda *a: fa.padded_bwd_dq(fa.flash_bwd_dq_split_plain, *a)  # noqa: E731
        bwd_dkv = lambda *a: fa.padded_bwd_dkv(fa.flash_bwd_dkv_split_plain, *a)  # noqa: E731
    o, lse = fwd(tq, tk, tv, tseg, scale, causal, H)
    assert o.shape == tq.shape
    np.testing.assert_allclose(o.numpy(), want["o"], atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want["lse"], atol=2e-5, rtol=0)
    bwd = (tseg, tdo, lse, (tdo * o).sum(-1), scale, causal, H)
    dq = bwd_dq(tq, tk, tv, *bwd)
    dk, dv = bwd_dkv(tq, tk, tv, *bwd)
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        assert got.shape == tq.shape
        np.testing.assert_allclose(got.numpy(), want[name], atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("d", [320, 512])
def test_split_mirror_matches_the_online_forward_and_the_dense_backward(d):
    """The split-D mirrors against the one-chunk kernels' plain versions on
    the same inputs: the forward against ``flash_fwd_online_plain`` (the
    same online softmax; only the panel order of the score sums differs),
    the backward against the dense ``flash_bwd_*_plain``, within 2e-5 (f32:
    in bf16 the order of the score sums can move p across a rounding
    boundary)."""
    (tq, tk, tv, tdo, tseg, scale), _ = _wide_case(d, True, length=130, block=65)
    o, lse = fa.flash_fwd_split_plain(tq, tk, tv, tseg, scale, True, H)
    wo, wlse = fa.flash_fwd_online_plain(tq, tk, tv, tseg, scale, True, H)
    np.testing.assert_allclose(o.numpy(), wo.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), wlse.numpy(), atol=2e-5, rtol=0)
    bwd = (tseg, tdo, lse, (tdo.float() * o).sum(-1), scale, True, H)
    f32 = dict(out_dtype=torch.float32)
    np.testing.assert_allclose(fa.flash_bwd_dq_split_plain(tq, tk, tv, *bwd, **f32).numpy(),
                               fa.flash_bwd_dq_plain(tq, tk, tv, *bwd, **f32).numpy(), atol=2e-5, rtol=0)
    for got, want in zip(fa.flash_bwd_dkv_split_plain(tq, tk, tv, *bwd, **f32),
                         fa.flash_bwd_dkv_plain(tq, tk, tv, *bwd, **f32)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)
