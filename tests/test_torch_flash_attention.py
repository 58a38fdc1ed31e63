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
    assert fa.launch_counts() == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


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
