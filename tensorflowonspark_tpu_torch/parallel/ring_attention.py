"""Attention reference of the port — the JAX package's
``parallel/ring_attention.py`` reduced to its single-device oracle.

:func:`plain_attention` is the dense attention the flash kernels and the
transformer's ``attention="plain"`` path are held against. Ring attention
(the sequence sharded over an ``sp`` mesh axis, K/V rotated between
devices) comes with the model-axes slice; its entry points raise here.
"""

import math

import torch

#: finite stand-in for -inf, the same sentinel as the JAX package's: a fully
#: masked row gives finite garbage instead of NaN
NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)


def plain_attention(q, k, v, causal=False, scale=None, segment_ids=None):
    """Reference single-device attention over ``[B, H, L, D]`` tensors: f32
    scores, the causal mask and the packed-sequence fence (``segment_ids``
    ``int [B, L]``, 0 = padding) as the finite sentinel, softmax in f32,
    the result cast back to ``q``'s dtype."""
    head_dim = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    if causal:
        l_q, l_k = q.shape[2], k.shape[2]
        mask = (torch.arange(l_q, device=q.device)[:, None]
                >= torch.arange(l_k, device=q.device)[None, :])
        scores = torch.where(mask[None, None], scores, NEG_BIG)
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32)
        scores = torch.where(seg[:, None, :, None] == seg[:, None, None, :], scores, NEG_BIG)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _unported(name):
    raise NotImplementedError(
        "{} (sequence parallelism over an sp mesh axis) is not yet ported to "
        "tensorflowonspark_tpu_torch; it comes with the model-axes slice".format(name)
    )


def ring_attention(*args, **kwargs):
    _unported("ring_attention")


def ring_attention_sharded(*args, **kwargs):
    _unported("ring_attention_sharded")
