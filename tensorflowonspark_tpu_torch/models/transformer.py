"""Decoder-only transformer LM as ``nn.Module``s — the port of the JAX
package's ``models/transformer.py``.

Same architecture, names and numerics contract as the flax version:
pre-norm blocks (RMSNorm, eps 1e-6, reduced in f32) of multi-head causal
attention with rotary positions (the two halves rotated, angles in f32
from the per-segment ``positions`` of a packed batch) and a tanh-GELU MLP;
compute in ``dtype`` with float32 parameters (each op casts its weights);
logits cast to f32 for the loss. Submodule names follow flax's (``embed``,
``layer_{i}.{ln1,attn.{q,k,v,o},ln2,mlp.{wi,wo}}``, ``ln_f``, ``lm_head``),
so :mod:`~tensorflowonspark_tpu_torch.convert` maps the JAX package's
variables name for name.

Attention goes through :func:`_dispatch_attention`: ``flash`` runs the
port's CUDA kernels (:mod:`~tensorflowonspark_tpu_torch.ops.flash_attention`;
their plain versions on a CPU tensor), ``plain`` the dense reference, and
``auto`` the kernels on a CUDA tensor and the dense reference on the CPU.
Mixture of experts, ring attention, tensor
parallelism (``param_specs``) and rematerialization come with the
model-axes slice and raise here.
"""

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch.models import register
from tensorflowonspark_tpu_torch.parallel.ring_attention import plain_attention

#: lecun_normal's truncated-normal correction: the std of a unit normal
#: truncated to [-2, 2] (flax/jax ``variance_scaling`` constant)
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 6
    n_heads: int = 8
    d_ff: int = 2048
    max_seq_len: int = 2048
    dtype: str = "float32"  # compute dtype; params stay float32
    remat: bool = False  # not yet ported
    #: "auto" — the flash kernels on a CUDA tensor, plain attention on
    #: the CPU; or force "flash"/"plain"
    attention: str = "auto"
    #: >0: mixture-of-experts MLPs (not yet ported)
    moe_experts: int = 0

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def compute_dtype(self):
        return getattr(torch, self.dtype)


def _rope(x, positions, base=10000.0):
    """Rotary position embedding over the last (head) dim; x: [B, L, H, D]."""
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[:, :, None].float() * freqs  # [B, L, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


_ATTENTION_IMPLS = ("auto", "flash", "plain", "ring")


def _dispatch_attention(q, k, v, impl, segment_ids=None):
    """Pick the attention path over ``[B, H, L, D]`` tensors, causal.
    ``plain``: the dense reference; ``flash``: the flash kernels (their
    plain versions on a CPU tensor); ``auto``: the kernels on a CUDA tensor
    at every length, plain on the CPU; ``ring`` is not yet ported. The kernels mask ragged sequence tails, so no
    padding is needed (the JAX package pads to a multiple of 128).

    ``segment_ids`` (``int [B, L]``, 0 = padding) fences packed sequences
    block-diagonally on every path."""
    if impl not in _ATTENTION_IMPLS:
        raise ValueError(
            "unknown attention impl {!r}; expected one of {}".format(impl, _ATTENTION_IMPLS)
        )
    if impl == "ring":
        raise NotImplementedError(
            "attention='ring' (sequence parallelism) is not yet ported to "
            "tensorflowonspark_tpu_torch; it comes with the model-axes slice"
        )
    use_flash = impl == "flash" or (impl == "auto" and q.device.type == "cuda")
    if not use_flash:
        return plain_attention(q, k, v, causal=True, segment_ids=segment_ids)
    from tensorflowonspark_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(q, k, v, causal=True, segment_ids=segment_ids)


def _trunc_normal_(w, fan_in, generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Module):
    """``flax.linen.Dense(use_bias=False)`` / ``DenseGeneral``: ``weight``
    ``[out, in]`` in float32, the product in ``dtype``. ``fan_in`` is the
    flax kernel's contracted size (its lecun-normal scale)."""

    def __init__(self, in_features, out_features, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))

    def reset_parameters(self, generator=None):
        _trunc_normal_(self.weight, self.weight.shape[1], generator)


class RMSNorm(nn.Module):
    """``flax.linen.RMSNorm(dtype)``: eps 1e-6, mean square and scale in
    f32, the output in the compute dtype."""

    def __init__(self, features, dtype=torch.float32, eps=1e-6):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.weight = nn.Parameter(torch.ones(features))

    def forward(self, x):
        xf = x.float()
        inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (xf * (inv * self.weight)).to(self.dtype)

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.weight)


class Attention(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        dt, width = cfg.compute_dtype, cfg.n_heads * cfg.head_dim
        self.q = Dense(cfg.d_model, width, dt)
        self.k = Dense(cfg.d_model, width, dt)
        self.v = Dense(cfg.d_model, width, dt)
        self.o = Dense(width, cfg.d_model, dt)

    def forward(self, x, positions, segment_ids=None):
        cfg = self.cfg
        b, length, _ = x.shape
        heads = lambda t: t.view(b, length, cfg.n_heads, cfg.head_dim)  # noqa: E731
        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))  # [B, L, H, D]
        q = _rope(q, positions)
        k = _rope(k, positions)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, L, D]
        out = _dispatch_attention(q, k, v, cfg.attention, segment_ids=segment_ids)
        return self.o(out.transpose(1, 2).reshape(b, length, -1))


class Mlp(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dt = cfg.compute_dtype
        self.wi = Dense(cfg.d_model, cfg.d_ff, dt)
        self.wo = Dense(cfg.d_ff, cfg.d_model, dt)

    def forward(self, x):
        return self.wo(F.gelu(self.wi(x), approximate="tanh"))  # flax nn.gelu: tanh form


class Block(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.compute_dtype)
        self.attn = Attention(cfg)
        self.ln2 = RMSNorm(cfg.d_model, cfg.compute_dtype)
        self.mlp = Mlp(cfg)

    def forward(self, x, positions, segment_ids=None):
        x = x + self.attn(self.ln1(x), positions, segment_ids)
        return x + self.mlp(self.ln2(x))


class Transformer(nn.Module):
    """Parameters are initialised as flax initialises them (lecun-normal
    Dense kernels, ``embed`` normal with std ``1/sqrt(d_model)``, RMSNorm
    scales 1), drawn from ``generator`` when one is given."""

    def __init__(self, cfg, generator=None):
        super().__init__()
        if cfg.moe_experts > 0:
            raise NotImplementedError(
                "moe_experts > 0 (mixture of experts) is not yet ported to "
                "tensorflowonspark_tpu_torch; it comes with the model-axes slice"
            )
        if cfg.remat:
            raise NotImplementedError(
                "remat is not yet ported to tensorflowonspark_tpu_torch"
            )
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        for i in range(cfg.n_layers):
            self.add_module("layer_{}".format(i), Block(cfg))
        self.ln_f = RMSNorm(cfg.d_model, cfg.compute_dtype)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.compute_dtype)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """flax's initialisers, drawn from ``generator``."""
        with torch.no_grad():
            self.embed.weight.normal_(0.0, math.sqrt(1.0 / self.cfg.d_model), generator=generator)
            for m in self.modules():
                if isinstance(m, (Dense, RMSNorm)):
                    m.reset_parameters(generator)

    def forward(self, tokens, positions=None, segment_ids=None):
        cfg = self.cfg
        x = F.embedding(tokens, self.embed.weight).to(cfg.compute_dtype)
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :].expand(tokens.shape)
        for i in range(cfg.n_layers):
            x = getattr(self, "layer_{}".format(i))(x, positions, segment_ids)
        return self.lm_head(self.ln_f(x)).float()


def param_specs(*args, **kwargs):
    raise NotImplementedError(
        "param_specs (tensor-parallel placement) is not yet ported to "
        "tensorflowonspark_tpu_torch; SyncDataParallel replicates the model"
    )


@register("transformer")
def create_model(mesh=None, generator=None, **cfg):
    """``Transformer(TransformerConfig(**cfg))``; ``mesh`` must be None
    (model axes are not yet ported)."""
    if mesh is not None:
        raise NotImplementedError("a model mesh is not yet ported to tensorflowonspark_tpu_torch")
    return Transformer(TransformerConfig(**cfg), generator=generator)


def make_init_fn(model):
    """``init(generator) -> model`` with its parameters drawn afresh from
    the ``torch.Generator`` (the JAX version's ``init(rng) -> variables``)."""

    def init(generator=None):
        model.reset_parameters(generator)
        return model

    return init


def make_loss_fn(model):
    """Next-token LM loss for ``SyncDataParallel.compile_train_step(...,
    has_aux=True)``: ``loss_fn(module, batch) -> (loss, {"perplexity"})``;
    batch = ``{"tokens": int [B, L]}`` (optionally with ``{"mask": [B, L]}``).

    Packed batches from the text plane also carry ``segment_ids`` and
    ``positions`` (``int [B, L]``): segments fence attention
    block-diagonally, per-segment positions keep the rotary phase local,
    and the loss drops targets that cross a pack boundary or fall in
    padding."""
    del model  # the module arrives with each call

    def loss_fn(module, batch):
        tokens = batch["tokens"]
        seg = batch.get("segment_ids")
        pos = batch.get("positions")
        logits = module(
            tokens[:, :-1],
            positions=None if pos is None else pos[:, :-1],
            segment_ids=None if seg is None else seg[:, :-1],
        )
        targets = tokens[:, 1:].long()
        losses = F.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), targets.reshape(-1), reduction="none"
        ).view(targets.shape)
        mask = batch.get("mask")
        mask = None if mask is None else mask[:, 1:].to(losses.dtype)
        if seg is not None:
            # a target is valid when its position and the one it is predicted
            # from share a real (non-pad) segment
            seg_mask = ((seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] > 0)).to(losses.dtype)
            mask = seg_mask if mask is None else mask * seg_mask
        if mask is not None:
            loss = (losses * mask).sum() / torch.clamp_min(mask.sum(), 1)
        else:
            loss = losses.mean()
        return loss, {"perplexity": torch.exp(loss.detach())}

    return loss_fn
