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
their plain versions on a CPU tensor; any head dim), ``plain`` the
dense reference, ``ring`` ring attention over the mesh's ``sp`` axis
(:mod:`~tensorflowonspark_tpu_torch.parallel.ring_attention`; the flash
call without one), and ``auto`` the ring on an ``sp`` mesh, else the
kernels on a CUDA tensor and the dense reference on the CPU. ``plain`` and
``flash`` on an ``sp`` mesh attend over the whole sequence, gathered.

``moe_experts > 0`` swaps every block's MLP for :class:`MoeMlp`, the JAX
package's switch-routed mixture of experts; ``remat`` recomputes each
block's activations in the backward (``torch.utils.checkpoint``).

On a mesh (``create_model(mesh=...)``) the model is built from this rank's
blocks of the parameters that :func:`param_specs` places on a model axis:
the JAX package's rules, where ``tp`` splits attention heads, the MLP's
hidden dim, the vocabulary of ``lm_head`` and the experts' hidden dim, and
``ep`` the experts. Each split layer runs its part and joins the others
through the gradient-carrying collectives of
:mod:`~tensorflowonspark_tpu_torch.parallel.collectives` (Megatron-LM's
column- and row-parallel pairs); a dim that the rule drops leaves its layer
whole, with no collective. The JAX model constrains its activations'
sharding (``Transformer._constrain``) for XLA; here a rank holds the
activations of its rows whole, except along ``sp``: on a mesh with an
``sp`` axis each rank holds its block of the sequence (``L / sp`` tokens,
``parallel.sharding.sequence_chunk``) through the embedding, the norms and
the MLP, and attention is the ring over the ``sp`` group (or, with
``plain``/``flash``, the whole sequence gathered over it). The default
positions are then the block's global ones, and :func:`make_loss_fn` gives
the JAX loss: the mean over the real tokens of the rows that the ``sp``
group holds (each rank's gradient is its tokens' share of it, which the
strategy sums over ``sp``). A mixture of experts routes a rank's block on
its own when ``moe_group_size`` divides the block and each block's real
tokens, and otherwise routes the whole sequence, gathered (:class:`MoeMlp`).
"""

import dataclasses
import math
import re

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
    remat: bool = False  # checkpoint each block: FLOPs for memory
    #: "auto" — the flash kernels on a CUDA tensor, plain attention on
    #: the CPU; or force "flash"/"plain"
    attention: str = "auto"
    #: >0 switches every block's MLP to a switch-routed mixture of experts,
    #: split over the mesh's ``ep`` axis (expert parallelism)
    moe_experts: int = 0
    #: per-expert capacity per token group = factor * group_size / experts
    moe_capacity_factor: float = 1.25
    #: weight of the router load-balancing auxiliary loss
    moe_aux_weight: float = 0.01
    #: dispatch group size (GShard-style): the dispatch and combine masks
    #: grow as factor * tokens * group_size, linear in the tokens; shrunk
    #: to a divisor of a rank's token count
    moe_group_size: int = 256

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


def _dispatch_attention(q, k, v, impl, segment_ids=None, sp_group=None):
    """Pick the attention path over ``[B, H, L, D]`` tensors, causal.
    ``plain``: the dense reference; ``flash``: the flash kernels (their
    plain versions on a CPU tensor); ``ring``: ring attention over
    ``sp_group`` (the model's ``sp`` group; None, a ring of one: the flash
    call); ``auto``: the ring when the sequence is split over ``sp``, else
    the kernels on a CUDA tensor at every length and plain on the CPU. The
    kernels mask ragged sequence tails, so no padding is needed (the JAX
    package pads to a multiple of 128).

    With the sequence split over ``sp``, ``plain`` and ``flash`` attend
    over the whole sequence, as the JAX package's do there: ``q``, ``k``,
    ``v`` and the ids are gathered over the group along the sequence, every
    rank attends the whole of it, and keeps its own block of the output
    (``gather_from_region`` / ``split_to_region``: the backward hands each
    rank the whole output's gradient and keeps its block of dq, dk, dv).
    The last block's padding (``sharding.sequence_chunk``: token 0,
    segment 0) lies at the end of the gathered sequence, where the causal
    mask and the fence keep it from every real query, as the JAX package's
    pad-run-slice does.

    ``segment_ids`` (``int [B, L]``, 0 = padding) fences packed sequences
    block-diagonally on every path."""
    if impl not in _ATTENTION_IMPLS:
        raise ValueError(
            "unknown attention impl {!r}; expected one of {}".format(impl, _ATTENTION_IMPLS)
        )
    if impl == "ring" or (impl == "auto" and sp_group is not None):
        from tensorflowonspark_tpu_torch.parallel.ring_attention import ring_attention

        return ring_attention(q, k, v, sp_group, causal=True, segment_ids=segment_ids)
    if sp_group is not None:
        from tensorflowonspark_tpu_torch.parallel import collectives

        whole = [collectives.gather_from_region(t, sp_group, 2) for t in (q, k, v)]
        ids = None
        if segment_ids is not None:
            ids = collectives.gather_blocks(segment_ids, sp_group).movedim(0, 1).flatten(1, 2)
        out = _dispatch_attention(*whole, impl, segment_ids=ids)
        return collectives.split_to_region(out, sp_group, 2)
    use_flash = impl == "flash" or (impl == "auto" and q.device.type == "cuda")
    if not use_flash:
        return plain_attention(q, k, v, causal=True, segment_ids=segment_ids)
    from tensorflowonspark_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(q, k, v, causal=True, segment_ids=segment_ids)


def _trunc_normal_(w, fan_in, generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class _Blocks:
    """Where a model built on a mesh cuts its parameters: for each name,
    the model-axis entries of its spec (:func:`param_specs`). Without a
    mesh every parameter is whole."""

    def __init__(self, mesh=None, specs=None):
        self.mesh, self.specs = mesh, specs or {}
        #: the ``sp`` group when the mesh splits the sequence (more than one
        #: member), else None, and this rank's block index along it
        self.sp_group, self.sp_rank = None, 0
        if mesh is not None and "sp" in mesh.mesh_dim_names:
            from tensorflowonspark_tpu_torch.parallel import collectives

            if collectives.axis_size("sp", mesh) > 1:
                from tensorflowonspark_tpu_torch.parallel.sharding import sequence_shard

                self.sp_group = collectives.axes_group(mesh, "sp")
                self.sp_rank = sequence_shard(mesh)[0]

    def cut(self, name):
        """``((port dim, parts, index), ...)``: this rank's block of
        parameter ``name``."""
        from tensorflowonspark_tpu_torch.parallel import collectives

        return tuple((d, collectives.axis_size(a, self.mesh), collectives.axis_index(a, self.mesh))
                     for d, a in enumerate(self.specs.get(name, ())) if a)

    def group(self, *names):
        """The process group over the model axes that cut any of ``names``
        (in the mesh's order), or None when none does."""
        from tensorflowonspark_tpu_torch.parallel import collectives

        axes = {a for n in names for a in self.specs.get(n, ()) if a}
        if not axes:
            return None
        return collectives.axes_group(self.mesh, tuple(a for a in self.mesh.mesh_dim_names if a in axes))


def _block_of(full, cut):
    for d, parts, index in cut:
        full = full.chunk(parts, d)[index]
    return full


def _draw_(param, full_shape, cut, draw):
    """Fill ``param`` with its block of a full tensor that ``draw`` fills
    (so a model on a mesh draws the numbers the whole model draws)."""
    full = torch.empty(full_shape, device=param.device)
    draw(full)
    param.copy_(_block_of(full, cut))


class Dense(nn.Module):
    """``flax.linen.Dense(use_bias=False)`` / ``DenseGeneral``: ``weight``
    ``[out, in]`` in float32, the product in ``dtype``. ``cut`` takes this
    rank's block of the ``[out, in]`` weight (``((dim, parts, index),
    ...)``); the lecun-normal scale is the whole kernel's fan-in."""

    def __init__(self, in_features, out_features, dtype=torch.float32, cut=()):
        super().__init__()
        self.dtype, self.cut = dtype, cut
        self.full_shape = (out_features, in_features)
        self.weight = nn.Parameter(torch.empty(_block_of(torch.empty(self.full_shape, device="meta"), cut).shape))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        _draw_(self.weight, self.full_shape, self.cut,
               lambda w: _trunc_normal_(w, self.full_shape[1], generator))


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


def _open(x, group):
    if group is None:
        return x
    from tensorflowonspark_tpu_torch.parallel.collectives import copy_to_region

    return copy_to_region(x, group)


def _close(x, group):
    if group is None:
        return x
    from tensorflowonspark_tpu_torch.parallel.collectives import reduce_from_region

    return reduce_from_region(x, group)


class Attention(nn.Module):
    """Causal self-attention. Split over ``tp`` (the heads), ``q``/``k``/
    ``v`` are column-parallel and ``o`` row-parallel: the input enters the
    region by ``copy_to_region``, each rank attends with its heads, and
    ``o``'s partial products leave it by ``reduce_from_region``."""

    def __init__(self, cfg, blocks=None, prefix=""):
        super().__init__()
        blocks = blocks or _Blocks()
        self.cfg = cfg
        dt, width = cfg.compute_dtype, cfg.n_heads * cfg.head_dim
        self.q = Dense(cfg.d_model, width, dt, blocks.cut(prefix + "q.weight"))
        self.k = Dense(cfg.d_model, width, dt, blocks.cut(prefix + "k.weight"))
        self.v = Dense(cfg.d_model, width, dt, blocks.cut(prefix + "v.weight"))
        self.o = Dense(width, cfg.d_model, dt, blocks.cut(prefix + "o.weight"))
        self.heads = self.q.weight.shape[0] // cfg.head_dim
        self.group = blocks.group(*(prefix + n + ".weight" for n in "qkvo"))
        self.sp_group = blocks.sp_group

    def forward(self, x, positions, segment_ids=None):
        cfg = self.cfg
        b, length, _ = x.shape
        x = _open(x, self.group)
        heads = lambda t: t.view(b, length, self.heads, cfg.head_dim)  # noqa: E731
        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))  # [B, L, H, D]
        q = _rope(q, positions)
        k = _rope(k, positions)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, L, D]
        out = _dispatch_attention(q, k, v, cfg.attention, segment_ids=segment_ids, sp_group=self.sp_group)
        return _close(self.o(out.transpose(1, 2).reshape(b, length, -1)), self.group)


class Mlp(nn.Module):
    """tanh-GELU MLP. Split over ``tp`` (the hidden dim), ``wi`` is
    column-parallel and ``wo`` row-parallel."""

    def __init__(self, cfg, blocks=None, prefix=""):
        super().__init__()
        blocks = blocks or _Blocks()
        dt = cfg.compute_dtype
        self.wi = Dense(cfg.d_model, cfg.d_ff, dt, blocks.cut(prefix + "wi.weight"))
        self.wo = Dense(cfg.d_ff, cfg.d_model, dt, blocks.cut(prefix + "wo.weight"))
        self.group = blocks.group(prefix + "wi.weight", prefix + "wo.weight")

    def forward(self, x):
        h = F.gelu(self.wi(_open(x, self.group)), approximate="tanh")  # flax nn.gelu: tanh form
        return _close(self.wo(h), self.group)


class MoeMlp(nn.Module):
    """Switch-routed (top-1) mixture-of-experts MLP with dense dispatch —
    the JAX package's ``MoeMlp``, in the same arithmetic and order: tokens
    in GShard groups of ``moe_group_size`` (shrunk to a divisor of the
    token count), an f32 router and softmax, the top-1 ``argmax``, each
    token's place in its expert's buffer by ``cumsum``, tokens past the
    capacity ``int(factor * group / E)`` dropped, and the ``[G_n, G, E,
    C]`` dispatch and combine masks; the expert products in the compute
    dtype. ``wi`` ``[E, d_model, d_ff]`` and ``wo`` ``[E, d_ff, d_model]``
    keep the flax layout.

    The Switch balancing loss ``E * sum_e f_e * p_e`` (``f_e`` the share of
    tokens routed to expert e, ``p_e`` its mean router probability) is kept
    as :attr:`aux` after each forward (the JAX module sows it). Its means
    are over the global batch: with more than one data rank the counts and
    probabilities are summed over the data group (``global_sum``).

    On a sequence split over ``sp`` the groups are the JAX package's, which
    groups the flattened ``[B·L]`` real tokens, in one of two routes that
    the model picks for each input shape and row length
    (:func:`_check_sp_routing`, :attr:`sp_real`). The local route, where
    ``moe_group_size`` divides the block and each block's real tokens (so
    no group spans two blocks or a row end): a rank routes its block of each row alone, and ``valid``
    (``[B, L]``, 0 on the last block's padding, ``sharding.sequence_chunk``)
    keeps the padding, which fills groups of its own after every real token,
    out of the balancing loss. Otherwise the gathered route: every rank
    gathers the whole sequence (``gather_from_region``, whose backward keeps
    this rank's slice), drops the last block's padding, groups the real
    ``B·L`` tokens by the rule above, runs the experts on all of them (the
    whole layer's expert work on every rank), pads the output back and keeps
    its own block by a plain slice, so its expert and router gradients are
    its own tokens' (the strategy sums them over ``sp``). In both, the
    balancing loss counts each real token on the rank that holds it: the
    counts, probabilities and token count are summed over the data group
    and then over ``sp``, and the probabilities' gradient is the data
    group's sum, as without ``sp`` (the strategy sums the ranks' gradients
    over ``sp``).

    Over ``ep`` the experts are split, and ``ep`` is not a data axis: every
    rank of an ``ep`` group holds the same tokens. Each routes all of them
    with the replicated router, runs its ``E/ep`` experts on their slice of
    the masks, and combines a partial output that ``reduce_from_region``
    sums over the group — the JAX package's semantics with no all-to-all.
    The expert input and the gate enter the region by ``copy_to_region``,
    so the router's and the input's gradients are whole on every rank.
    ``tp`` splits each expert's hidden dim the same way."""

    def __init__(self, cfg, blocks=None, prefix=""):
        super().__init__()
        blocks = blocks or _Blocks()
        self.cfg = cfg
        e, d, f = cfg.moe_experts, cfg.d_model, cfg.d_ff
        self.router = Dense(d, e, torch.float32, blocks.cut(prefix + "router.weight"))
        self.cuts = {n: blocks.cut(prefix + n) for n in ("wi", "wo")}
        self.full_shapes = {"wi": (e, d, f), "wo": (e, f, d)}
        for n, shape in self.full_shapes.items():
            self.register_parameter(n, nn.Parameter(torch.empty(
                _block_of(torch.empty(shape, device="meta"), self.cuts[n]).shape)))
        self.group = blocks.group(prefix + "wi", prefix + "wo")
        cut = dict((dim, (parts, index)) for dim, parts, index in self.cuts["wi"])
        parts, index = cut.get(0, (1, 0))
        self.experts = slice(index * (e // parts), (index + 1) * (e // parts))
        self.sp_group, self.sp_rank = blocks.sp_group, blocks.sp_rank
        #: on ``sp``: the real tokens of a row of the whole sequence when the
        #: layer takes the gathered route, None for the local route (set by
        #: the model, :func:`_check_sp_routing`)
        self.sp_real = None
        self.aux = None

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for n, shape in self.full_shapes.items():  # flax lecun_normal: fan_in = E * in
            _draw_(getattr(self, n), shape, self.cuts[n],
                   lambda w, s=shape: _trunc_normal_(w, s[0] * s[1], generator))

    def forward(self, x, valid=None):
        from tensorflowonspark_tpu_torch.parallel import collectives

        cfg = self.cfg
        dt = cfg.compute_dtype
        e = cfg.moe_experts
        gathered = self.sp_group is not None and self.sp_real is not None
        if gathered:
            block = x.shape[1]
            start = self.sp_rank * block
            x = collectives.gather_from_region(x, self.sp_group, 1)[:, :self.sp_real]
            # the balancing loss counts this rank's real tokens
            valid = torch.zeros(x.shape[:2], device=x.device)
            valid[:, start:start + block] = 1.0
        b, length, d = x.shape
        tokens = b * length
        group = min(cfg.moe_group_size or tokens, tokens)
        while tokens % group:
            group -= 1
        n_groups = tokens // group
        capacity = max(1, int(cfg.moe_capacity_factor * group / e))

        xg = x.reshape(n_groups, group, d)
        gates = torch.softmax(self.router(xg.float()), dim=-1)  # [G_n, G, E]
        expert_idx = torch.argmax(gates, dim=-1)  # [G_n, G]
        onehot = F.one_hot(expert_idx, e).float()  # [G_n, G, E]
        gate = torch.sum(gates * onehot, dim=-1)  # [G_n, G]

        # each token's place in its expert's per-group buffer; tokens past
        # the capacity drop (switch overflow)
        position = torch.cumsum(onehot, dim=1) * onehot - 1.0  # [G_n, G, E]
        keep = (position < capacity) & (onehot > 0)
        pos_cap = torch.clamp(position, 0, capacity - 1).long()
        dispatch = keep[..., None] & F.one_hot(pos_cap, capacity).bool()  # [G_n, G, E, C]

        # load-balancing loss (Switch eq. 4) over the global batch
        counts, probs, n = onehot.sum((0, 1)), gates.sum((0, 1)), float(tokens)
        if valid is not None:  # the sp padding routes, but counts nowhere
            w = valid.reshape(n_groups, group, 1).to(gates.dtype)
            counts, probs, n = (onehot * w).sum((0, 1)), (gates * w).sum((0, 1)), w.sum()
        data = collectives.data_size() > 1
        groups = ([collectives.data_group()] if data else []) + ([self.sp_group] if self.sp_group is not None else [])
        if groups:
            import torch.distributed as dist

            # a count of valid tokens rides with the expert counts; the
            # token count without one stays on the host (no copy to the
            # card while a CUDA graph is captured)
            totals = torch.cat([counts, n.reshape(1)]) if valid is not None else counts.clone()
            for g in groups:
                dist.all_reduce(totals, group=g)
            if valid is not None:
                counts, n = totals[:-1], totals[-1]
            else:
                counts, n = totals, n * math.prod(dist.get_world_size(g) for g in groups)
            if data:
                probs = collectives.global_sum(probs, collectives.data_group())
            if self.sp_group is not None:
                probs = collectives.reduce_from_region(probs, self.sp_group)
        self.aux = e * torch.sum((counts / n) * (probs / n))

        local = dispatch[:, :, self.experts]
        combine = local.float() * _open(gate, self.group)[..., None, None]
        expert_in = torch.einsum(
            "gtec,gtd->gecd", local.to(dt), _open(xg, self.group).to(dt))  # [G_n, E, C, D]
        h = F.gelu(torch.einsum("gecd,edf->gecf", expert_in, self.wi.to(dt)), approximate="tanh")
        out_e = torch.einsum("gecf,efd->gecd", h, self.wo.to(dt))  # [G_n, E, C, D]
        y = torch.einsum("gtec,gecd->gtd", combine.to(dt), out_e).reshape(b, length, d)
        if gathered:  # this rank's block, the padding's output zero
            y = F.pad(y, (0, 0, 0, max(0, start + block - length)))[:, start:start + block]
        return _close(y, self.group)


def sp_group_size(group_size, block, real=()):
    """The MoE token group of the local route on a sequence split over
    ``sp`` (:class:`MoeMlp`), for ranks that hold blocks of ``block``
    tokens of each row, ``real`` of them real in each block:
    ``group_size`` when it divides the block and every count of ``real``,
    so that no group spans two blocks or a row end; else None, the
    gathered route."""
    if group_size and block % group_size == 0 and all(n % group_size == 0 for n in real):
        return group_size
    return None


class Block(nn.Module):
    def __init__(self, cfg, blocks=None, prefix=""):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.compute_dtype)
        self.attn = Attention(cfg, blocks, prefix + "attn.")
        self.ln2 = RMSNorm(cfg.d_model, cfg.compute_dtype)
        if cfg.moe_experts > 0:
            self.moe = MoeMlp(cfg, blocks, prefix + "moe.")
        else:
            self.mlp = Mlp(cfg, blocks, prefix + "mlp.")

    def forward(self, x, positions, segment_ids=None, valid=None):
        x = x + self.attn(self.ln1(x), positions, segment_ids)
        if hasattr(self, "moe"):
            return x + self.moe(self.ln2(x), valid)
        return x + self.mlp(self.ln2(x))


class Transformer(nn.Module):
    """Parameters are initialised as flax initialises them (lecun-normal
    Dense kernels, ``embed`` normal with std ``1/sqrt(d_model)``, RMSNorm
    scales 1), drawn from ``generator`` when one is given.

    ``mesh`` (a ``DeviceMesh``): the model holds this rank's blocks of the
    parameters :func:`param_specs` places on a model axis
    (:attr:`model_specs`, ``{name: spec}`` of those axes' entries;
    :attr:`full_shapes` the whole tensors' shapes). A block holds the
    numbers the whole model draws there from the same generator."""

    def __init__(self, cfg, generator=None, mesh=None):
        super().__init__()
        self.cfg, self.mesh = cfg, mesh
        self.model_specs = {}
        if mesh is not None:
            from tensorflowonspark_tpu_torch.parallel.sharding import model_spec

            with torch.device("meta"):
                whole = Transformer(cfg)
            self.model_specs = {n: model_spec(s) for n, s in param_specs(whole, mesh).items()
                                if any(model_spec(s))}
        blocks = _Blocks(mesh, self.model_specs)
        #: the ``sp`` group when the sequence is split over it, else None
        self.sp_group, self.sp_rank = blocks.sp_group, blocks.sp_rank
        #: the last input shape and row length whose MoE routing on sp was
        #: checked (:func:`_check_sp_routing`)
        self.sp_routing_checked = None
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        for i in range(cfg.n_layers):
            self.add_module("layer_{}".format(i), Block(cfg, blocks, "layer_{}.".format(i)))
        self.ln_f = RMSNorm(cfg.d_model, cfg.compute_dtype)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.compute_dtype, blocks.cut("lm_head.weight"))
        self.head_group = blocks.group("lm_head.weight")
        self.full_shapes = {n: tuple(p.shape) for n, p in self.named_parameters()}
        for prefix, m in self.named_modules():
            if isinstance(m, Dense):
                self.full_shapes[prefix + ".weight"] = m.full_shape
            elif isinstance(m, MoeMlp):
                self.full_shapes.update((prefix + "." + n, shape) for n, shape in m.full_shapes.items())
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """flax's initialisers, drawn from ``generator``."""
        with torch.no_grad():
            self.embed.weight.normal_(0.0, math.sqrt(1.0 / self.cfg.d_model), generator=generator)
            for m in self.modules():
                if isinstance(m, (Dense, RMSNorm, MoeMlp)):
                    m.reset_parameters(generator)

    def moe_aux(self):
        """The mean over the MoE layers of their last forward's balancing
        loss (None without experts)."""
        aux = [m.aux for m in self.modules() if isinstance(m, MoeMlp)]
        return sum(aux) / len(aux) if aux else None

    def forward(self, tokens, positions=None, segment_ids=None, valid=None, row_length=None):
        """Logits ``[B, L, vocab]`` f32. ``valid`` (``[B, L]``, 0 on the
        padding of the last ``sp`` block; None: every position is real)
        keeps that padding out of the MoE balancing loss; ``row_length``
        (a host int, ``sharding.sequence_chunk`` adds it beside ``valid``)
        is the inputs of a whole row on ``sp``, from which every rank works
        out the MoE route on its own."""
        cfg = self.cfg
        if cfg.moe_experts > 0 and self.sp_group is not None:
            if valid is not None and row_length is None:
                raise ValueError("a padded block on sp needs the batch's row_length (sharding.sequence_chunk) "
                                 "to route its mixture of experts")
            key = (tuple(tokens.shape), row_length)
            if key != self.sp_routing_checked:
                import torch.distributed as dist

                real = _check_sp_routing(cfg.moe_group_size, tokens.shape[1], dist.get_world_size(self.sp_group),
                                         row_length)
                for m in self.modules():
                    if isinstance(m, MoeMlp):
                        m.sp_real = real
                self.sp_routing_checked = key
        x = F.embedding(tokens, self.embed.weight).to(cfg.compute_dtype)
        if positions is None:
            # on a sequence split over sp, this rank's block starts at its
            # index times the block's length
            start = self.sp_rank * tokens.shape[1]
            positions = torch.arange(start, start + tokens.shape[1], device=tokens.device)[None, :].expand(
                tokens.shape)
        for i in range(cfg.n_layers):
            layer = getattr(self, "layer_{}".format(i))
            if cfg.remat and torch.is_grad_enabled():
                from torch.utils.checkpoint import checkpoint

                # no RNG in a block: nothing to replay, and the RNG state
                # cannot be read inside a CUDA-graph capture
                x = checkpoint(layer, x, positions, segment_ids, valid, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, positions, segment_ids, valid)
        logits = self.lm_head(_open(self.ln_f(x), self.head_group))
        if self.head_group is not None:
            from tensorflowonspark_tpu_torch.parallel.collectives import gather_from_region

            logits = gather_from_region(logits, self.head_group, -1)
        return logits.float()


def _check_sp_routing(group_size, length, n, row_length=None):
    """The MoE route of the ``n`` ranks of an ``sp`` group that hold blocks
    of ``length`` tokens of each row (:class:`MoeMlp`): None for the local
    route, where ``group_size`` divides the block and each block's real
    tokens, else the real tokens of a row of the whole sequence, for the
    gathered route. Block i holds ``min(length, row_length - i·length)``
    real tokens (every one without ``row_length``): a host computation, the
    same on every rank."""
    real = [length] * n if row_length is None else [max(0, min(length, row_length - i * length)) for i in range(n)]
    if sp_group_size(group_size, length, real) is not None:
        return None
    return sum(real)


#: path-regex → PartitionSpec-template rules for tensor parallelism, on the
#: flax paths and layouts of the JAX package (``convert.flax_names`` /
#: ``convert.flax_layouts`` give a port parameter's); dims not named here
#: fall back to fsdp placement when an fsdp axis exists.
_TP_RULES = (
    (r"attn/(q|k|v)/kernel$", ("fsdp", "tp", None)),  # [d_model, H, head_dim]
    (r"attn/o/kernel$", ("tp", None, "fsdp")),  # [H, head_dim, d_model]
    (r"mlp/wi/kernel$", ("fsdp", "tp")),  # [d_model, d_ff]
    (r"mlp/wo/kernel$", ("tp", "fsdp")),  # [d_ff, d_model]
    (r"moe/router/kernel$", (None, None)),  # [d_model, E] — replicated
    (r"moe/wi$", ("ep", "fsdp", "tp")),  # [E, d_model, d_ff]
    (r"moe/wo$", ("ep", "tp", "fsdp")),  # [E, d_ff, d_model]
    (r"embed/embedding$", ("fsdp", None)),  # [vocab, d_model]
    (r"lm_head/kernel$", ("fsdp", "tp")),  # [d_model, vocab]
)


def param_specs(module, mesh, tp_axis="tp"):
    """``{name: spec}`` for the transformer's parameters over ``mesh``: the
    tp rules above, replication for the rest; the fsdp overlay
    (``SyncDataParallel(fsdp=True)``) completes them. Axes not present in
    the mesh are dropped from the specs, so the same rules serve dp-only,
    dp×tp, dp×fsdp×tp, dp×ep. ``tp_axis`` renames the mesh axis the
    tensor-parallel dims land on; the rules themselves always say
    ``"tp"``. An axis whose mesh size does not divide the dim it names is
    dropped for that dim (degrade to replicated), so undersized debug
    models still place.

    The rules name the dims of each parameter's flax layout (the whole
    tensor's, ``module.full_shapes`` for a model built on a mesh); a spec
    names the port tensor's dims (``convert.flax_layouts``)."""
    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.parallel.mesh import mesh_shape
    from tensorflowonspark_tpu_torch.parallel.sharding import _to_port

    sizes = mesh_shape(mesh)
    keys = convert.flax_names(module)
    specs = {}
    for name, (shape, dims) in convert.flax_layouts(module).items():
        spec = ()
        for pattern, template in _TP_RULES:
            if re.search(pattern, keys[name]):
                entries = [None] * (max(dims) + 1)
                for i, a in enumerate(tp_axis if a == "tp" else a for a in template):
                    if a in sizes and shape[i] % sizes[a] == 0:
                        d = _to_port(i, shape, dims)
                        if entries[d] is not None:
                            raise ValueError("{}: axes {} and {} on one dim".format(name, entries[d], a))
                        entries[d] = a
                spec = tuple(entries)
                break
        specs[name] = spec
    return specs


@register("transformer")
def create_model(mesh=None, generator=None, **cfg):
    """``Transformer(TransformerConfig(**cfg))``; on ``mesh`` (a
    ``DeviceMesh``) built from this rank's blocks of the parameters
    :func:`param_specs` places on its model axes."""
    return Transformer(TransformerConfig(**cfg), generator=generator, mesh=mesh)


def make_init_fn(model):
    """``init(generator) -> model`` with its parameters drawn afresh from
    the ``torch.Generator`` (the JAX version's ``init(rng) -> variables``)."""

    def init(generator=None):
        model.reset_parameters(generator)
        return model

    return init


def _sequence_mean(losses, mask, group):
    """The masked mean of ``losses`` over every block of the sequence that
    ``group`` holds: the sums and counts all-reduced over it (no gradient
    through them); the value is the whole mean on every member, the
    gradient this member's terms over the whole count."""
    import torch.distributed as dist

    local = (losses * mask).sum() if mask is not None else losses.sum()
    count = mask.sum() if mask is not None else losses.new_full((), losses.numel())
    totals = torch.stack([local.detach(), count.detach().to(local.dtype)])
    dist.all_reduce(totals, group=group)
    return (totals[0] + (local - local.detach())) / torch.clamp_min(totals[1], 1)


def make_loss_fn(model):
    """Next-token LM loss for ``SyncDataParallel.compile_train_step(...,
    has_aux=True)``: ``loss_fn(module, batch) -> (loss, {"perplexity"})``;
    batch = ``{"tokens": int [B, L]}`` (optionally with ``{"mask": [B, L]}``).
    A mixture-of-experts model adds ``moe_aux_weight`` times the layers'
    mean balancing loss, reported as ``metrics["moe_aux"]``.

    Packed batches from the text plane also carry ``segment_ids`` and
    ``positions`` (``int [B, L]``): segments fence attention
    block-diagonally, per-segment positions keep the rotary phase local,
    and the loss drops targets that cross a pack boundary or fall in
    padding.

    On a sequence split over ``sp`` (a module with an ``sp_group``; the
    batch is this rank's block, ``parallel.sharding.sequence_chunk``) the
    loss is the mean over the real tokens of all the group's blocks: its
    value is that mean on every rank of the group, its gradient this
    rank's tokens' share (the strategy sums the gradients over ``sp``).
    The block's ``valid`` and ``row_length`` (added where the last block
    is padded) go to the model."""
    del model  # the module arrives with each call

    def loss_fn(module, batch):
        tokens = batch["tokens"]
        seg = batch.get("segment_ids")
        pos = batch.get("positions")
        valid = batch.get("valid")
        logits = module(
            tokens[:, :-1],
            positions=None if pos is None else pos[:, :-1],
            segment_ids=None if seg is None else seg[:, :-1],
            valid=None if valid is None else valid[:, :-1],
            row_length=batch.get("row_length"),
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
        sp_group = getattr(module, "sp_group", None)
        if sp_group is not None:
            loss = _sequence_mean(losses, mask, sp_group)
        elif mask is not None:
            loss = (losses * mask).sum() / torch.clamp_min(mask.sum(), 1)
        else:
            loss = losses.mean()
        metrics = {"perplexity": torch.exp(loss.detach())}
        moe_aux = module.moe_aux()
        if moe_aux is not None:
            metrics["moe_aux"] = moe_aux.detach()
            loss = loss + module.cfg.moe_aux_weight * moe_aux
        return loss, metrics

    return loss_fn
