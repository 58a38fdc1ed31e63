"""Training-mode BatchNorm as four Triton kernels for Hopper (+ autograd).

The counterpart of the JAX package's ``ops/fused_bn.py``, which runs the
same four passes as Pallas TPU kernels. Over an ``[R, C]`` activation
(``R = N*H*W``, channels last, so an NHWC tensor's ``[R, C]`` view is free):

==============  =======================================  ====================
kernel           computes                                 replaces (JAX pkg)
==============  =======================================  ====================
``bn_stats``     Σx, Σx² in f32 in one read → mean, var   ``_stats_kernel``
``bn_normalize`` y = (x−mean)·(rsqrt(var+eps)·γ) + β      ``_norm_kernel``
``bn_bwd_reduce`` dβ = Σdy, dγ = Σdy·x̂                     ``_bwd_reduce_kernel``
``bn_bwd_dx``    dx = (γ·inv/R)·(R·dy − dβ − x̂·dγ)         ``_bwd_dx_kernel``
==============  =======================================  ====================

**Bound.** None of the four multiplies matrices: each is a few flops per
element streamed from device memory, so each is bound by the bytes it moves
(H100 SXM: 3.35 TB/s). Per ``[R, C]`` bf16 activation: ``bn_stats`` reads
2RC bytes, ``bn_normalize`` reads and writes 4RC, ``bn_bwd_reduce`` reads
4RC, ``bn_bwd_dx`` reads 4RC and writes 2RC; the per-channel vectors are
noise beside them. **Design.** Every kernel walks ``[BLOCK_R, BLOCK_C]``
tiles of the row-major activation, so a warp reads whole 128-byte row
segments (16-byte vector loads); the per-channel vectors are loaded once
per tile. The TPU kernels carry their sums in VMEM along a sequential grid;
Hopper's blocks run in no order, so the two reductions (``bn_stats``,
``bn_bwd_reduce``) split the rows over enough blocks to fill the card, each
writing one ``[C]`` f32 partial per split, and a second small launch adds
the ``[S, C]`` partials in a fixed order — deterministic, no atomics — and
forms mean/var with the reference's own ``E[x²] − mean²`` formula.

**No block rule.** The JAX package needs a power-of-two row block that
divides R (``_pick_block_or_none``) because Pallas pads a ragged last block
with garbage; :class:`FusedBatchNorm` there falls back to plain XLA math
when none exists and ``fused_batch_norm`` raises. The Triton kernels mask
the ragged tail, so this module runs the kernels at every R. The reference's
fallback computes the same math as its kernels, so the outputs agree with
both of its branches.

**Dispatch.** Each wrapper takes its plain PyTorch version (the ``*_plain``
functions, the reference for tests and ``chip_smoke.py``) only when its
input lies on the CPU; on a CUDA tensor it launches the kernel or raises,
and counts the launch in its ``launches`` attribute. ``triton`` is imported
and the kernels are compiled at the first CUDA launch, never at import.

Statistics are per-process (per-replica BN, as the JAX package's fused
path); ``mean``/``var`` are detached and the gradient flows through ``y``
only, with the batch-statistics terms folded into ``dx``.
"""

import os

import torch
from torch import nn

#: elements per tile: 4096 bf16 = 8 KB per operand, 32 per thread at 4 warps
_TILE = 4096
#: blocks the split-row reductions aim for: 4 per SM of an H100 (132 SMs)
_TARGET_BLOCKS = 4 * 132
#: the partials finisher's tile: splits added per step x channels per block
_FINISH_S, _FINISH_C = 64, 64

_kernels = None


def _build():
    """Compile-on-first-use: import triton, define the four kernels and the
    partials finisher, and cache them. The compiled binaries land in
    ``TRITON_CACHE_DIR`` (default: ``build/triton`` in the checkout)."""
    global _kernels
    if _kernels is not None:
        return _kernels
    os.environ.setdefault(
        "TRITON_CACHE_DIR",
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            "build", "triton",
        ),
    )
    import triton
    import triton.language as tl

    @triton.jit
    def stats_partial(x_ptr, psum_ptr, psq_ptr, R, C, rows_per_split,
                      BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        # replaces _stats_kernel's sequential-grid accumulation: this block
        # sums rows [r_begin, r_end) of BLOCK_C channels into one partial
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        r_begin = tl.program_id(1) * rows_per_split
        r_end = tl.minimum(r_begin + rows_per_split, R)
        acc_s = tl.zeros((BLOCK_R, BLOCK_C), tl.float32)
        acc_q = tl.zeros((BLOCK_R, BLOCK_C), tl.float32)
        for r0 in range(r_begin, r_end, BLOCK_R):
            rows = r0 + tl.arange(0, BLOCK_R)
            mask = (rows < r_end)[:, None] & cmask[None, :]
            offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            acc_s += x
            acc_q += x * x
        out = tl.program_id(1) * C + cols
        tl.store(psum_ptr + out, tl.sum(acc_s, axis=0), mask=cmask)
        tl.store(psq_ptr + out, tl.sum(acc_q, axis=0), mask=cmask)

    @triton.jit
    def finish(p0_ptr, p1_ptr, out0_ptr, out1_ptr, S, C, n_rows,
               STATS: tl.constexpr, BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
        # adds the [S, C] partials, BLOCK_S splits a step, in a fixed order;
        # STATS turns (Σx, Σx²) into (mean, biased var) exactly as
        # _stats_kernel's _finish does
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        acc0 = tl.zeros((BLOCK_S, BLOCK_C), tl.float32)
        acc1 = tl.zeros((BLOCK_S, BLOCK_C), tl.float32)
        for s0 in range(0, S, BLOCK_S):
            splits = s0 + tl.arange(0, BLOCK_S)
            mask = (splits < S)[:, None] & cmask[None, :]
            offs = splits[:, None] * C + cols[None, :]
            acc0 += tl.load(p0_ptr + offs, mask=mask, other=0.0)
            acc1 += tl.load(p1_ptr + offs, mask=mask, other=0.0)
        a0 = tl.sum(acc0, axis=0)
        a1 = tl.sum(acc1, axis=0)
        if STATS:
            mean = a0 / n_rows
            a1 = tl.maximum(a1 / n_rows - mean * mean, 0.0)
            a0 = mean
        tl.store(out0_ptr + cols, a0, mask=cmask)
        tl.store(out1_ptr + cols, a1, mask=cmask)

    @triton.jit
    def normalize(x_ptr, mean_ptr, var_ptr, gamma_ptr, beta_ptr, y_ptr, R, C, eps,
                  BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        # replaces _norm_kernel
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        mean = tl.load(mean_ptr + cols, mask=cmask, other=0.0)
        var = tl.load(var_ptr + cols, mask=cmask, other=1.0)
        gamma = tl.load(gamma_ptr + cols, mask=cmask, other=0.0)
        beta = tl.load(beta_ptr + cols, mask=cmask, other=0.0)
        scale = tl.math.rsqrt(var + eps) * gamma
        mask = (rows < R)[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        y = (x - mean[None, :]) * scale[None, :] + beta[None, :]
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def bwd_reduce_partial(x_ptr, dy_ptr, mean_ptr, var_ptr, pdb_ptr, pdg_ptr,
                           R, C, rows_per_split, eps,
                           BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        # replaces _bwd_reduce_kernel's sequential-grid accumulation
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        mean = tl.load(mean_ptr + cols, mask=cmask, other=0.0)
        inv = tl.math.rsqrt(tl.load(var_ptr + cols, mask=cmask, other=1.0) + eps)
        r_begin = tl.program_id(1) * rows_per_split
        r_end = tl.minimum(r_begin + rows_per_split, R)
        acc_db = tl.zeros((BLOCK_R, BLOCK_C), tl.float32)
        acc_dg = tl.zeros((BLOCK_R, BLOCK_C), tl.float32)
        for r0 in range(r_begin, r_end, BLOCK_R):
            rows = r0 + tl.arange(0, BLOCK_R)
            mask = (rows < r_end)[:, None] & cmask[None, :]
            offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            acc_db += dy
            acc_dg += dy * ((x - mean[None, :]) * inv[None, :])
        out = tl.program_id(1) * C + cols
        tl.store(pdb_ptr + out, tl.sum(acc_db, axis=0), mask=cmask)
        tl.store(pdg_ptr + out, tl.sum(acc_dg, axis=0), mask=cmask)

    @triton.jit
    def bwd_dx(x_ptr, dy_ptr, mean_ptr, var_ptr, gamma_ptr, dgamma_ptr, dbeta_ptr, dx_ptr,
               R, C, n_rows, eps, BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        # replaces _bwd_dx_kernel
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        mean = tl.load(mean_ptr + cols, mask=cmask, other=0.0)
        inv = tl.math.rsqrt(tl.load(var_ptr + cols, mask=cmask, other=1.0) + eps)
        gamma = tl.load(gamma_ptr + cols, mask=cmask, other=0.0)
        dgamma = tl.load(dgamma_ptr + cols, mask=cmask, other=0.0)
        dbeta = tl.load(dbeta_ptr + cols, mask=cmask, other=0.0)
        mask = (rows < R)[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        xhat = (x - mean[None, :]) * inv[None, :]
        dx = ((gamma * inv / n_rows)[None, :]) * (
            n_rows * dy - dbeta[None, :] - xhat * dgamma[None, :]
        )
        tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)

    _kernels = {
        "stats_partial": stats_partial,
        "finish": finish,
        "normalize": normalize,
        "bwd_reduce_partial": bwd_reduce_partial,
        "bwd_dx": bwd_dx,
    }
    return _kernels


# -- launch geometry ----------------------------------------------------------


def _cdiv(a, b):
    return -(-a // b)


def _blocks(n_ch):
    """(BLOCK_R, BLOCK_C): at most 128 channels a tile (a 256-byte bf16 row
    segment), rows filling the rest of a ``_TILE``-element tile."""
    block_c = min(128, max(16, 1 << (n_ch - 1).bit_length()))
    return _TILE // block_c, block_c


def _splits(rows, n_ch, block_r, block_c):
    """(S, rows_per_split) for the split-row reductions: about
    ``_TARGET_BLOCKS`` blocks over the card, each split a whole number of
    row tiles."""
    want = max(1, min(_cdiv(rows, block_r), _cdiv(_TARGET_BLOCKS, _cdiv(n_ch, block_c))))
    rows_per_split = _cdiv(_cdiv(rows, want), block_r) * block_r
    return _cdiv(rows, rows_per_split), rows_per_split


def _check(x2d, *vecs, dy=None):
    """Validate a CUDA launch's operands; the kernels take row-major
    ``[R, C]`` activations and ``[C]`` float32 per-channel vectors."""
    if x2d.dim() != 2 or not x2d.is_contiguous():
        raise ValueError("expected a contiguous [R, C] activation, got {} {}".format(
            tuple(x2d.shape), x2d.stride()))
    if x2d.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError("unsupported activation dtype {}".format(x2d.dtype))
    if dy is not None and (dy.shape != x2d.shape or dy.dtype != x2d.dtype
                           or not dy.is_contiguous() or dy.device != x2d.device):
        raise ValueError("dy must match x: {} {} vs {} {}".format(
            tuple(dy.shape), dy.dtype, tuple(x2d.shape), x2d.dtype))
    n_ch = x2d.shape[1]
    for v in vecs:
        if (v.shape != (n_ch,) or v.dtype != torch.float32 or not v.is_contiguous()
                or v.device != x2d.device):
            raise ValueError("per-channel operands must be contiguous float32 [{}] on {}, "
                             "got {} {} on {}".format(n_ch, x2d.device, tuple(v.shape),
                                                      v.dtype, v.device))


def _on_card(x2d):
    """True when the kernel must launch; False for a CPU tensor (plain
    version). Any other device raises: there is no silent fallback."""
    if x2d.device.type == "cuda":
        return True
    if x2d.device.type == "cpu":
        return False
    raise RuntimeError("fused BN kernels run on CUDA; got a tensor on {}".format(x2d.device))


# -- plain versions (the reference for tests and chip_smoke.py) -------------


def bn_stats_plain(x2d):
    xf = x2d.float()
    n_rows = float(x2d.shape[0])
    mean = xf.sum(0) / n_rows
    var = torch.clamp_min(xf.square().sum(0) / n_rows - mean * mean, 0.0)
    return mean, var


def bn_normalize_plain(x2d, mean, var, gamma, beta, eps):
    scale = torch.rsqrt(var + eps) * gamma
    return ((x2d.float() - mean) * scale + beta).to(x2d.dtype)


def bn_bwd_reduce_plain(x2d, dy2d, mean, var, eps):
    dyf = dy2d.float()
    xhat = (x2d.float() - mean) * torch.rsqrt(var + eps)
    return (dyf * xhat).sum(0), dyf.sum(0)


def bn_bwd_dx_plain(x2d, dy2d, mean, var, gamma, dgamma, dbeta, eps):
    n_rows = float(x2d.shape[0])
    inv = torch.rsqrt(var + eps)
    xhat = (x2d.float() - mean) * inv
    dx = (gamma * inv / n_rows) * (n_rows * dy2d.float() - dbeta - xhat * dgamma)
    return dx.to(x2d.dtype)


# -- kernel wrappers ----------------------------------------------------------


def bn_stats(x2d):
    """Per-channel batch mean and biased variance of ``x2d [R, C]`` as two
    float32 ``[C]`` tensors (replaces ``_stats_kernel`` / ``_bn_stats``)."""
    if not _on_card(x2d):
        return bn_stats_plain(x2d)
    _check(x2d)
    k = _build()
    rows, n_ch = x2d.shape
    block_r, block_c = _blocks(n_ch)
    n_splits, rows_per_split = _splits(rows, n_ch, block_r, block_c)
    psum = torch.empty((n_splits, n_ch), device=x2d.device, dtype=torch.float32)
    psq = torch.empty_like(psum)
    mean = torch.empty(n_ch, device=x2d.device, dtype=torch.float32)
    var = torch.empty_like(mean)
    k["stats_partial"][(_cdiv(n_ch, block_c), n_splits)](
        x2d, psum, psq, rows, n_ch, rows_per_split, BLOCK_R=block_r, BLOCK_C=block_c,
    )
    k["finish"][(_cdiv(n_ch, _FINISH_C),)](
        psum, psq, mean, var, n_splits, n_ch, float(rows), STATS=True,
        BLOCK_S=_FINISH_S, BLOCK_C=_FINISH_C,
    )
    bn_stats.launches += 1
    return mean, var


def bn_normalize(x2d, mean, var, gamma, beta, eps):
    """``y = (x − mean)·(rsqrt(var + eps)·gamma) + beta`` in float32, cast to
    ``x2d``'s dtype (replaces ``_norm_kernel`` / ``_bn_normalize``)."""
    if not _on_card(x2d):
        return bn_normalize_plain(x2d, mean, var, gamma, beta, eps)
    _check(x2d, mean, var, gamma, beta)
    k = _build()
    rows, n_ch = x2d.shape
    block_r, block_c = _blocks(n_ch)
    y = torch.empty_like(x2d)
    k["normalize"][(_cdiv(rows, block_r), _cdiv(n_ch, block_c))](
        x2d, mean, var, gamma, beta, y, rows, n_ch, float(eps),
        BLOCK_R=block_r, BLOCK_C=block_c,
    )
    bn_normalize.launches += 1
    return y


def bn_bwd_reduce(x2d, dy2d, mean, var, eps):
    """``(dgamma, dbeta) = (Σ dy·x̂, Σ dy)`` per channel in float32, x̂
    recomputed from the saved statistics (replaces ``_bwd_reduce_kernel``)."""
    if not _on_card(x2d):
        return bn_bwd_reduce_plain(x2d, dy2d, mean, var, eps)
    _check(x2d, mean, var, dy=dy2d)
    k = _build()
    rows, n_ch = x2d.shape
    block_r, block_c = _blocks(n_ch)
    n_splits, rows_per_split = _splits(rows, n_ch, block_r, block_c)
    pdb = torch.empty((n_splits, n_ch), device=x2d.device, dtype=torch.float32)
    pdg = torch.empty_like(pdb)
    dbeta = torch.empty(n_ch, device=x2d.device, dtype=torch.float32)
    dgamma = torch.empty_like(dbeta)
    k["bwd_reduce_partial"][(_cdiv(n_ch, block_c), n_splits)](
        x2d, dy2d, mean, var, pdb, pdg, rows, n_ch, rows_per_split, float(eps),
        BLOCK_R=block_r, BLOCK_C=block_c,
    )
    k["finish"][(_cdiv(n_ch, _FINISH_C),)](
        pdb, pdg, dbeta, dgamma, n_splits, n_ch, float(rows), STATS=False,
        BLOCK_S=_FINISH_S, BLOCK_C=_FINISH_C,
    )
    bn_bwd_reduce.launches += 1
    return dgamma, dbeta


def bn_bwd_dx(x2d, dy2d, mean, var, gamma, dgamma, dbeta, eps):
    """``dx = (gamma·inv/R)·(R·dy − dbeta − x̂·dgamma)`` cast to ``x2d``'s
    dtype (replaces ``_bwd_dx_kernel``)."""
    if not _on_card(x2d):
        return bn_bwd_dx_plain(x2d, dy2d, mean, var, gamma, dgamma, dbeta, eps)
    _check(x2d, mean, var, gamma, dgamma, dbeta, dy=dy2d)
    k = _build()
    rows, n_ch = x2d.shape
    block_r, block_c = _blocks(n_ch)
    dx = torch.empty_like(x2d)
    k["bwd_dx"][(_cdiv(rows, block_r), _cdiv(n_ch, block_c))](
        x2d, dy2d, mean, var, gamma, dgamma, dbeta, dx, rows, n_ch, float(rows), float(eps),
        BLOCK_R=block_r, BLOCK_C=block_c,
    )
    bn_bwd_dx.launches += 1
    return dx


#: the four kernel wrappers of this module, in pass order
KERNELS = (bn_stats, bn_normalize, bn_bwd_reduce, bn_bwd_dx)
for _fn in KERNELS:
    _fn.launches = 0


def launch_counts():
    """``{wrapper name: kernel launches}`` in this process."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts():
    for fn in KERNELS:
        fn.launches = 0


# -- autograd + public API ----------------------------------------------------


class _FusedBN2d(torch.autograd.Function):
    """The JAX package's ``_fused_bn_2d`` custom VJP: forward = stats +
    normalize, backward = reduce + dx. ``mean``/``var`` are outputs without
    a gradient; their dependence on ``x`` is folded into ``dx``."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, eps):
        mean, var = bn_stats(x2d)
        y = bn_normalize(x2d, mean, var, gamma, beta, eps)
        ctx.save_for_backward(x2d, gamma, mean, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x2d, gamma, mean, var = ctx.saved_tensors
        dy = dy.contiguous()
        dgamma, dbeta = bn_bwd_reduce(x2d, dy, mean, var, ctx.eps)
        dx = bn_bwd_dx(x2d, dy, mean, var, gamma, dgamma, dbeta, ctx.eps)
        return dx, dgamma, dbeta, None


def fused_batch_norm(x, gamma, beta, eps=1e-5):
    """Training-mode batch norm over the last axis of ``x`` (channels):
    returns ``(y, mean, var)``, ``y`` in ``x``'s dtype and shape, ``mean``
    and ``var`` detached float32 ``[C]``. Any row count works (see the
    module docstring on the JAX package's block rule)."""
    n_ch = x.shape[-1]
    x2d = x.reshape(-1, n_ch).contiguous()
    y2d, mean, var = _FusedBN2d.apply(x2d, gamma.float(), beta.float(), float(eps))
    return y2d.reshape(x.shape), mean, var


class _BatchNormBase(nn.Module):
    """Parameters, running statistics and eval path shared by both BN
    implementations; the names map onto flax's (``scale``/``bias`` →
    ``weight``/``bias``, ``batch_stats`` mean/var → running buffers).

    Input is channels-last ``[..., C]``. Running statistics use momentum
    0.9 on the **biased** variance, exactly as the JAX package's modules
    (``ra = m·ra + (1 − m)·batch``), not ``F.batch_norm``'s unbiased update.
    Eval mode is plain math, as in the reference.
    """

    def __init__(self, num_features, momentum=0.9, eps=1e-5, zero_init_scale=False):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        init = torch.zeros if zero_init_scale else torch.ones
        self.weight = nn.Parameter(init(num_features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(num_features, dtype=torch.float32))
        self.register_buffer("running_mean", torch.zeros(num_features, dtype=torch.float32))
        self.register_buffer("running_var", torch.ones(num_features, dtype=torch.float32))

    def _train_forward(self, x):
        raise NotImplementedError

    def forward(self, x):
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            return ((x.float() - self.running_mean) * inv + self.bias).to(x.dtype)
        y, mean, var = self._train_forward(x)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        return y


class FusedBatchNorm(_BatchNormBase):
    """``bn_impl="pallas"``: the training forward and backward run the four
    kernels (on a CUDA tensor; their plain versions on a CPU one).
    Statistics are per-process: per-replica BN under data parallelism, as
    the JAX package's fused module."""

    def _train_forward(self, x):
        return fused_batch_norm(x, self.weight, self.bias, self.eps)


class BatchNorm(_BatchNormBase):
    """``bn_impl="flax"``: plain PyTorch math, differentiated by autograd
    through the batch statistics (the kernels' plain versions, composed).
    Single process only: the JAX package's flax BN is global sync-BN under
    data parallelism, which this package does not have yet."""

    def _train_forward(self, x):
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise NotImplementedError(
                "bn_impl='flax' under data parallelism needs sync-BN, which is not "
                "yet ported; use bn_impl='pallas' (per-replica statistics)"
            )
        n_ch = x.shape[-1]
        x2d = x.reshape(-1, n_ch)
        mean, var = bn_stats_plain(x2d)
        y2d = bn_normalize_plain(x2d, mean, var, self.weight, self.bias, self.eps)
        return y2d.reshape(x.shape), mean.detach(), var.detach()
