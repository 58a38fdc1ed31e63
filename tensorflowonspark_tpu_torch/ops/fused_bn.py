"""Training-mode BatchNorm as four hand-written kernels for Hopper (+ autograd).

The counterpart of the JAX package's ``ops/fused_bn.py``, which runs the
same four passes as Pallas TPU kernels. Over an ``[R, C]`` activation
(``R = N*H*W``, channels last, so an NHWC tensor's ``[R, C]`` view is free):

==============  =======================================  ====================  ==========
kernel           computes                                 replaces (JAX pkg)    route
==============  =======================================  ====================  ==========
``bn_stats``     Σx, Σx² in f32 in one read → mean, var   ``_stats_kernel``     CUDA C++
``bn_normalize`` y = (x−mean)·(rsqrt(var+eps)·γ) + β      ``_norm_kernel``      Triton
``bn_bwd_reduce`` dβ = Σdy, dγ = Σdy·x̂                     ``_bwd_reduce_kernel``  CUDA C++
``bn_bwd_dx``    dx = (γ·inv/R)·(R·dy − dβ − x̂·dγ)         ``_bwd_dx_kernel``    Triton
==============  =======================================  ====================  ==========

**Bound.** None of the four multiplies matrices: each is a few flops per
element streamed from device memory, so each is bound by the bytes it moves
(H100 SXM: 3.35 TB/s). Per ``[R, C]`` bf16 activation: ``bn_stats`` reads
2RC bytes, ``bn_normalize`` reads and writes 4RC, ``bn_bwd_reduce`` reads
4RC, ``bn_bwd_dx`` reads 4RC and writes 2RC; the per-channel vectors are
noise beside them.

**Design.** The two elementwise passes are Triton kernels over
``[BLOCK_R, BLOCK_C]`` tiles of the row-major activation, so a warp reads
whole 128-byte row segments (16-byte vector loads); the per-channel vectors
are loaded once per tile. The TPU kernels carry the two reductions' sums in
VMEM along a sequential grid; Hopper's blocks run in no order, so
``bn_stats`` and ``bn_bwd_reduce`` are CUDA kernels (``csrc/fused_bn.cu``)
of one launch each: CTAs own a strip of channels and a split of the rows
(:func:`reduce_geometry` sizes the split count to the work), write one f64
partial per channel, and the CTA that completes a strip (an ``atomicAdd``
ticket after a ``__threadfence()``) adds the strip's partials in a fixed
order (:func:`finish_plain` is its mirror) and forms the outputs — mean/var
with the reference's own ``E[x²] − mean²`` formula. The partials and the
per-strip counters live in a workspace cached per (device, stream); nothing
syncs the host. The kernels are compiled by ``nvcc`` at the first CUDA
launch into ``build/cuda`` and bound through ``ctypes``
(:mod:`~tensorflowonspark_tpu_torch.ops.cuda_build`).

**Correctly rounded sums.** The sums (Σx, Σx², Σdy·x̂, Σdy) are rounded to
f32 once, from f64 sums of short f32 sums (the rows of one round of a
thread's loads); the plain version of ``bn_stats`` sums in f64 and rounds
the same way (its f64 copy of the input lives only in the forward: its
gradient is the f32 formula, on the saved input), and both then apply the
reference's f32 formula, so the two agree to the bit in nearly every
channel. An f32 training step is sensitive to the last bits of a layer's
statistics: two f32 summation orders of the same activation move a
ResNet-50 step's gradients about 2e-4 apart, so the only order both sides
can share is the exact one. That plain version is the checks' yardstick
(``bn_impl="plain"``, :class:`PlainBatchNorm`); the ``bn_impl="flax"``
training path sums in f32 (:func:`bn_stats_f32`), as the JAX package's
flax BatchNorm does.

**No block rule.** The JAX package needs a power-of-two row block that
divides R (``_pick_block_or_none``) because Pallas pads a ragged last block
with garbage; :class:`FusedBatchNorm` there falls back to plain XLA math
when none exists and ``fused_batch_norm`` raises. These kernels mask the
ragged tail, and an operand that is not 16-byte aligned takes the
reductions' scalar path, so this module runs the kernels at every R and C.
The reference's fallback computes the same math as its kernels, so the
outputs agree with both of its branches.

**Dispatch.** Each wrapper takes its plain PyTorch version (the ``*_plain``
functions, the reference for tests and ``chip_smoke.py``) only when its
input lies on the CPU; on a CUDA tensor it launches the kernel or raises,
and counts the launch in its ``launches`` attribute (under CUDA graph
capture, the launch into the graph; a replay calls no wrapper, and
``ops/kernel_trace.py`` counts its kernels from a trace). ``triton`` is imported
and its kernels compiled, and ``nvcc`` run, at the first CUDA launch, never
at import.

**Global statistics under data parallelism.** In the JAX package the
batch statistics of both BN modules are taken over the global batch: the
SPMD train step sees the whole dp-sharded batch (``train/strategy.py:37-40``
there), the Pallas kernels included. Here each process holds its shard, so
when ``torch.distributed`` runs more than one rank both modules reduce
across ranks: the kernels' split mode (:func:`bn_stats_sums`,
:func:`bn_bwd_reduce_sums`: the finishing CTA writes the f64 sums ``[2, C]``
instead of rounding them), one ``all_reduce`` of those sums, and
:func:`bn_finish`, which rounds them as the single launch does; the plain
paths all-reduce their own sums (f64 for the yardstick, f32 for ``flax``),
and their gradient's ``g_mean``/``g_var``.
The row count is the local one times the world (the ranks hold equal
batches, as the reference's even dp sharding does), and enters ``dx`` too.
With one rank the single launches run, as before.

``mean``/``var`` are detached and the gradient flows through ``y`` only,
with the batch-statistics terms folded into ``dx``.
"""

import collections
import ctypes
import functools
import os
import threading

import torch
from torch import nn

from tensorflowonspark_tpu_torch import util
from tensorflowonspark_tpu_torch.ops import cuda_build

#: elements per tile of the Triton kernels: 4096 bf16 = 8 KB per operand,
#: 32 per thread at 4 warps
_TILE = 4096

SOURCE = os.path.join(cuda_build.CSRC, "fused_bn.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_kernels = None
_lib = None
_lib_lock = threading.Lock()


def _build():
    """Compile-on-first-use: import triton, define the two elementwise
    kernels, and cache them. The compiled binaries land in
    ``TRITON_CACHE_DIR`` (default: ``build/triton`` in the checkout)."""
    global _kernels
    if _kernels is not None:
        return _kernels
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cuda_build.ROOT, "build", "triton"))
    import triton
    import triton.language as tl

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

    _kernels = {"normalize": normalize, "bwd_dx": bwd_dx}
    return _kernels


def build(source=SOURCE, build_dir=cuda_build.BUILD_DIR):
    """Compile the two reduction kernels if this source has no build yet;
    returns the path of the library (:func:`cuda_build.build`)."""
    return cuda_build.build(source, build_dir)


def bind(path):
    """The reductions' C interface of the library at ``path`` (``ctypes``)."""
    lib = ctypes.CDLL(path)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tos_bn_stats.argtypes = [ptr] + [i32] * 8 + [ptr] * 6
    lib.tos_bn_bwd_reduce.argtypes = [ptr] * 4 + [f32] + [i32] * 8 + [ptr] * 6
    lib.tos_bn_finish.argtypes = [ptr] + [i32] * 3 + [ptr] * 3
    lib.tos_bn_stats.restype = lib.tos_bn_bwd_reduce.restype = lib.tos_bn_finish.restype = i32
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(build())
    return _lib


def kernel_resources(log_path=None):
    """Registers and spill bytes of each instance of the two reduction
    kernels, read from the ``-Xptxas -v`` log beside the library:
    ``[{"kernel", "dtype", "vec", "registers", "spill_stores",
    "spill_loads"}, ...]``."""
    out = []
    for entry in cuda_build.ptxas_report(log_path or cuda_build.library_path(SOURCE)[:-3] + ".log"):
        name = entry.pop("entry")
        kernel = next((k for k in ("bn_stats_kernel", "bn_bwd_reduce_kernel", "bn_finish_kernel")
                       if k in name), name)
        dtype = ("bfloat16" if "__nv_bfloat16" in name else "float16" if "6__half" in name
                 else "float32")
        out.append(dict(entry, kernel=kernel, dtype=dtype, vec="Lb1E" in name))
    return out


# -- launch geometry ----------------------------------------------------------


def _cdiv(a, b):
    return -(-a // b)


def _blocks(n_ch):
    """(BLOCK_R, BLOCK_C) of the Triton kernels: at most 128 channels a tile
    (a 256-byte bf16 row segment), rows filling the rest of a
    ``_TILE``-element tile."""
    block_c = min(128, max(16, 1 << (n_ch - 1).bit_length()))
    return _TILE // block_c, block_c


#: threads of a reduction CTA (``kThreads`` in the CUDA source)
_THREADS = 256
#: column lanes of a strip at most: 8 lanes of 16 bytes (one 128-byte row
#: segment), or 32 lanes of one element on the scalar path. Narrow strips
#: give wide layers many strips, each finished by its own CTA from few
#: partials
_VEC_LANES, _SCALAR_LANES = 8, 32
#: input bytes a CTA reads at least: one round of its loads in flight
#: (256 threads x 16 bytes x 8 loads, or x 4 loads of each of two inputs)
_MIN_CTA_BYTES = 32 * 1024
#: CTAs of a launch per SM at most: one wave at the kernels' occupancy
_CTAS_PER_SM = 2
#: the H100 SXM's SM count, for callers without a card at hand
H100_SMS = 132

Geometry = collections.namedtuple(
    "Geometry", "vec per_thread lanes width strips splits rows_per_split runs")
Geometry.__doc__ = """Launch geometry of a reduction over ``[R, C]``:
``vec`` (16-byte loads) with ``per_thread`` channels a lane, ``lanes``
column lanes of ``width`` channels a strip, ``strips`` x ``splits`` CTAs of
``rows_per_split`` rows (the last split takes the rest), and the finisher's
``runs`` of splits per strip."""


@functools.lru_cache(maxsize=1024)
def reduce_geometry(rows, n_ch, elem_size, n_inputs, vec, n_sms=H100_SMS):
    """The grid of ``bn_stats`` (``n_inputs=1``) or ``bn_bwd_reduce`` (2)
    over ``rows`` x ``n_ch`` elements of ``elem_size`` bytes. A lane reads 16
    bytes of a row (``vec``) or one element; a strip is one 128-byte row
    segment (``vec``) or 32 elements.
    The split count follows the work: each CTA reads at least
    ``_MIN_CTA_BYTES`` of input, and the whole grid is at most
    ``_CTAS_PER_SM`` CTAs per SM, so small layers take few CTAs and the
    largest fill the card in one wave."""
    per = 16 // elem_size if vec else 1
    lanes = min(_VEC_LANES if vec else _SCALAR_LANES, 1 << (_cdiv(n_ch, per) - 1).bit_length())
    width = lanes * per
    strips = _cdiv(n_ch, width)
    strip_row_bytes = min(width, n_ch) * elem_size * n_inputs
    want = max(1, min(rows * strip_row_bytes // _MIN_CTA_BYTES, _CTAS_PER_SM * n_sms // strips))
    rows_per_split = _cdiv(rows, want)
    splits = _cdiv(rows, rows_per_split)
    # the finisher's threads load 2 f64 partials (vec, 16 bytes) or 1
    runs = _THREADS * (2 if vec else 1) // width
    return Geometry(vec, per, lanes, width, strips, splits, rows_per_split, runs)


def _vector_path(*tensors):
    """True when the reductions may take 16-byte loads: every operand's base
    pointer and row pitch a multiple of 16 bytes."""
    return all(t.data_ptr() % 16 == 0 and t.shape[1] * t.element_size() % 16 == 0 for t in tensors)


def split_sums_plain(a, geom):
    """The per-split sums of ``a`` (``[R, C]`` summands) that the CTAs of
    ``geom`` write as partials: ``[splits, C]`` f64 (each split summed in
    f64, as the CTA's compensated sums come out)."""
    return torch.stack([a[s:s + geom.rows_per_split].double().sum(0)
                        for s in range(0, a.shape[0], geom.rows_per_split)])


def finish_plain(partials, geom):
    """The finisher's fixed order over ``[splits, C]`` f64 partials (the
    plain mirror of ``finish`` in the CUDA source): the splits cut into
    ``geom.runs`` runs of ``ceil(splits / runs)``, each run added in split
    order from zero, then the runs added in order; the caller rounds the
    result to f32 once."""
    splits = partials.shape[0]
    per = _cdiv(splits, geom.runs)
    total = None
    for lo in range(0, per * geom.runs, per):
        run = torch.zeros_like(partials[0])
        for s in range(lo, min(splits, lo + per)):
            run = run + partials[s]
        total = run if total is None else total + run
    return total


class _Workspace:
    """The reductions' partials (f64 ``[2, splits, C]``) and per-strip
    counters on one stream, grown only when a launch needs more. The
    counters are zeroed once, at allocation: each launch's finishing CTA
    leaves its strip's counter at 0 again."""

    def __init__(self, device):
        self.n_sms = torch.cuda.get_device_properties(device).multi_processor_count
        self.partials = torch.empty(0, device=device, dtype=torch.float64)
        self.counters = torch.zeros(0, device=device, dtype=torch.int32)

    def reserve(self, geom, n_ch):
        need = 2 * geom.splits * n_ch
        if self.partials.numel() < need:
            self.partials = torch.empty(need, device=self.partials.device, dtype=torch.float64)
        if self.counters.numel() < geom.strips:
            self.counters = torch.zeros(geom.strips, device=self.counters.device, dtype=torch.int32)
        return self


_workspaces = {}
_workspaces_lock = threading.Lock()


def _workspace(x2d, stream):
    """The workspace of ``x2d``'s device and ``stream`` (a handle)."""
    key = (x2d.device.index, stream)
    with _workspaces_lock:
        ws = _workspaces.get(key)
        if ws is None:
            ws = _workspaces[key] = _Workspace(x2d.device)
    return ws


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(status, name):
    if status != 0:
        raise RuntimeError("{} kernel launch failed: {}".format(
            name, "unsupported dtype or geometry" if status == -1 else "CUDA error {}".format(status)))


def _check(x2d, *vecs, dy=None):
    """Validate a CUDA launch's operands; the kernels take row-major
    ``[R, C]`` activations and ``[C]`` float32 per-channel vectors."""
    if x2d.dim() != 2 or not x2d.is_contiguous():
        raise ValueError("expected a contiguous [R, C] activation, got {} {}".format(
            tuple(x2d.shape), x2d.stride()))
    if x2d.shape[0] < 1 or x2d.shape[1] < 1:
        raise ValueError("expected at least one row and one channel, got {}".format(tuple(x2d.shape)))
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


def _all_reduce(t):
    """Sum ``t`` over the ranks, in place."""
    import torch.distributed as dist

    dist.all_reduce(t)
    return t


def _on_card(x2d):
    """True when the kernel must launch; False for a CPU tensor (plain
    version). Any other device raises: there is no silent fallback."""
    if x2d.device.type == "cuda":
        return True
    if x2d.device.type == "cpu":
        return False
    raise RuntimeError("fused BN kernels run on CUDA; got a tensor on {}".format(x2d.device))


# -- plain versions (the reference for tests and chip_smoke.py) -------------


def stats_from_sums(sum_x, sum_sq, n_rows):
    """``(mean, biased var)`` from f32 ``[C]`` sums of x and x² by the
    reference's formula in f32: ``mean = Σx/R``, ``var = max(Σx²/R −
    mean², 0)``, with 1/R a factor rounded to f32 (what PyTorch's CUDA
    division by a scalar does, spelled out so that the kernel and every
    device round alike)."""
    inv_n = 1.0 / n_rows
    mean = sum_x * inv_n
    return mean, torch.clamp_min(sum_sq * inv_n - mean * mean, 0.0)


def bn_stats_sums_plain(x2d):
    """``[Σx, Σx²]`` per channel as f64 ``[2, C]``: the split mode of
    ``bn_stats``, summed in f64."""
    xd = x2d.double()
    return torch.stack([xd.sum(0), xd.square().sum(0)])


def bn_finish_plain(sums, n_rows, stats):
    """The split mode's finish on f64 ``[2, C]`` sums: each rounded to f32
    once; with ``stats`` they become ``(mean, var)`` over ``n_rows``."""
    a, b = sums.float()
    return stats_from_sums(a, b, float(n_rows)) if stats else (a, b)


def bn_stats_sums_f32(x2d):
    """``[Σx, Σx²]`` per channel as f32 ``[2, C]``, summed in f32 as the
    JAX package's flax BatchNorm reduces (``E[x]``, ``E[x²]`` of the input
    promoted to f32)."""
    xf = x2d.float()
    return torch.stack([xf.sum(0), xf.square().sum(0)])


class _PlainStats(torch.autograd.Function):
    """The statistics from sums rounded once to f32 — f64 sums with
    ``exact`` (the checks' yardstick), else f32 sums (the flax training
    path) — and their gradient by the f32 formula ``dx = (g_mean +
    2·g_var·(x − mean)) / R`` (none through a clamped var), so that
    autograd keeps ``x2d`` and no wider copy. With more than one rank the
    sums, and in the backward ``g_mean`` and ``g_var``, are summed over the
    ranks (in the sums' dtype) and R is the global row count."""

    @staticmethod
    def forward(ctx, x2d, exact):
        world = util.world_size()
        sums = bn_stats_sums_plain(x2d) if exact else bn_stats_sums_f32(x2d)
        if world > 1:
            _all_reduce(sums)
        n_rows = x2d.shape[0] * world
        mean, var = bn_finish_plain(sums, n_rows, True)
        sum_sq = sums[1].float()
        del sums
        ctx.save_for_backward(x2d, mean, sum_sq * (1.0 / n_rows) - mean * mean >= 0.0)
        ctx.world = world
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x2d, mean, live = ctx.saved_tensors
        g_var = torch.where(live, g_var, 0.0)
        if ctx.world > 1:
            g_mean, g_var = _all_reduce(torch.stack([g_mean, g_var]))
        n_rows = x2d.shape[0] * ctx.world
        return ((g_mean + 2.0 * g_var * (x2d.float() - mean)) / n_rows).to(x2d.dtype), None


def bn_stats_plain(x2d):
    """``bn_stats``' plain version, the yardstick of the checks: f64 sums,
    each rounded once to f32 (differentiable)."""
    return _PlainStats.apply(x2d, True)


def bn_stats_f32(x2d):
    """The flax BatchNorm's statistics: f32 sums, as the JAX package's
    ``nn.BatchNorm`` computes them (differentiable)."""
    return _PlainStats.apply(x2d, False)


def bn_normalize_plain(x2d, mean, var, gamma, beta, eps):
    scale = torch.rsqrt(var + eps) * gamma
    return ((x2d.float() - mean) * scale + beta).to(x2d.dtype)


def bn_bwd_reduce_plain(x2d, dy2d, mean, var, eps):
    dyf = dy2d.float()
    xhat = (x2d.float() - mean) * torch.rsqrt(var + eps)
    return (dyf * xhat).sum(0), dyf.sum(0)


def bn_bwd_reduce_sums_plain(x2d, dy2d, mean, var, eps):
    """``[Σdy·x̂, Σdy]`` per channel as f64 ``[2, C]`` (the f32 products
    summed in f64): the split mode of ``bn_bwd_reduce``."""
    dyf = dy2d.float()
    xhat = (x2d.float() - mean) * torch.rsqrt(var + eps)
    return torch.stack([(dyf * xhat).double().sum(0), dyf.double().sum(0)])


def bn_bwd_dx_plain(x2d, dy2d, mean, var, gamma, dgamma, dbeta, eps, n_rows=None):
    n_rows = float(x2d.shape[0] if n_rows is None else n_rows)
    inv = torch.rsqrt(var + eps)
    xhat = (x2d.float() - mean) * inv
    dx = (gamma * inv / n_rows) * (n_rows * dy2d.float() - dbeta - xhat * dgamma)
    return dx.to(x2d.dtype)


# -- kernel wrappers ----------------------------------------------------------


def _outputs(n_ch, device, split):
    """A reduction's outputs: two f32 ``[C]`` tensors, or for its split mode
    the f64 ``[2, C]`` sums (``(out0, out1, sums)``, unused ones None)."""
    if split:
        return None, None, torch.empty(2, n_ch, device=device, dtype=torch.float64)
    out0 = torch.empty(n_ch, device=device, dtype=torch.float32)
    return out0, torch.empty_like(out0), None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_stats(x2d, split):
    _check(x2d)
    lib = _load()
    rows, n_ch = x2d.shape
    stream = _stream(x2d)
    ws = _workspace(x2d, stream)
    g = reduce_geometry(rows, n_ch, x2d.element_size(), 1, _vector_path(x2d), ws.n_sms)
    ws.reserve(g, n_ch)
    mean, var, sums = _outputs(n_ch, x2d.device, split)
    _raise_on(lib.tos_bn_stats(
        x2d.data_ptr(), _DTYPES[x2d.dtype], int(g.vec), rows, n_ch, g.lanes, g.rows_per_split,
        g.strips, g.splits, ws.partials.data_ptr(), ws.counters.data_ptr(), _ptr(mean), _ptr(var),
        _ptr(sums), stream,
    ), "bn_stats")
    bn_stats.launches += 1
    return sums if split else (mean, var)


def bn_stats(x2d):
    """Per-channel batch mean and biased variance of ``x2d [R, C]`` as two
    float32 ``[C]`` tensors (replaces ``_stats_kernel`` / ``_bn_stats``)."""
    if not _on_card(x2d):
        return bn_stats_plain(x2d)
    return _launch_stats(x2d, False)


def bn_stats_sums(x2d):
    """The split mode of ``bn_stats``: ``[Σx, Σx²]`` per channel as f64
    ``[2, C]``, for an all-reduce across ranks and :func:`bn_finish` after
    it. Launches the ``bn_stats`` kernel (and counts in its ``launches``)."""
    if not _on_card(x2d):
        return bn_stats_sums_plain(x2d)
    return _launch_stats(x2d, True)


def bn_finish(sums, n_rows, stats):
    """The split mode's finish: f64 ``[2, C]`` sums (all-reduced) to two f32
    ``[C]`` tensors, rounded as the single launch's finisher rounds them:
    ``(mean, var)`` over ``n_rows`` rows with ``stats``, else the two sums
    (``(dgamma, dbeta)`` after :func:`bn_bwd_reduce_sums`)."""
    if not _on_card(sums):
        return bn_finish_plain(sums, n_rows, stats)
    if sums.dim() != 2 or sums.shape[0] != 2 or sums.dtype != torch.float64 or not sums.is_contiguous():
        raise ValueError("expected contiguous float64 [2, C] sums, got {} {}".format(
            tuple(sums.shape), sums.dtype))
    lib = _load()
    n_ch = sums.shape[1]
    out0 = torch.empty(n_ch, device=sums.device, dtype=torch.float32)
    out1 = torch.empty_like(out0)
    _raise_on(lib.tos_bn_finish(sums.data_ptr(), n_ch, int(n_rows), int(bool(stats)),
                                out0.data_ptr(), out1.data_ptr(), _stream(sums)), "bn_finish")
    bn_finish.launches += 1
    return out0, out1


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


def _launch_bwd_reduce(x2d, dy2d, mean, var, eps, split):
    _check(x2d, mean, var, dy=dy2d)
    lib = _load()
    rows, n_ch = x2d.shape
    stream = _stream(x2d)
    ws = _workspace(x2d, stream)
    g = reduce_geometry(rows, n_ch, x2d.element_size(), 2, _vector_path(x2d, dy2d), ws.n_sms)
    ws.reserve(g, n_ch)
    dgamma, dbeta, sums = _outputs(n_ch, x2d.device, split)
    _raise_on(lib.tos_bn_bwd_reduce(
        x2d.data_ptr(), dy2d.data_ptr(), mean.data_ptr(), var.data_ptr(), float(eps),
        _DTYPES[x2d.dtype], int(g.vec), rows, n_ch, g.lanes, g.rows_per_split, g.strips, g.splits,
        ws.partials.data_ptr(), ws.counters.data_ptr(), _ptr(dgamma), _ptr(dbeta), _ptr(sums), stream,
    ), "bn_bwd_reduce")
    bn_bwd_reduce.launches += 1
    return sums if split else (dgamma, dbeta)


def bn_bwd_reduce(x2d, dy2d, mean, var, eps):
    """``(dgamma, dbeta) = (Σ dy·x̂, Σ dy)`` per channel in float32, x̂
    recomputed from the saved statistics (replaces ``_bwd_reduce_kernel``)."""
    if not _on_card(x2d):
        return bn_bwd_reduce_plain(x2d, dy2d, mean, var, eps)
    return _launch_bwd_reduce(x2d, dy2d, mean, var, eps, False)


def bn_bwd_reduce_sums(x2d, dy2d, mean, var, eps):
    """The split mode of ``bn_bwd_reduce``: ``[Σdy·x̂, Σdy]`` per channel as
    f64 ``[2, C]``, for an all-reduce across ranks and :func:`bn_finish`
    after it. Launches the ``bn_bwd_reduce`` kernel (and counts in its
    ``launches``)."""
    if not _on_card(x2d):
        return bn_bwd_reduce_sums_plain(x2d, dy2d, mean, var, eps)
    return _launch_bwd_reduce(x2d, dy2d, mean, var, eps, True)


def bn_bwd_dx(x2d, dy2d, mean, var, gamma, dgamma, dbeta, eps, n_rows=None):
    """``dx = (gamma·inv/N)·(N·dy − dbeta − x̂·dgamma)`` cast to ``x2d``'s
    dtype (replaces ``_bwd_dx_kernel``). ``N`` is the row count of the
    statistics: ``x2d``'s rows unless ``n_rows`` says otherwise (the
    global batch's under data parallelism)."""
    if not _on_card(x2d):
        return bn_bwd_dx_plain(x2d, dy2d, mean, var, gamma, dgamma, dbeta, eps, n_rows)
    _check(x2d, mean, var, gamma, dgamma, dbeta, dy=dy2d)
    k = _build()
    rows, n_ch = x2d.shape
    block_r, block_c = _blocks(n_ch)
    dx = torch.empty_like(x2d)
    k["bwd_dx"][(_cdiv(rows, block_r), _cdiv(n_ch, block_c))](
        x2d, dy2d, mean, var, gamma, dgamma, dbeta, dx, rows, n_ch,
        float(rows if n_rows is None else n_rows), float(eps),
        BLOCK_R=block_r, BLOCK_C=block_c,
    )
    bn_bwd_dx.launches += 1
    return dx


#: the four kernel wrappers of this module, in pass order
KERNELS = (bn_stats, bn_normalize, bn_bwd_reduce, bn_bwd_dx)
#: every wrapper that counts its launches: the four, and the split mode's
#: finish (launched only with more than one rank)
COUNTED = KERNELS + (bn_finish,)
for _fn in COUNTED:
    _fn.launches = 0
#: the device kernel each wrapper launches, as a profiler trace names it
#: (``ops/kernel_trace.py`` counts a replayed graph's launches by it)
bn_stats.kernel_names = ("bn_stats_kernel",)
bn_normalize.kernel_names = ("normalize",)
bn_bwd_reduce.kernel_names = ("bn_bwd_reduce_kernel",)
bn_bwd_dx.kernel_names = ("bwd_dx",)
bn_finish.kernel_names = ("bn_finish_kernel",)


def launch_counts():
    """``{wrapper name: kernel launches}`` in this process."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts():
    for fn in COUNTED:
        fn.launches = 0


# -- autograd + public API ----------------------------------------------------


class _FusedBN2d(torch.autograd.Function):
    """The JAX package's ``_fused_bn_2d`` custom VJP: forward = stats +
    normalize, backward = reduce + dx. ``mean``/``var`` are outputs without
    a gradient; their dependence on ``x`` is folded into ``dx``. With more
    than one rank the two reductions run split, their sums all-reduced, and
    ``dx`` takes the global row count (module docstring)."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, eps):
        world = util.world_size()
        if world == 1:
            mean, var = bn_stats(x2d)
        else:
            mean, var = bn_finish(_all_reduce(bn_stats_sums(x2d)), x2d.shape[0] * world, True)
        y = bn_normalize(x2d, mean, var, gamma, beta, eps)
        ctx.save_for_backward(x2d, gamma, mean, var)
        ctx.eps, ctx.world = eps, world
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x2d, gamma, mean, var = ctx.saved_tensors
        dy = dy.contiguous()
        if ctx.world == 1:
            dgamma, dbeta = bn_bwd_reduce(x2d, dy, mean, var, ctx.eps)
            dx = bn_bwd_dx(x2d, dy, mean, var, gamma, dgamma, dbeta, ctx.eps)
        else:
            # dx takes the global sums; the parameters' gradient is this
            # rank's share of them, which the strategy's average over the
            # ranks turns back into the global batch's
            n_rows = x2d.shape[0] * ctx.world
            sums = _all_reduce(bn_bwd_reduce_sums(x2d, dy, mean, var, ctx.eps))
            dgamma, dbeta = bn_finish(sums, n_rows, False)
            dx = bn_bwd_dx(x2d, dy, mean, var, gamma, dgamma, dbeta, ctx.eps, n_rows)
            dgamma, dbeta = dgamma / ctx.world, dbeta / ctx.world
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
    Statistics are over the global batch under data parallelism, as the
    JAX package's fused module computes them inside its SPMD step."""

    def _train_forward(self, x):
        return fused_batch_norm(x, self.weight, self.bias, self.eps)


class BatchNorm(_BatchNormBase):
    """``bn_impl="flax"``: plain PyTorch math, differentiated by autograd
    through the batch statistics, which are summed in f32 as the JAX
    package's flax BatchNorm sums them (:func:`bn_stats_f32`). Statistics
    are over the global batch under data parallelism (an f32 all-reduce),
    as the JAX package's flax BN computes them inside its SPMD step."""

    stats = staticmethod(bn_stats_f32)

    def _train_forward(self, x):
        n_ch = x.shape[-1]
        x2d = x.reshape(-1, n_ch)
        mean, var = self.stats(x2d)
        y2d = bn_normalize_plain(x2d, mean, var, self.weight, self.bias, self.eps)
        return y2d.reshape(x.shape), mean.detach(), var.detach()


class PlainBatchNorm(BatchNorm):
    """``bn_impl="plain"``: the four kernels' plain versions composed, with
    the statistics from f64 sums (:func:`bn_stats_plain`): the yardstick a
    train step through the kernels is held against. Not a training option
    of the examples: f64 sums cost a step more than the f32 ones."""

    stats = staticmethod(bn_stats_plain)
