"""Flash attention as three CUDA C++ kernels for Hopper (+ autograd).

The counterpart of the JAX package's ``ops/flash_attention.py``, whose three
Pallas TPU kernels become three hand-written kernels in
``csrc/flash_attention.cu`` (``sm_90a``), over ``[BH, L, D]`` operands:

=================  ===========================================  =================
wrapper             computes                                     replaces (JAX pkg)
=================  ===========================================  =================
``flash_fwd``       online softmax over K/V blocks → O, lse       ``_fwd_kernel``
``flash_bwd_dq``    dq = Σ ds·K, ds = p·(dO·Vᵀ − delta)·scale      ``_bwd_dq_kernel``
``flash_bwd_dkv``   dv = Σ pᵀ·dO, dk = Σ dsᵀ·Q                    ``_bwd_dkv_kernel``
=================  ===========================================  =================

Each kernel skips the blocks that the causal mask empties (the bf16 kernels
also those that the fence empties), applies the causal mask and the
packed-sequence fence (``seg_q == seg_k``) with the same finite sentinel as
the TPU kernels, and keeps its sums in f32; ``p`` and ``ds`` are cast to the
input dtype before the second product, as there.
``lse`` is ``[BH, L]`` f32 (the TPU's ``[BH, L, 8]`` lanes are a tiling
artifact) and segment ids stay ``[B, L]`` int32, read at ``bh // heads``.

**Bound.** Every kernel is a chain of matrix products (2, 3 and 4 of
``2·D`` flops per attended (q, k) pair) over ``O(L·D)`` bytes: the tensor
cores (H100 SXM: 989 TFLOP/s dense bf16) bound the work the causal mask
leaves; the packed-sequence fence masks most of it, and then the bytes
(3.35 TB/s) bound the data's own work.

**Design.** float32 (right and simple first): one CTA of 4 warps per (bh,
64-row block), tiles, scores and accumulators staged in shared memory,
products on a plain FMA path (never TF32). The three bf16 kernels are built
for Hopper: one warpgroup a CTA, ``wgmma`` products with f32 accumulators
in registers, TMA loads into 128-byte-swizzled tiles through an
``mbarrier`` ring of 2–3 stages (the next block's tiles in flight while the
tensor cores work), and the fence-aware block skip (``visited_blocks`` is
its plain mirror): a block pair whose segment-id ranges do not overlap is
never visited. The forward keeps its online softmax in the accumulators'
registers, in the log2 domain, with P rounded to bf16 as the register
operand of O += P·V; dk/dv computes its scores transposed, so that Pᵀ and
dSᵀ come out of the accumulators as the next product's register operand.
Every CTA owns its output rows, so the sums are deterministic.

**No block rule.** The JAX package needs blocks that tile L exactly
(``_pick_block``: Pallas pads a ragged block with garbage), and its
transformer pads L up to a multiple of 128 (exact under the causal mask and
the fence, since padded keys are never attended). These kernels mask the
ragged tail instead (rows past L are never stored, keys past L get exactly
zero weight), so every L runs unpadded and gives the rows the padded run
gives.

**Dispatch.** Each wrapper takes its plain PyTorch version (the ``*_plain``
functions, the reference for tests and ``chip_smoke.py``) only when its
input lies on the CPU; on a CUDA tensor it launches the kernel or raises
(unsupported head dim or dtype, failed build, refused launch), and counts
the launch in its ``launches`` attribute (under CUDA graph capture, the
launch into the graph; a replay calls no wrapper, and
``ops/kernel_trace.py`` counts its kernels from a trace). The kernels are compiled with
``nvcc`` at the first CUDA launch (never at import) into ``build/cuda`` in
the checkout, keyed by a hash of the source and flags, and bound through
``ctypes``; the tensor maps of the TMA loads are encoded through the
runtime's driver entry point (no ``-lcuda``).
"""

import ctypes
import math
import os
import re
import threading

import torch

from tensorflowonspark_tpu_torch.ops import cuda_build

#: the TPU kernels' finite masked-score sentinel (−inf would turn a fully
#: masked block's running-max correction into NaN)
NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)
#: head dims the kernels are compiled for
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SOURCE = os.path.join(cuda_build.CSRC, "flash_attention.cu")
BUILD_DIR = cuda_build.BUILD_DIR

_lib = None
_lib_lock = threading.Lock()


def build(source=SOURCE, build_dir=BUILD_DIR):
    """Compile the kernels if this source has no build yet; returns the
    path of the library (:func:`cuda_build.build`)."""
    return cuda_build.build(source, build_dir)


def bind(path):
    """The kernels' C interface of the library at ``path`` (``ctypes``)."""
    lib = ctypes.CDLL(path)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tos_flash_fwd.argtypes = [ptr] * 6 + [i32] * 5 + [f32, i32, ptr]
    lib.tos_flash_bwd_dq.argtypes = [ptr] * 8 + [i32] * 5 + [f32, i32, ptr]
    lib.tos_flash_bwd_dkv.argtypes = [ptr] * 9 + [i32] * 5 + [f32, i32, ptr]
    for fn in (lib.tos_flash_fwd, lib.tos_flash_bwd_dq, lib.tos_flash_bwd_dkv):
        fn.restype = i32
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(build())
    return _lib


def kernel_resources(log_path=None):
    """Registers and spill bytes of each compiled kernel, read from the
    ``-Xptxas -v`` log that :func:`build` writes beside the library:
    ``[{"kernel", "dtype", "head_dim", "registers", "spill_stores",
    "spill_loads"}, ...]``."""
    out = []
    for entry in cuda_build.ptxas_report(log_path or cuda_build.library_path(SOURCE)[:-3] + ".log"):
        name = entry.pop("entry")
        kernel = next((k for k in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                                   "flash_bwd_dkv_wgmma_kernel", "flash_fwd_kernel",
                                   "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel") if k in name), name)
        dim = re.search(r"I(?:f|13__nv_bfloat16)?Li(\d+)E", name)
        out.append(dict(entry, kernel=kernel,
                        dtype="float32" if re.search(r"IfLi\d+E", name) else "bfloat16",
                        head_dim=int(dim.group(1)) if dim else None))
    return out


# -- checks -------------------------------------------------------------------


def _on_card(t):
    """True when the kernel must launch; False for a CPU tensor (plain
    version). Any other device raises: there is no silent fallback."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError("flash attention kernels run on CUDA; got a tensor on {}".format(t.device))


def _check(q, seg, heads, like=(), rows=()):
    """Validate a CUDA launch: ``[BH, L, D]`` operands of one dtype and
    shape, contiguous and 16-byte aligned; ``[BH, L]`` f32 row statistics;
    ``[B, L]`` int32 segment ids with ``B·heads == BH``."""
    if q.dim() != 3:
        raise ValueError("expected [BH, L, D] operands, got {}".format(tuple(q.shape)))
    bh, length, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError("flash attention kernels take head_dim in {}, got {}".format(HEAD_DIMS, d))
    if q.dtype not in _DTYPES:
        raise TypeError("flash attention kernels take float32 or bfloat16, got {}".format(q.dtype))
    for t in (q,) + tuple(like):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("operands must be contiguous, aligned {} {} on {}; got {} {} on {}".format(
                tuple(q.shape), q.dtype, q.device, tuple(t.shape), t.dtype, t.device))
    for t in rows:
        if (t.shape != (bh, length) or t.dtype != torch.float32 or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError("row statistics must be contiguous float32 [{}, {}] on {}".format(
                bh, length, q.device))
    if seg is not None:
        if (seg.dim() != 2 or seg.shape[1] != length or seg.shape[0] * heads != bh
                or seg.dtype != torch.int32 or not seg.is_contiguous() or seg.device != q.device):
            raise ValueError("segment ids must be contiguous int32 [BH/heads, {}] on {}; got {} {}"
                             .format(length, q.device, tuple(seg.shape), seg.dtype))


_STATUS = {-1: "unsupported head dim or dtype",
           -2: "the driver's tensor-map encoder is missing or refused the operands"}


def _raise_on(status, name):
    if status != 0:
        raise RuntimeError("{} kernel launch failed: {}".format(
            name, _STATUS.get(status, "CUDA error {}".format(status))))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# -- plain versions (the reference for tests and chip_smoke.py) -------------


def visited_blocks(seg, causal, block=64):
    """The plain mirror of the bf16 kernels' block skip
    (``visit_list`` in the CUDA source): ``[B, n, n]`` booleans, True where
    the (q block, kv block) pair of a row of ``seg`` (``int [B, L]``) is
    visited, ``n = ceil(L / block)``. A pair is skipped when the causal mask
    empties it (kv block after the q block) or when the ``[min, max]``
    segment-id ranges of its two blocks do not overlap, which holds no pair
    of equal ids. Pass zeros for no fence."""
    seg = torch.as_tensor(seg)
    b, length = seg.shape
    n = -(-length // block)
    pad = n * block - length
    info = torch.iinfo(seg.dtype)
    lo = torch.nn.functional.pad(seg, (0, pad), value=info.max).view(b, n, block).amin(-1)
    hi = torch.nn.functional.pad(seg, (0, pad), value=info.min).view(b, n, block).amax(-1)
    visit = (hi[:, :, None] >= lo[:, None, :]) & (lo[:, :, None] <= hi[:, None, :])
    if causal:
        visit &= torch.ones(n, n, dtype=torch.bool, device=seg.device).tril()
    return visit


def _masked_scores(q, k, seg, scale, causal, heads):
    """Dense f32 scores ``[BH, L, L]`` with the kernels' masks: the
    sentinel where the causal mask or the segment fence drops a score."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    length = q.shape[1]
    if causal:
        pos = torch.arange(length, device=q.device)
        s = torch.where((pos[:, None] >= pos[None, :])[None], s, NEG_BIG)
    if seg is not None:
        seg_bh = seg.repeat_interleave(heads, dim=0)
        s = torch.where(seg_bh[:, :, None] == seg_bh[:, None, :], s, NEG_BIG)
    return s


def flash_fwd_plain(q, k, v, seg, scale, causal, heads):
    """``(o, lse)`` from dense masked scores in f32; ``p`` is cast to the
    input dtype before the product with ``v``, as in the kernel."""
    s = _masked_scores(q, k, seg, scale, causal, heads)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    o = torch.einsum("bqk,bkd->bqd", p.to(q.dtype).float(), v.float()) / denom
    return o.to(q.dtype), (m + torch.log(denom)).squeeze(-1)


def _probs_and_ds(q, k, v, seg, do, lse, delta, scale, causal, heads):
    s = _masked_scores(q, k, seg, scale, causal, heads)
    p = torch.exp(s - lse[:, :, None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    return p, p * (dp - delta[:, :, None]) * scale


def flash_bwd_dq_plain(q, k, v, seg, do, lse, delta, scale, causal, heads):
    """``dq = ds·K`` with ``p`` recomputed from ``lse`` (f32, ``ds`` cast to
    the input dtype before the product)."""
    _, ds = _probs_and_ds(q, k, v, seg, do, lse, delta, scale, causal, heads)
    return torch.einsum("bqk,bkd->bqd", ds.to(q.dtype).float(), k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, seg, do, lse, delta, scale, causal, heads):
    """``(dk, dv) = (dsᵀ·Q, pᵀ·dO)`` (f32, ``p``/``ds`` cast to the input
    dtype before the products)."""
    p, ds = _probs_and_ds(q, k, v, seg, do, lse, delta, scale, causal, heads)
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bqk,bqd->bkd", p.to(q.dtype).float(), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# -- kernel wrappers ----------------------------------------------------------


def flash_fwd(q, k, v, seg, scale, causal, heads):
    """``(o [BH, L, D], lse [BH, L] f32)`` of attention over ``[BH, L, D]``
    operands (replaces ``_fwd_kernel``)."""
    if not _on_card(q):
        return flash_fwd_plain(q, k, v, seg, scale, causal, heads)
    _check(q, seg, heads, like=(k, v))
    lib = _load()
    bh, length, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, length), device=q.device, dtype=torch.float32)
    _raise_on(lib.tos_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg), o.data_ptr(), lse.data_ptr(),
        bh, heads, length, d, _DTYPES[q.dtype], float(scale), int(bool(causal)), _stream(q),
    ), "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, seg, do, lse, delta, scale, causal, heads):
    """``dq [BH, L, D]`` (replaces ``_bwd_dq_kernel``)."""
    if not _on_card(q):
        return flash_bwd_dq_plain(q, k, v, seg, do, lse, delta, scale, causal, heads)
    _check(q, seg, heads, like=(k, v, do), rows=(lse, delta))
    lib = _load()
    bh, length, d = q.shape
    dq = torch.empty_like(q)
    _raise_on(lib.tos_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), bh, heads, length, d, _DTYPES[q.dtype], float(scale),
        int(bool(causal)), _stream(q),
    ), "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, seg, do, lse, delta, scale, causal, heads):
    """``(dk, dv)``, each ``[BH, L, D]`` (replaces ``_bwd_dkv_kernel``)."""
    if not _on_card(q):
        return flash_bwd_dkv_plain(q, k, v, seg, do, lse, delta, scale, causal, heads)
    _check(q, seg, heads, like=(k, v, do), rows=(lse, delta))
    lib = _load()
    bh, length, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _raise_on(lib.tos_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, heads, length, d, _DTYPES[q.dtype],
        float(scale), int(bool(causal)), _stream(q),
    ), "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


#: the three kernel wrappers of this module, forward first
KERNELS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
for _fn in KERNELS:
    _fn.launches = 0
    #: the device kernels it launches (f32, bf16), as a profiler trace
    #: names them (``ops/kernel_trace.py`` counts a replayed graph's by them)
    _fn.kernel_names = (_fn.__name__ + "_kernel", _fn.__name__ + "_wgmma_kernel")


def launch_counts():
    """``{wrapper name: kernel launches}`` in this process."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts():
    for fn in KERNELS:
        fn.launches = 0


# -- autograd + public API ----------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``_flash_attention_bhld`` custom VJP: saves
    ``q, k, v, seg, o, lse``; ``delta = rowsum(dO·O)`` in f32 is plain
    tensor math between the kernels; segment ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg, scale, causal, heads):
        o, lse = flash_fwd(q, k, v, seg, scale, causal, heads)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.args = (scale, causal, heads)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        scale, causal, heads = ctx.args
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        dq = flash_bwd_dq(q, k, v, seg, do, lse, delta, scale, causal, heads)
        dk, dv = flash_bwd_dkv(q, k, v, seg, do, lse, delta, scale, causal, heads)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal=False, scale=None, segment_ids=None):
    """Flash attention over ``[batch, heads, seq, head_dim]`` tensors, the
    port of the JAX package's ``flash_attention`` (no block sizes: any
    sequence length runs, see the module docstring).

    ``segment_ids`` (``int [batch, seq]``, 0 = padding) fences packed
    sequences: scores between positions with different ids are masked.
    Ids are shared across heads and carry no gradient.
    """
    b, h, length, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    merge = lambda t: t.reshape(b * h, t.shape[2], d).contiguous()  # noqa: E731
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    o = _FlashAttention.apply(merge(q), merge(k), merge(v), seg, float(scale), bool(causal), h)
    return o.reshape(b, h, length, d)
