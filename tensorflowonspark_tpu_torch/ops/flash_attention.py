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
The keys may carry ids of their own (``seg_k``, the queries' ``seg`` by
default): a ring attention hop (``parallel/ring_attention.py``) attends
this member's queries to another member's keys. ``out_dtype=torch.float32``
makes a bf16 kernel write its outputs in f32, so that the partial results
a ring sums over its hops are not each rounded to bf16 first.

**Bound.** Every kernel is a chain of matrix products (2, 3 and 4 of
``2·D`` flops per attended (q, k) pair) over ``O(L·D)`` bytes: the tensor
cores (H100 SXM: 989 TFLOP/s dense bf16) bound the work the causal mask
leaves; the packed-sequence fence masks most of it, and then the bytes
(3.35 TB/s) bound the data's own work.

**Design.** float32 (right and simple first): one CTA of 4 warps per (bh,
64-row block; 32 rows at D = 256, where 64-row tiles pass the 227 KB of
shared memory a CTA can hold), tiles, scores and accumulators staged in
shared memory, products on a plain FMA path (never TF32). The three bf16 kernels are built
for Hopper: one warpgroup a CTA, ``wgmma`` products with f32 accumulators
in registers, TMA loads into 128-byte-swizzled tiles through an
``mbarrier`` ring of 2–3 stages (the next block's tiles in flight while the
tensor cores work), and the fence-aware block skip (``visited_blocks`` is
its plain mirror): a block pair whose segment-id ranges do not overlap is
never visited. The forward keeps its online softmax in the accumulators'
registers, in the log2 domain, with P rounded to bf16 as the register
operand of O += P·V; dk/dv computes its scores transposed, so that Pᵀ and
dSᵀ come out of the accumulators as the next product's register operand.
At D = 256 a 64 × 256 f32 accumulator takes 128 of a thread's 255
registers, so a CTA holds one: the bf16 kernels run one CTA an SM, and
dk/dv runs as two passes side by side (the grid's z: dv, then dk), each
recomputing Sᵀ. Above D = 256 the split-D kernels (``*_split_kernel``,
``*_split_wgmma_kernel``) split D on the grid's z: each CTA owns a chunk
of :data:`SPLIT_CHUNK` output columns (so its accumulator is the D = 256
one), and the score products over the whole D run as a loop over
:data:`SPLIT_PANEL`-column panels, ``S = Σ_p Q_p·K_pᵀ`` summed in f32, each
chunk's CTA recomputing them; dk and dv are a pass each a chunk in bf16
(:func:`flash_fwd_split_plain` and its two siblings are their plain
mirrors, in the kernels' order). Every CTA owns its output rows and
columns, so the sums are deterministic.

**No block rule.** The JAX package needs blocks that tile L exactly
(``_pick_block``: Pallas pads a ragged block with garbage), and its
transformer pads L up to a multiple of 128 (exact under the causal mask and
the fence, since padded keys are never attended). These kernels mask the
ragged tail instead (rows past L are never stored, keys past L get exactly
zero weight), so every L runs unpadded and gives the rows the padded run
gives.

**Head dims.** Every head dim runs. The kernels are compiled for D = 64,
128 and 256 (:data:`HEAD_DIMS`); any other D up to 256 runs at the next of
them, its operands zero-padded and its outputs sliced back, which is exact
(:func:`padded_fwd` and its two siblings, beside the wrappers). Above 256
the split-D kernels take D as it is where it is a multiple of
:data:`SPLIT_ALIGN` (the bf16 tensor maps' 16-byte rows; a panel that runs
past D is read as zeros) and the next such width otherwise, zero-padded
the same way. Their design has no upper bound: a CTA's shared memory and
registers do not grow with D (its work does, the scores being recomputed
for each chunk).

**Dispatch.** Each wrapper takes its plain PyTorch version (the ``*_plain``
functions, the reference for tests and ``chip_smoke.py``) only when its
input lies on the CPU; on a CUDA tensor it launches the kernel or raises
(head dim below 1, unsupported dtype, failed build, refused launch), and counts
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
#: head dims the kernels are compiled for; a launch at another head dim up
#: to the largest runs at the next of them, its operands zero-padded
#: (:func:`head_width`)
HEAD_DIMS = (64, 128, 256)
#: above the largest of HEAD_DIMS the split-D kernels run any head dim that
#: is a multiple of SPLIT_ALIGN; another is zero-padded to the next one
SPLIT_ALIGN = 8
#: output columns a split-D CTA owns, and the width of the panels its score
#: products loop over (the kernels' kChunk and TMA box)
SPLIT_CHUNK, SPLIT_PANEL = 256, 64
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
    lib.tos_flash_fwd.argtypes = [ptr] * 7 + [i32] * 5 + [f32, i32, i32, ptr]
    lib.tos_flash_bwd_dq.argtypes = [ptr] * 9 + [i32] * 5 + [f32, i32, i32, ptr]
    lib.tos_flash_bwd_dkv.argtypes = [ptr] * 10 + [i32] * 5 + [f32, i32, i32, ptr]
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
    "spill_loads"}, ...]``.
    The split-D kernels (any D above 256) report ``head_dim`` None."""
    names = [k for fn in KERNELS for k in fn.kernel_names]
    out = []
    for entry in cuda_build.ptxas_report(log_path or cuda_build.library_path(SOURCE)[:-3] + ".log"):
        name = entry.pop("entry")
        kernel = max((k for k in names if k in name), key=len, default=name)
        dim = re.search(r"I(?:f|13__nv_bfloat16)?Li(\d+)E", name)
        out.append(dict(entry, kernel=kernel, dtype="bfloat16" if "wgmma" in kernel else "float32",
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


def _check(q, seg, heads, like=(), rows=(), seg_k=None, out_dtype=None):
    """Validate a CUDA launch: ``[BH, L, D]`` operands of one dtype and
    shape, contiguous and 16-byte aligned; ``[BH, L]`` f32 row statistics;
    ``[B, L]`` int32 segment ids with ``B·heads == BH`` (the keys' too, and
    only beside the queries'); outputs in the input dtype or f32. Returns
    the outputs' dtype."""
    if q.dim() != 3:
        raise ValueError("expected [BH, L, D] operands, got {}".format(tuple(q.shape)))
    bh, length, d = q.shape
    head_width(d)
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
    if seg_k is not None and seg is None:
        raise ValueError("the keys' segment ids need the queries' (seg)")
    for ids in (seg, seg_k):
        if ids is not None and (ids.dim() != 2 or ids.shape[1] != length or ids.shape[0] * heads != bh
                                or ids.dtype != torch.int32 or not ids.is_contiguous() or ids.device != q.device):
            raise ValueError("segment ids must be contiguous int32 [BH/heads, {}] on {}; got {} {}"
                             .format(length, q.device, tuple(ids.shape), ids.dtype))
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError("flash attention kernels write {} or float32 outputs, not {}".format(q.dtype, out_dtype))
    return out_dtype


def head_width(d):
    """The head dim that a launch at head dim ``d`` runs at: the smallest of
    :data:`HEAD_DIMS` not below it, or above the largest the split-D
    kernels' width, ``d`` rounded up to a multiple of :data:`SPLIT_ALIGN`.
    Raises below 1; no upper bound."""
    if d < 1:
        raise ValueError("flash attention kernels take any head_dim from 1 (compiled for {}, smaller ones "
                         "zero-padded up to the next; above {} the split-D kernels at a multiple of {}), got {}"
                         .format(HEAD_DIMS, HEAD_DIMS[-1], SPLIT_ALIGN, d))
    for width in HEAD_DIMS:
        if d <= width:
            return width
    return -(-d // SPLIT_ALIGN) * SPLIT_ALIGN


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


def visited_blocks(seg, causal, block=64, seg_k=None):
    """The plain mirror of the bf16 kernels' block skip
    (``visit_list`` in the CUDA source): ``[B, n, n]`` booleans, True where
    the (q block, kv block) pair of a row of ``seg`` (``int [B, L]``, the
    queries' ids; ``seg_k`` the keys', default ``seg``) is visited,
    ``n = ceil(L / block)``. A pair is skipped when the causal mask
    empties it (kv block after the q block) or when the ``[min, max]``
    segment-id ranges of its two blocks do not overlap, which holds no pair
    of equal ids. Pass zeros for no fence."""

    def ranges(ids):
        ids = torch.as_tensor(ids)
        b, length = ids.shape
        n = -(-length // block)
        pad = n * block - length
        info = torch.iinfo(ids.dtype)
        lo = torch.nn.functional.pad(ids, (0, pad), value=info.max).view(b, n, block).amin(-1)
        hi = torch.nn.functional.pad(ids, (0, pad), value=info.min).view(b, n, block).amax(-1)
        return lo, hi, n

    lo, hi, n = ranges(seg)
    lo_k, hi_k, _ = ranges(seg if seg_k is None else seg_k)
    seg = torch.as_tensor(seg)
    visit = (hi[:, :, None] >= lo_k[:, None, :]) & (lo[:, :, None] <= hi_k[:, None, :])
    if causal:
        visit &= torch.ones(n, n, dtype=torch.bool, device=seg.device).tril()
    return visit


def _masked_scores(q, k, seg, scale, causal, heads, seg_k=None, scores=None):
    """Dense f32 scores ``[BH, L, L]`` with the kernels' masks: the
    sentinel where the causal mask or the segment fence (the queries' ids
    ``seg`` against the keys' ``seg_k``, default ``seg``) drops a score.
    ``scores``: the unscaled ``q·kᵀ`` when the caller has summed it already."""
    s = (torch.einsum("bqd,bkd->bqk", q.float(), k.float()) if scores is None else scores) * scale
    length = q.shape[1]
    if causal:
        pos = torch.arange(length, device=q.device)
        s = torch.where((pos[:, None] >= pos[None, :])[None], s, NEG_BIG)
    if seg is not None:
        seg_bh = seg.repeat_interleave(heads, dim=0)
        seg_k_bh = seg_bh if seg_k is None else seg_k.repeat_interleave(heads, dim=0)
        s = torch.where(seg_bh[:, :, None] == seg_k_bh[:, None, :], s, NEG_BIG)
    return s


def flash_fwd_plain(q, k, v, seg, scale, causal, heads, seg_k=None, out_dtype=None):
    """``(o, lse)`` from dense masked scores in f32; ``p`` is cast to the
    input dtype before the product with ``v``, as in the kernel; ``o`` in
    ``out_dtype`` (default the input's)."""
    s = _masked_scores(q, k, seg, scale, causal, heads, seg_k=seg_k)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    o = torch.einsum("bqk,bkd->bqd", p.to(q.dtype).float(), v.float()) / denom
    return o.to(out_dtype or q.dtype), (m + torch.log(denom)).squeeze(-1)


def flash_fwd_online_plain(q, k, v, seg, scale, causal, heads, seg_k=None, block=64):
    """The bf16 forward kernel's own arithmetic in plain PyTorch: the
    online softmax over kv blocks of ``block`` keys in order, in the log2
    domain, with ``p`` rounded to the input dtype against each block's
    running max (:func:`flash_fwd_plain` rounds it against the row's final
    max, which moves O by nearly one bf16 rounding).
    ``(o, lse)``, ``o`` in f32: the reference that holds the kernel's f32
    output well below one bf16 rounding. Rows that attend no key hold
    garbage, as in the kernel."""
    s = _masked_scores(q, k, seg, scale / math.log(2.0), causal, heads, seg_k=seg_k)
    return _online_softmax(s, v, q.dtype, block)


def _online_softmax(s, v, dtype, block):
    """``(o f32, lse)`` of log2-domain scores ``s`` ``[BH, L, L]`` over ``v``
    by the forward kernels' online softmax over kv blocks of ``block``."""
    bh, length, _ = s.shape
    m = torch.full((bh, length, 1), NEG_BIG, device=s.device)
    l = torch.zeros((bh, length, 1), device=s.device)
    acc = torch.zeros((bh, length, v.shape[-1]), device=s.device)
    for k0 in range(0, length, block):
        x = s[:, :, k0:k0 + block]
        mx = torch.maximum(m, x.amax(-1, keepdim=True))
        corr, p = torch.exp2(m - mx), torch.exp2(x - mx)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bqk,bkd->bqd", p.to(dtype).float(), v[:, k0:k0 + block].float())
        m = mx
    den = torch.clamp_min(l, 1e-30)
    return acc / den, (m * math.log(2.0) + torch.log(den)).squeeze(-1)


# -- the split-D kernels' order (head dims above 256) ---------------------------
#
# The plain mirrors of the split-D kernels, in their order: the score
# products S = Σ_p Q_p·K_pᵀ (and dP = Σ_p dO_p·V_pᵀ) summed in f32 over
# SPLIT_PANEL-column panels of D, in panel order; then each chunk of
# SPLIT_CHUNK output columns computed by itself from the recomputed scores
# (the forward's online softmax over kv blocks of ``block`` keys for each
# chunk; lse from chunk 0). Tests hold them against the JAX package's
# Pallas kernels at the real D.


def _panel_products(a, b, panel):
    """``Σ_p a_p·b_pᵀ`` over ``panel``-wide column panels, in f32, in order."""
    out = None
    for c0 in range(0, a.shape[-1], panel):
        part = torch.einsum("bqd,bkd->bqk", a[..., c0:c0 + panel].float(), b[..., c0:c0 + panel].float())
        out = part if out is None else out + part
    return out


def _split_masked_scores(q, k, seg, scale, causal, heads, seg_k, panel):
    s = _panel_products(q, k, panel)
    return _masked_scores(q, k, seg, scale, causal, heads, seg_k=seg_k, scores=s)


def flash_fwd_split_plain(q, k, v, seg, scale, causal, heads, seg_k=None, block=64, chunk=SPLIT_CHUNK,
                          panel=SPLIT_PANEL):
    """The split-D forward kernels' order: ``(o, lse)``, ``o`` in f32, each
    chunk of output columns by :func:`flash_fwd_online_plain`'s online
    softmax over the panel-summed scores (rows that attend no key hold
    garbage, as in the kernels)."""
    s = _split_masked_scores(q, k, seg, scale / math.log(2.0), causal, heads, seg_k, panel)
    parts = [_online_softmax(s, v[..., c0:c0 + chunk], q.dtype, block) for c0 in range(0, v.shape[-1], chunk)]
    return torch.cat([o for o, _ in parts], -1), parts[0][1]


def _split_probs_and_ds(q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k, panel):
    s = _split_masked_scores(q, k, seg, scale, causal, heads, seg_k, panel)
    p = torch.exp(s - lse[:, :, None])
    return p, p * (_panel_products(do, v, panel) - delta[:, :, None]) * scale


def flash_bwd_dq_split_plain(q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k=None, out_dtype=None,
                             chunk=SPLIT_CHUNK, panel=SPLIT_PANEL):
    """The split-D dq kernels' order: ``dq``, each chunk ``ds·K_c``."""
    _, ds = _split_probs_and_ds(q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k, panel)
    ds = ds.to(q.dtype).float()
    return torch.cat([torch.einsum("bqk,bkd->bqd", ds, k[..., c0:c0 + chunk].float())
                      for c0 in range(0, k.shape[-1], chunk)], -1).to(out_dtype or q.dtype)


def flash_bwd_dkv_split_plain(q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k=None, out_dtype=None,
                              chunk=SPLIT_CHUNK, panel=SPLIT_PANEL):
    """The split-D dk/dv kernels' order: ``(dk, dv)``, each chunk
    ``dsᵀ·Q_c`` and ``pᵀ·dO_c``."""
    p, ds = _split_probs_and_ds(q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k, panel)
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    cols = range(0, q.shape[-1], chunk)
    dk = torch.cat([torch.einsum("bqk,bqd->bkd", ds, q[..., c0:c0 + chunk].float()) for c0 in cols], -1)
    dv = torch.cat([torch.einsum("bqk,bqd->bkd", p, do[..., c0:c0 + chunk].float()) for c0 in cols], -1)
    return dk.to(out_dtype or k.dtype), dv.to(out_dtype or v.dtype)


def _probs_and_ds(q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k):
    s = _masked_scores(q, k, seg, scale, causal, heads, seg_k=seg_k)
    p = torch.exp(s - lse[:, :, None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    return p, p * (dp - delta[:, :, None]) * scale


def flash_bwd_dq_plain(q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k=None, out_dtype=None):
    """``dq = ds·K`` with ``p`` recomputed from ``lse`` (f32, ``ds`` cast to
    the input dtype before the product)."""
    _, ds = _probs_and_ds(q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k)
    return torch.einsum("bqk,bkd->bqd", ds.to(q.dtype).float(), k.float()).to(out_dtype or q.dtype)


def flash_bwd_dkv_plain(q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k=None, out_dtype=None):
    """``(dk, dv) = (dsᵀ·Q, pᵀ·dO)`` (f32, ``p``/``ds`` cast to the input
    dtype before the products)."""
    p, ds = _probs_and_ds(q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k)
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bqk,bqd->bkd", p.to(q.dtype).float(), do.float())
    return dk.to(out_dtype or k.dtype), dv.to(out_dtype or v.dtype)


# -- head-dim padding ----------------------------------------------------------
#
# The kernels are compiled for the head dims of HEAD_DIMS. Another head dim
# runs at the next compiled one, its [BH, L, D] operands zero-padded there,
# and its outputs sliced back: the padded columns add 0 to every score; dq =
# ds·K, dk = dsᵀ·Q and dv = pᵀ·dO are zero there because K, Q and dO are; lse
# and delta (taken by the caller over the real D) do not change. The caller's
# ``scale`` (from the real D) goes to the kernel as it is. ``launch`` is the
# kernel's launch, or on the CPU its plain version, which tests hold against
# the JAX package's kernels at the real D. A caller that launches several
# kernels on one operand pads it once (widen_heads) and narrows their
# outputs (narrow_heads); the wrappers then pad nothing.


def _widen(t, width):
    return t if t.shape[-1] == width else torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def widen_heads(t):
    """``t`` zero-padded along its last dim to the head width the kernels
    run it at, on the card (:func:`head_width`); as it is on the CPU."""
    return _widen(t, head_width(t.shape[-1])) if _on_card(t) else t


def narrow_heads(t, d):
    """``t`` cut back to head dim ``d`` (a kernel's output on operands
    from :func:`widen_heads`)."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def padded_fwd(launch, q, k, v, seg, scale, causal, heads, seg_k=None, out_dtype=None):
    """:func:`flash_fwd` through ``launch`` at the compiled head width."""
    d = q.shape[-1]
    width = head_width(d)
    o, lse = launch(*(_widen(t, width) for t in (q, k, v)), seg, scale, causal, heads, seg_k, out_dtype)
    return narrow_heads(o, d), lse


def padded_bwd_dq(launch, q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k=None, out_dtype=None):
    """:func:`flash_bwd_dq` through ``launch`` at the compiled head width."""
    d = q.shape[-1]
    width = head_width(d)
    q, k, v, do = (_widen(t, width) for t in (q, k, v, do))
    return narrow_heads(launch(q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k, out_dtype), d)


def padded_bwd_dkv(launch, q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k=None, out_dtype=None):
    """:func:`flash_bwd_dkv` through ``launch`` at the compiled head width."""
    d = q.shape[-1]
    width = head_width(d)
    q, k, v, do = (_widen(t, width) for t in (q, k, v, do))
    dk, dv = launch(q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k, out_dtype)
    return narrow_heads(dk, d), narrow_heads(dv, d)


# -- kernel wrappers ----------------------------------------------------------


def _launch_fwd(q, k, v, seg, scale, causal, heads, seg_k, out_dtype):
    lib = _load()
    bh, length, d = q.shape
    o = torch.empty(q.shape, device=q.device, dtype=out_dtype)
    lse = torch.empty((bh, length), device=q.device, dtype=torch.float32)
    _raise_on(lib.tos_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg), _ptr(seg_k), o.data_ptr(), lse.data_ptr(),
        bh, heads, length, d, _DTYPES[q.dtype], float(scale), int(bool(causal)),
        int(out_dtype != q.dtype), _stream(q),
    ), "flash_fwd")
    _count(flash_fwd)
    return o, lse


def _launch_bwd_dq(q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k, out_dtype):
    lib = _load()
    bh, length, d = q.shape
    dq = torch.empty(q.shape, device=q.device, dtype=out_dtype)
    _raise_on(lib.tos_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg), _ptr(seg_k), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), bh, heads, length, d, _DTYPES[q.dtype], float(scale),
        int(bool(causal)), int(out_dtype != q.dtype), _stream(q),
    ), "flash_bwd_dq")
    _count(flash_bwd_dq)
    return dq


def _launch_bwd_dkv(q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k, out_dtype):
    lib = _load()
    bh, length, d = q.shape
    dk, dv = (torch.empty(q.shape, device=q.device, dtype=out_dtype) for _ in range(2))
    _raise_on(lib.tos_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg), _ptr(seg_k), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, heads, length, d, _DTYPES[q.dtype],
        float(scale), int(bool(causal)), int(out_dtype != q.dtype), _stream(q),
    ), "flash_bwd_dkv")
    _count(flash_bwd_dkv)
    return dk, dv


def flash_fwd(q, k, v, seg, scale, causal, heads, seg_k=None, out_dtype=None):
    """``(o [BH, L, D], lse [BH, L] f32)`` of attention over ``[BH, L, D]``
    operands (replaces ``_fwd_kernel``); ``seg_k``: the keys' segment ids
    (default ``seg``); ``o`` in ``out_dtype`` (the input's, or f32)."""
    if not _on_card(q):
        return flash_fwd_plain(q, k, v, seg, scale, causal, heads, seg_k, out_dtype)
    out_dtype = _check(q, seg, heads, like=(k, v), seg_k=seg_k, out_dtype=out_dtype)
    return padded_fwd(_launch_fwd, q, k, v, seg, scale, causal, heads, seg_k, out_dtype)


def flash_bwd_dq(q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k=None, out_dtype=None):
    """``dq [BH, L, D]`` in ``out_dtype`` (replaces ``_bwd_dq_kernel``)."""
    if not _on_card(q):
        return flash_bwd_dq_plain(q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k, out_dtype)
    out_dtype = _check(q, seg, heads, like=(k, v, do), rows=(lse, delta), seg_k=seg_k, out_dtype=out_dtype)
    return padded_bwd_dq(_launch_bwd_dq, q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k, out_dtype)


def flash_bwd_dkv(q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k=None, out_dtype=None):
    """``(dk, dv)``, each ``[BH, L, D]`` in ``out_dtype`` (replaces
    ``_bwd_dkv_kernel``)."""
    if not _on_card(q):
        return flash_bwd_dkv_plain(q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k, out_dtype)
    out_dtype = _check(q, seg, heads, like=(k, v, do), rows=(lse, delta), seg_k=seg_k, out_dtype=out_dtype)
    return padded_bwd_dkv(_launch_bwd_dkv, q, k, v, seg, do, lse, delta, scale, causal, heads, seg_k,
                          out_dtype)


_COUNT_LOCK = threading.Lock()


def _count(wrapper):
    """One more launch in ``wrapper.launches``; a lock keeps the count exact
    when several threads launch at once (``Pipeline1F1B``'s stages)."""
    with _COUNT_LOCK:
        wrapper.launches += 1


#: the three kernel wrappers of this module, forward first
KERNELS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
for _fn in KERNELS:
    _fn.launches = 0
    #: the device kernels it launches (f32, bf16; then the split-D ones,
    #: above D = 256), as a profiler trace names them
    #: (``ops/kernel_trace.py`` counts a replayed graph's by them)
    _fn.kernel_names = tuple(_fn.__name__ + suffix for suffix in
                             ("_kernel", "_wgmma_kernel", "_split_kernel", "_split_wgmma_kernel"))


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
    tensor math between the kernels; segment ids get no gradient. At a head
    dim the kernels are not compiled for, q, k, v are padded once in the
    forward and saved padded, dO once in the backward (o's padded columns
    are zero, so ``delta`` is the real D's)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, scale, causal, heads):
        d = q.shape[-1]
        q, k, v = (widen_heads(t) for t in (q, k, v))
        o, lse = flash_fwd(q, k, v, seg, scale, causal, heads)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.args = (scale, causal, heads, d)
        return narrow_heads(o, d)

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        scale, causal, heads, d = ctx.args
        do = widen_heads(do.contiguous())
        delta = (do.float() * o.float()).sum(-1)
        dq = flash_bwd_dq(q, k, v, seg, do, lse, delta, scale, causal, heads)
        dk, dv = flash_bwd_dkv(q, k, v, seg, do, lse, delta, scale, causal, heads)
        return narrow_heads(dq, d), narrow_heads(dk, d), narrow_heads(dv, d), None, None, None, None


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
