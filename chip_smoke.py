"""On-card smoke run of the PyTorch/CUDA port (``tensorflowonspark_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``); any failure raises
and the script exits non-zero:

1. ``device``     the card's name and power limit (``nvidia-smi``).
2. ``build``      compiles the four fused-BatchNorm Triton kernels (into
                  ``build/triton``) and, at the same time in a second thread,
                  the three flash-attention CUDA kernels with ``nvcc`` (into
                  ``build/cuda``), from the sources in the checkout.
3. ``kernel``     at every BatchNorm shape of a ResNet-50 step (batch 64,
                  224 px, bf16), each BN kernel against its plain PyTorch
                  version: the max error beside its stated tolerance, the
                  kernel's time, the plain version's, one PyTorch library
                  call computing the same function (a yardstick only; the
                  port never calls it) and the least time the card could take
                  (bytes moved / 3.35 TB/s, the H100 SXM data sheet). Lines
                  are printed for the stem and a stage-3 shape.
4. ``kernel``     each flash-attention kernel against its plain version at
                  the LM slice's shape ([B·H=64, L=2048, D=64] bf16, causal,
                  with the packed segment layout of the slice's own corpus),
                  and once in f32 at [16, 1024, 64]: the errors (bf16
                  outputs elementwise and as a norm) beside their limits,
                  two faults the bf16 limits must catch (an output off by
                  1%; O with a kv block dropped), kernel, plain and
                  yardstick times
                  (``scaled_dot_product_attention`` with the causal+segment
                  mask, and its backward), and the bound from this run's
                  segments (989 TFLOP/s bf16 or 67 TFLOP/s f32, 3.35 TB/s).
5. ``slice``      the port's ResNet path: ``TFCluster.run`` on the local
                  backend, one executor, the port's ``resnet_spark.main_fun``
                  on full ResNet-50, bf16, ``bn_impl="pallas"``, batch 64, 5
                  steps. Per-step losses (finite), images/s over steps 2-5,
                  and each BN kernel's launch count read back from the
                  trainer's obs counters, which must be 53 per step.
6. ``compare``    one ResNet-50 train step, BN kernels vs plain versions, in
                  float32 and bf16 with TF32 off, then a 1% dgamma fault
                  that the gradient limit must catch.
7. ``slice_lm``   the port's LM path: ``TFCluster.run`` → the port's
                  ``transformer_spark.main_fun`` at ``TransformerConfig``'s
                  full width (vocab 32000, d_model 512, 6 layers, 8 heads,
                  d_ff 2048), seq 2048, batch 8, bf16, on byte-tokenized
                  packed text, 5 steps: losses (finite), tokens/s over steps
                  2-5, the packing efficiency, and each flash kernel's
                  launches, which must be 6 per step.
8. ``compare_lm`` one LM train step on the same weights (seed 0) and packed
                  batch through the kernels (``attention="flash"``) and
                  through a reference, with TF32 off: in float32 plain
                  attention, in bf16 the kernels' plain versions on the
                  same autograd path. Loss and gradient differences
                  against stated limits; then, in each dtype, a 1% dk fault
                  in the dk/dv kernel's output that the gradient limit
                  must catch.
9. ``kernels``    every kernel of the port and whether phases 5 and 7
                  launched it.

Then one JSON line with every kernel's measurements, the ``nvidia-smi``
line, and last ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside it, the script fails before printing anything.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 on the tensor cores
BATCH, IMAGE, STEPS = 64, 224, 5
BF16_ULP = 2.0 ** -7  # bf16 keeps 8 significant bits
REL_F32_SUM = 1e-4  # f32 per-channel sums of up to 8e5 values, added in another order

#: (wrapper, TPU kernel it replaces, (bytes per element of the activation
#: moved, f32 per-channel vectors moved), flops per element)
KERNEL_TABLE = [
    ("bn_stats", "tensorflowonspark_tpu/ops/fused_bn.py:87", (1, 2), 3),
    ("bn_normalize", "tensorflowonspark_tpu/ops/fused_bn.py:108", (2, 4), 3),
    ("bn_bwd_reduce", "tensorflowonspark_tpu/ops/fused_bn.py:116", (2, 4), 5),
    ("bn_bwd_dx", "tensorflowonspark_tpu/ops/fused_bn.py:138", (3, 5), 7),
]
SOURCE = "tensorflowonspark_tpu_torch/ops/fused_bn.py"

#: the LM slice: TransformerConfig's defaults at full width
LM = dict(vocab_size=32000, d_model=512, n_layers=6, n_heads=8, d_ff=2048)
LM_SEQ, LM_BATCH = 2048, 8
#: one bf16 LM step, kernels vs their plain versions: the loss, all
#: gradients (relative) and each of the last layer's q, k, v projection
#: gradients (relative, forward kernel on both sides)
LM_BF16_LOSS_TOL, LM_BF16_GRAD_TOL, LM_BF16_ATTN_GRAD_TOL = 2e-4, 2e-3, 3e-3
#: (wrapper, TPU kernel it replaces, matrix products per attended (q, k)
#: pair, [BH, L, D] tensors moved, [BH, L] f32 row vectors moved)
FLASH_TABLE = [
    ("flash_fwd", "tensorflowonspark_tpu/ops/flash_attention.py:54", 2, 4, 1),
    ("flash_bwd_dq", "tensorflowonspark_tpu/ops/flash_attention.py:104", 3, 5, 2),
    ("flash_bwd_dkv", "tensorflowonspark_tpu/ops/flash_attention.py:151", 4, 6, 2),
]
FLASH_SOURCE = "tensorflowonspark_tpu_torch/csrc/flash_attention.cu"
#: kernel vs plain version, f32 outputs (lse everywhere, every output of the
#: f32 line): the same f32 math summed in another order, within this much
#: of the largest reference value (floor 1)
FLASH_F32_TOL = 1e-4
#: bf16 outputs, held elementwise: |got - ref| <= tol * (|ref| + rms(ref)).
#: The summands of dq, dk and dv cancel, so one bf16 ulp at the scale of the
#: summands lands on smaller values (a sound kernel reads up to 1.4e-2 at
#: the slice's shape on an H100); a kv block dropped from the rows past it
#: reads 3.2
FLASH_BF16_ELEM_TOL = 2.0 ** -5
#: bf16 outputs, held as a norm: ||got - ref|| / ||ref||. O differs most: p
#: rounds to bf16 against a running max in the kernel and the final max in
#: the plain version (reads 1.1e-3); dq, dk, dv round the same p and ds on
#: both sides (read <= 8.5e-5). A 1% fault in any output reads 1.0e-2
FLASH_BF16_NORM_TOL = {"flash_fwd": 2.0 ** -8, "flash_bwd_dq": 2.0 ** -10,
                       "flash_bwd_dkv": 2.0 ** -10}


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(name, rows, n_ch, elem_bytes):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    flops over the float32 rate, each input read once, each output written
    once."""
    acts, vecs = next(t[2] for t in KERNEL_TABLE if t[0] == name)
    flops = next(t[3] for t in KERNEL_TABLE if t[0] == name) * rows * n_ch
    moved = acts * rows * n_ch * elem_bytes + vecs * n_ch * 4
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, flush, iters=7):
    """Median device time of one call of ``fn``, with the 50 MB L2 flushed
    before each (the main path finds these activations cold)."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in events)[iters // 2]


def bn_shapes(torch, fused_bn, resnet):
    """Input shapes (N, H, W, C) of the 53 BatchNorm layers of the slice's
    model, read with hooks from an eval-mode forward (no kernel runs)."""
    model = resnet.resnet50(dtype=torch.bfloat16, bn_impl="pallas").cuda().eval()
    shapes = []
    hooks = [
        m.register_forward_pre_hook(lambda _m, inp: shapes.append(tuple(inp[0].shape)))
        for m in model.modules() if isinstance(m, fused_bn.FusedBatchNorm)
    ]
    with torch.no_grad():
        model(torch.zeros(BATCH, IMAGE, IMAGE, 3, device="cuda"))
    for h in hooks:
        h.remove()
    del model
    return shapes


def phase_kernel(torch, F, fused_bn, shapes):
    """Every kernel against its plain version at each distinct shape; per-
    step totals weight each shape by how many layers have it."""
    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {t[0]: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                     "max_abs_err": 0.0, "bound_by": "bytes"} for t in KERNEL_TABLE}
    eps = 1e-5
    named = {(BATCH, 112, 112, 64): "stem", (BATCH, 14, 14, 1024): "stage3"}
    for shape, n_layers in sorted(counts.items()):
        n, h, w, c = shape
        rows = n * h * w
        x = (torch.randn(rows, c, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
        dy = torch.randn(rows, c, device="cuda", generator=gen).to(torch.bfloat16)
        gamma = torch.randn(c, device="cuda", generator=gen)
        beta = torch.randn(c, device="cuda", generator=gen)
        x4 = x.view(n, h, w, c).permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        dy4 = dy.view(n, h, w, c).permute(0, 3, 1, 2)
        mean, var = fused_bn.bn_stats_plain(x)
        dgamma, dbeta = fused_bn.bn_bwd_reduce_plain(x, dy, mean, var, eps)
        invstd = torch.rsqrt(var + eps)
        nbb = torch.ops.aten.native_batch_norm_backward
        cases = {
            "bn_stats": (
                lambda: fused_bn.bn_stats(x), lambda: fused_bn.bn_stats_plain(x),
                lambda: torch.var_mean(x, dim=0, correction=0), REL_F32_SUM,
            ),
            "bn_normalize": (
                lambda: fused_bn.bn_normalize(x, mean, var, gamma, beta, eps),
                lambda: fused_bn.bn_normalize_plain(x, mean, var, gamma, beta, eps),
                lambda: F.batch_norm(x4, mean, var, gamma, beta, training=False, eps=eps),
                BF16_ULP,
            ),
            "bn_bwd_reduce": (
                lambda: fused_bn.bn_bwd_reduce(x, dy, mean, var, eps),
                lambda: fused_bn.bn_bwd_reduce_plain(x, dy, mean, var, eps),
                lambda: nbb(dy4, x4, gamma, None, None, mean, invstd, True, eps,
                            [False, True, True]),
                REL_F32_SUM,
            ),
            "bn_bwd_dx": (
                lambda: fused_bn.bn_bwd_dx(x, dy, mean, var, gamma, dgamma, dbeta, eps),
                lambda: fused_bn.bn_bwd_dx_plain(x, dy, mean, var, gamma, dgamma, dbeta, eps),
                lambda: nbb(dy4, x4, gamma, None, None, mean, invstd, True, eps,
                            [True, False, False]),
                BF16_ULP,
            ),
        }
        for name, (kernel, plain, library, rel_tol) in cases.items():
            got, want = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            err = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, want))
            scale = max(float(r.float().abs().max()) for r in want)
            # f32 sums: relative to the largest value (floor 1); bf16 outputs:
            # one unit in the last place at the largest magnitude
            tol = rel_tol * (max(1.0, scale) if rel_tol == REL_F32_SUM else scale)
            if not err <= tol:
                raise AssertionError("{} at {}: max abs err {} > tolerance {}".format(
                    name, shape, err, tol))
            ms = time_ms(torch, kernel, flush)
            plain_ms = time_ms(torch, plain, flush)
            library_ms = time_ms(torch, library, flush)
            b_ms, b_by = bound(name, rows, c, x.element_size())
            tot = totals[name]
            tot["ms"] += n_layers * ms
            tot["plain_ms"] += n_layers * plain_ms
            tot["library_ms"] += n_layers * library_ms
            tot["bound_ms"] += n_layers * b_ms
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["bound_by"] = b_by
            if shape in named:
                emit({"phase": "kernel", "name": name, "at": named[shape],
                      "shape": [rows, c], "dtype": "bfloat16", "layers": n_layers,
                      "max_abs_err": err, "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by})
        del x, dy, x4, dy4
    return totals


def phase_slice(torch, fused_bn):
    """The port's main path through the user's entry points."""
    from tensorflowonspark_tpu_torch import TFCluster, util
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.examples.resnet import resnet_spark

    args = resnet_spark.build_parser().parse_args([
        "--dataset", "imagenet", "--bn_impl", "pallas", "--batch_size", str(BATCH),
        "--train_steps", str(STEPS), "--log_steps", "1",
    ])
    # the counts the trainer reports start at 0 in its freshly spawned
    # process; this process's own counts are zeroed too
    fused_bn.reset_launch_counts()
    t0 = time.perf_counter()
    sc = LocalSparkContext(num_executors=1)
    try:
        cluster = TFCluster.run(
            sc, resnet_spark.main_fun, args, 1,
            input_mode=TFCluster.InputMode.TENSORFLOW, master_node="chief",
            env={util.ENV_PLATFORM: "gpu"},
        )
        if not cluster.wait_for_completion(timeout=600):
            raise TimeoutError("the trainer did not finish within 600 s")
        metrics = cluster.metrics(include_driver=False)
        cluster.shutdown()
    finally:
        sc.stop()
    wall = time.perf_counter() - t0
    steps = sorted(
        (e for e in metrics["events"] if e.get("span") == "train_step"), key=lambda e: e["step"]
    )
    losses = [e.get("loss") for e in steps]
    if len(steps) != STEPS or not all(isinstance(v, float) and math.isfinite(v) for v in losses):
        raise AssertionError("expected {} finite step losses, got {}".format(STEPS, losses))
    timed = [e["dur_s"] for e in steps[1:]]
    launches = {
        name: int(metrics["counters"].get("fused_bn_{}_launches_total".format(name), {}).get("value", 0))
        for name, *_ in KERNEL_TABLE
    }
    want = 53 * STEPS
    emit({"phase": "slice", "model": "resnet50", "dtype": "bfloat16", "bn_impl": "pallas",
          "batch": BATCH, "image": IMAGE, "steps": STEPS, "losses": losses,
          "step_s": [e["dur_s"] for e in steps],
          "images_per_sec_steps_2_5": BATCH * len(timed) / sum(timed),
          "launches": launches, "expected_launches": want, "wall_s": wall})
    bad = {k: v for k, v in launches.items() if v != want}
    if bad:
        raise AssertionError("kernel launches {} != 53 x {} steps".format(bad, STEPS))
    return launches


def _train_grads(torch, fused_bn, resnet, dtype, impl, batch, loss_fn):
    """Loss, flattened parameter gradients and kernel launches of one
    training forward and backward of the slice's model (weights seed 0)."""
    model = resnet.resnet50(
        dtype=dtype, bn_impl=impl, generator=torch.Generator().manual_seed(0)
    ).cuda().train()
    before = fused_bn.launch_counts()
    loss, _ = loss_fn(model, dict(model.named_buffers()), batch)
    loss.backward()
    torch.cuda.synchronize()
    after = fused_bn.launch_counts()
    grad = torch.cat([p.grad.float().flatten() for p in model.parameters()])
    return loss.item(), grad, {k: after[k] - before[k] for k in after}


def phase_compare(torch, fused_bn, resnet):
    """One train step, kernels vs plain versions, same weights and batch:
    the loss and the relative difference of all parameter gradients, each
    against its limit. A control run with dgamma off by 1% in every layer
    shows that the gradient limit sees a fault the loss cannot."""
    import numpy as np

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)  # the trainer's synthetic batch (executor 0)
    batch = {
        "image": torch.as_tensor(
            rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)).cuda(),
        "label": torch.as_tensor(rng.integers(0, 1000, BATCH)).cuda(),
    }
    loss_fn = resnet.make_loss_fn(weight_decay=1e-4)
    # (loss limit, gradient limit). float32: only the sum order differs
    # (53 layers; the gradients read 1.2e-6 apart on an H100); bfloat16: BN
    # outputs that round one bf16 ulp apart propagate through the network
    # (the gradients read 8.9e-3 apart)
    limits = {"float32": (1e-3, 1e-4), "bfloat16": (5e-2, 3e-2)}
    grads = {}
    for dtype_name, (tol, grad_tol) in limits.items():
        dtype = getattr(torch, dtype_name)
        lk, gk, nk = _train_grads(torch, fused_bn, resnet, dtype, "pallas", batch, loss_fn)
        lp, gp, np_ = _train_grads(torch, fused_bn, resnet, dtype, "flax", batch, loss_fn)
        if any(v != 53 for v in nk.values()) or any(np_.values()):
            raise AssertionError("kernel launches: kernels {} plain {}".format(nk, np_))
        grad_rel = float((gk - gp).norm() / gp.norm())
        grads[dtype_name] = (lp, gp)
        emit({"phase": "compare", "dtype": dtype_name, "tf32": False, "loss_kernels": lk,
              "loss_plain": lp, "loss_diff": abs(lk - lp), "tolerance": tol,
              "grad_rel_diff": grad_rel, "grad_tolerance": grad_tol})
        if not (math.isfinite(lk) and abs(lk - lp) <= tol):
            raise AssertionError("{} loss {} vs plain {} beyond {}".format(dtype_name, lk, lp, tol))
        if not grad_rel <= grad_tol:
            raise AssertionError("{} gradients {} apart (relative), beyond {}".format(
                dtype_name, grad_rel, grad_tol))

    real = fused_bn.bn_bwd_reduce

    def faulted(*args):
        dgamma, dbeta = real(*args)
        return dgamma * 1.01, dbeta

    # the wrapper counts its launches on the module's name for it, which
    # is this stand-in while the fault is in
    faulted.launches = 0
    fused_bn.bn_bwd_reduce = faulted
    try:
        lf, gf, _ = _train_grads(torch, fused_bn, resnet, torch.float32, "pallas", batch, loss_fn)
    finally:
        fused_bn.bn_bwd_reduce = real
    grad_tol = limits["float32"][1]
    lp, gp = grads["float32"]
    control = float((gf - gp).norm() / gp.norm())
    emit({"phase": "compare_control", "dtype": "float32", "fault": "dgamma x 1.01",
          "loss_diff": abs(lf - lp), "grad_rel_diff": control, "grad_tolerance": grad_tol})
    if not control > grad_tol:
        raise AssertionError("a 1% dgamma fault moved the gradients by only {}, within the "
                             "limit {}: the gradient check cannot see it".format(control, grad_tol))


def lm_corpus(here):
    """The LM slice's corpus (the example's synthetic TFRecord text) under
    ``build/`` in the checkout, and the first packed batch that the trainer
    (executor 0 of 1: every shard, seed 0) draws from it."""
    from tensorflowonspark_tpu_torch import tfrecord
    from tensorflowonspark_tpu_torch.data import TextPipeline, Tokenizer
    from tensorflowonspark_tpu_torch.examples.transformer import transformer_spark

    data_dir = os.path.join(here, "build", "lm_corpus")
    transformer_spark.make_text_corpus(data_dir)
    stream = iter(TextPipeline(tfrecord.list_shards(data_dir), Tokenizer(kind="byte"),
                               seq_len=LM_SEQ + 1, batch_size=LM_BATCH, seed=0, epochs=None,
                               pack_workers=0))
    batch = next(stream)
    stream.close()
    return data_dir, batch


def attended_pairs(seg):
    """(q, k) pairs per head that causal attention with the segment fence
    needs on ``seg`` ``[B, L]`` (pad rows, id 0, attend to each other):
    n(n+1)/2 for each id with n positions in a row."""
    import numpy as np

    total = 0
    for row in np.asarray(seg):
        _, counts = np.unique(row, return_counts=True)
        total += int((counts * (counts + 1) // 2).sum())
    return total


def flash_bound(name, seg, heads, length, d, elem_bytes, pairs=None):
    """(bound_ms, bound_by) of one call: the larger of bytes over the memory
    rate (each input read once, each output written once) and the matrix
    products' flops on the attended pairs over the dtype's peak rate."""
    _, _, products, tensors, rows = next(t for t in FLASH_TABLE if t[0] == name)
    b = seg.shape[0]
    bh = b * heads
    if pairs is None:
        pairs = attended_pairs(seg) * heads
    flops = products * 2 * d * pairs
    moved = tensors * bh * length * d * elem_bytes + rows * bh * length * 4 + b * length * 4
    peak = BF16_FLOPS_PER_S if elem_bytes == 2 else F32_FLOPS_PER_S
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_errors(name, got, want):
    """``(max_abs_err, failures, readings)`` of one kernel's outputs against
    its plain version's: f32 outputs within ``FLASH_F32_TOL`` of the largest
    value; bf16 outputs elementwise and as a norm (``FLASH_BF16_*``)."""
    import torch

    failures, readings, max_abs = [], {"elem": None, "norm": None}, 0.0
    for i, (g, r) in enumerate(zip(got, want)):
        g, rf = g.float(), r.float()
        diff = (g - rf).abs()
        err = float(diff.max())
        max_abs = max(max_abs, err)
        if r.dtype == torch.float32:
            tol = FLASH_F32_TOL * max(1.0, float(rf.abs().max()))
            if not err <= tol:
                failures.append("output {}: max abs err {} > {}".format(i, err, tol))
            continue
        rms = rf.square().mean().sqrt()
        elem = float((diff / (rf.abs() + rms)).max())
        norm = float((g - rf).norm() / rf.norm())
        readings = {"elem": max(readings["elem"] or 0.0, elem),
                    "norm": max(readings["norm"] or 0.0, norm)}
        if not elem <= FLASH_BF16_ELEM_TOL:
            failures.append("output {}: elementwise err {} > {}".format(i, elem, FLASH_BF16_ELEM_TOL))
        if not norm <= FLASH_BF16_NORM_TOL[name]:
            failures.append("output {}: norm err {} > {}".format(i, norm, FLASH_BF16_NORM_TOL[name]))
    return max_abs, failures, readings


def o_dropped_block(fa, q, k, v, seg, scale, heads):
    """The plain forward's O with keys 64-127 dropped from every query row
    past them: a fault that the elementwise limit must catch."""
    import torch

    s = fa._masked_scores(q, k, seg, scale, True, heads)
    s[:, 128:, 64:128] = fa.NEG_BIG
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    return (torch.einsum("bqk,bkd->bqd", p.to(q.dtype).float(), v.float()) / denom).to(q.dtype)


def _sdpa_backend(torch, F, q, k, v, mask):
    """The first of PyTorch's fused SDPA backends that takes this boolean
    mask and dtype (the yardstick's; the port never calls SDPA)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            torch.cuda.synchronize()
            return backend
        except RuntimeError:
            continue
    raise RuntimeError("no SDPA backend takes a boolean mask here")


def phase_flash_kernel(torch, F, fa, seg_slice):
    """Each flash kernel against its plain version, bf16 at the slice's
    shape and f32 at [16, 1024, 64], causal with the corpus's segments. On
    the bf16 line two faults must fail the check: each kernel's first
    output (O, dq, dk) off by 1%, and O with a kv block dropped. Returns the
    bf16 line's numbers per LM step (6 layers)."""
    from torch.nn.attention import sdpa_kernel

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' einsums in full f32
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    gen = torch.Generator(device="cuda").manual_seed(1)
    heads, d = LM["n_heads"], LM["d_model"] // LM["n_heads"]
    totals = {}
    for dtype_name, b, length in (("bfloat16", LM_BATCH, LM_SEQ), ("float32", 2, 1024)):
        dtype = getattr(torch, dtype_name)
        seg = seg_slice[:b, :length].contiguous()
        shape = (b * heads, length, d)
        q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(4))
        scale = 1.0 / math.sqrt(d)
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, seg, scale, True, heads)
        delta = (do.float() * o_ref.float()).sum(-1)
        args = (seg, scale, True, heads)
        bwd = (seg, do, lse_ref, delta, scale, True, heads)
        q4, k4, v4, do4 = (t.view(b, heads, length, d) for t in (q, k, v, do))
        pos = torch.arange(length, device="cuda")
        mask = ((pos[:, None] >= pos[None, :])[None] & (seg[:, :, None] == seg[:, None, :]))[:, None]
        backend = _sdpa_backend(torch, F, q4, k4, v4, mask)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
        with sdpa_kernel([backend]):
            out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)

        def library_fwd():
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

        def library_bwd():
            return torch.autograd.grad(out, (qg, kg, vg), do4, retain_graph=True)

        cases = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, *args),
                          lambda: fa.flash_fwd_plain(q, k, v, *args), library_fwd),
            "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, *bwd),
                             lambda: fa.flash_bwd_dq_plain(q, k, v, *bwd), library_bwd),
            "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, *bwd),
                              lambda: fa.flash_bwd_dkv_plain(q, k, v, *bwd), library_bwd),
        }
        pairs = attended_pairs(seg.cpu()) * heads
        for name, (kernel, plain, library) in cases.items():
            got, want = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            err, failures, readings = flash_errors(name, got, want)
            controls = {}
            if dtype_name == "bfloat16":
                faults = {"x1.01": (got[0].float() * 1.01,) + got[1:]}
                if name == "flash_fwd":
                    faults["dropped_kv_block"] = (o_dropped_block(fa, q, k, v, seg, scale, heads),
                                                  got[1])
                for fault, outs in faults.items():
                    _, caught, controls[fault] = flash_errors(name, outs, want)
                    if not caught:
                        raise AssertionError("{}: the {} fault passed the check ({})".format(
                            name, fault, controls[fault]))
            if failures:
                raise AssertionError("{} {} at {}: {}".format(name, dtype_name, shape, failures))
            ms = time_ms(torch, kernel, flush)
            plain_ms = time_ms(torch, plain, flush)
            library_ms = time_ms(torch, library, flush)
            b_ms, b_by = flash_bound(name, seg, heads, length, d, q.element_size(), pairs)
            causal_ms, _ = flash_bound(name, seg, heads, length, d, q.element_size(),
                                       b * heads * length * (length + 1) // 2)
            line = {"phase": "kernel", "name": name, "shape": list(shape), "dtype": dtype_name,
                    "causal": True, "segments": int(sum(len(set(r)) for r in seg.cpu().tolist())),
                    "max_abs_err": err, "elem_err": readings["elem"], "norm_err": readings["norm"],
                    "elem_tolerance": FLASH_BF16_ELEM_TOL, "norm_tolerance": FLASH_BF16_NORM_TOL[name],
                    "f32_tolerance": FLASH_F32_TOL, "controls": controls,
                    "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "library": "sdpa {} {}".format(
                        backend.name, "forward" if name == "flash_fwd" else "backward (dq+dk+dv)"),
                    "bound_ms": b_ms, "bound_by": b_by, "bound_ms_dense_causal": causal_ms}
            emit(line)
            if dtype_name == "bfloat16":
                n_layers = LM["n_layers"]
                totals[name] = {"ms": n_layers * ms, "plain_ms": n_layers * plain_ms,
                                "library_ms": n_layers * library_ms, "bound_ms": n_layers * b_ms,
                                "bound_by": b_by, "max_abs_err": err}
        del q, k, v, do, q4, k4, v4, do4, qg, kg, vg, out, o_ref, lse_ref, delta, mask
        torch.cuda.empty_cache()
    return totals


def phase_slice_lm(torch, fa, data_dir, steps):
    """The port's LM path through the user's entry points."""
    from tensorflowonspark_tpu_torch import TFCluster, util
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.examples.transformer import transformer_spark

    args = transformer_spark.build_parser().parse_args([
        "--vocab_size", str(LM["vocab_size"]), "--d_model", str(LM["d_model"]),
        "--n_layers", str(LM["n_layers"]), "--n_heads", str(LM["n_heads"]),
        "--d_ff", str(LM["d_ff"]), "--seq_len", str(LM_SEQ), "--batch_size", str(LM_BATCH),
        "--dtype", "bfloat16", "--tokenizer", "byte", "--train_steps", str(steps),
        "--log_steps", "1", "--data_dir", data_dir,
    ])
    fa.reset_launch_counts()  # the trainer's counts start at 0 in its fresh process
    t0 = time.perf_counter()
    sc = LocalSparkContext(num_executors=1)
    try:
        cluster = TFCluster.run(
            sc, transformer_spark.main_fun, args, 1,
            input_mode=TFCluster.InputMode.TENSORFLOW, master_node="chief",
            env={util.ENV_PLATFORM: "gpu"},
        )
        if not cluster.wait_for_completion(timeout=600):
            raise TimeoutError("the LM trainer did not finish within 600 s")
        metrics = cluster.metrics(include_driver=False)
        cluster.shutdown()
    finally:
        sc.stop()
    wall = time.perf_counter() - t0
    events = sorted(
        (e for e in metrics["events"] if e.get("span") == "train_step"), key=lambda e: e["step"]
    )
    losses = [e.get("loss") for e in events]
    if len(events) != steps or not all(isinstance(v, float) and math.isfinite(v) for v in losses):
        raise AssertionError("expected {} finite LM step losses, got {}".format(steps, losses))
    timed = [e["dur_s"] for e in events[1:]]
    launches = {
        name: int(metrics["counters"].get(
            "flash_attention_{}_launches_total".format(name[len("flash_"):]), {}).get("value", 0))
        for name, *_ in FLASH_TABLE
    }
    want = LM["n_layers"] * steps
    efficiency = metrics["gauges"].get("text_pack_efficiency", {}).get("value")
    emit({"phase": "slice_lm", "model": "transformer", "config": dict(LM, seq_len=LM_SEQ),
          "dtype": "bfloat16", "batch": LM_BATCH, "steps": steps, "losses": losses,
          "step_s": [e["dur_s"] for e in events],
          "tokens_per_sec_steps_2_5": LM_BATCH * LM_SEQ * len(timed) / sum(timed),
          "packing_efficiency": efficiency, "launches": launches,
          "expected_launches": want, "wall_s": wall})
    bad = {k: v for k, v in launches.items() if v != want}
    if bad:
        raise AssertionError("flash kernel launches {} != {} x {} steps".format(
            bad, LM["n_layers"], steps))
    if not (isinstance(efficiency, float) and 0 < efficiency <= 1):
        raise AssertionError("packing efficiency {} outside (0, 1]".format(efficiency))
    return launches


def _lm_grads(torch, fa, transformer, dtype_name, impl, batch):
    """Loss, all parameter gradients (flattened), the last layer's attention
    projection gradients (``{"q", "k", "v"}`` weights) and flash launches
    of one LM training forward and backward (weights seed 0)."""
    model = transformer.create_model(
        dtype=dtype_name, attention=impl, generator=torch.Generator().manual_seed(0), **LM
    ).cuda().train()
    before = fa.launch_counts()
    loss, _ = transformer.make_loss_fn(model)(model, batch)
    loss.backward()
    torch.cuda.synchronize()
    after = fa.launch_counts()
    grad = torch.cat([p.grad.float().flatten() for p in model.parameters()])
    last = getattr(model, "layer_{}".format(LM["n_layers"] - 1)).attn
    attn = {name: getattr(last, name).weight.grad.float() for name in ("q", "k", "v")}
    del model, last
    torch.cuda.empty_cache()
    return loss.item(), grad, attn, {k: after[k] - before[k] for k in after}


def _rel(got, ref):
    return float((got - ref).norm() / ref.norm())


@contextlib.contextmanager
def plain_kernels(fa, wrappers):
    """The given flash wrappers replaced by their plain versions inside the
    block: the same autograd path and the same bf16 casts of p and ds, with
    those kernels not launched."""
    saved = {fn.__name__: fn for fn in wrappers}
    for name in saved:
        setattr(fa, name, getattr(fa, name + "_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(fa, name, fn)


@contextlib.contextmanager
def dk_fault(fa):
    """dk off by 1% in the dk/dv kernel's output inside the block."""
    real = fa.flash_bwd_dkv

    def faulted(*args):
        dk, dv = real(*args)
        return dk * 1.01, dv

    # the wrapper counts its launches on the module's name for it, which
    # is this stand-in while the fault is in
    faulted.launches = 0
    fa.flash_bwd_dkv = faulted
    try:
        yield
    finally:
        fa.flash_bwd_dkv = real


def phase_compare_lm(torch, fa, transformer, host_batch):
    """One LM train step through the flash kernels against a reference step
    on the same weights and packed batch, then the same step with a 1% fault
    in dk, each against stated limits.

    float32 (TF32 off): against plain attention, the dense f32 math; the
    loss and the relative difference of all parameter gradients, which the
    fault must break.

    bfloat16: against the kernels' plain versions on the same autograd path
    (plain attention keeps p and ds in f32: the kernels' bf16 rounding alone
    moves the gradients by 1.2e-3). The loss and the whole gradient are
    held to a step's bf16 rounding, which leaves no room for a 1% fault: any
    difference flips bf16 roundings layer after layer (the whole gradient
    reads 1.1e-3 apart, the dk fault 1.6e-3; the q, k, v projections of all
    layers 8.9e-4 and 2.0e-3). The fault is held in the last layer's q, k
    and v projection gradients, each relative to its own norm, with the
    forward kernel on both sides and only the backward kernels against
    their plain versions: there the gradient arriving at attention is the
    same on both sides, and dq, dk, dv reach the weights in one product."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = {k: torch.as_tensor(v).cuda() for k, v in host_batch.items()}
    n = LM["n_layers"]
    kernels = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    bwd_plain = {"flash_fwd": n, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    none = dict.fromkeys(kernels, 0)
    run = lambda dtype, impl="flash": _lm_grads(torch, fa, transformer, dtype, impl, batch)  # noqa: E731

    lk, gk, _, nk = run("float32")
    lp, gp, _, np_ = run("float32", "plain")
    with dk_fault(fa):
        lf, gf, _, _ = run("float32")
    if (nk, np_) != (kernels, none):
        raise AssertionError("flash launches: kernels {} plain {}".format(nk, np_))
    f32 = {"loss_diff": abs(lk - lp), "grad_rel_diff": _rel(gk, gp),
           "control_grad_rel_diff": _rel(gf, gp), "finite": math.isfinite(lk)}
    emit({"phase": "compare_lm", "dtype": "float32", "tf32": False,
          "reference": "plain attention", "loss_kernels": lk, "loss_reference": lp,
          "loss_tolerance": 1e-4, "grad_tolerance": 1e-4, "control": "dk x 1.01", **f32})
    del gk, gp, gf

    lk, gk, ak, nk = run("bfloat16")
    with plain_kernels(fa, fa.KERNELS):
        lp, gp, _, np_ = run("bfloat16")
    with plain_kernels(fa, (fa.flash_bwd_dq, fa.flash_bwd_dkv)):
        lb, _, ab, nb = run("bfloat16")
    with dk_fault(fa):
        lf, gf, af, _ = run("bfloat16")
    if (nk, np_, nb) != (kernels, none, bwd_plain):
        raise AssertionError("flash launches: kernels {} plain {} plain backward {}".format(
            nk, np_, nb))
    bf16 = {"finite": math.isfinite(lk), "loss_diff": abs(lk - lp), "grad_rel_diff": _rel(gk, gp),
            "last_attn_grad_rel_diff": {n: _rel(ak[n], ab[n]) for n in ak},
            "control_grad_rel_diff": _rel(gf, gp),
            "control_last_attn_grad_rel_diff": {n: _rel(af[n], ab[n]) for n in af},
            "loss_diff_plain_backward": abs(lk - lb)}
    emit({"phase": "compare_lm", "dtype": "bfloat16", "tf32": False,
          "reference": "plain versions (last_attn: plain backward, forward kernel)",
          "loss_kernels": lk, "loss_reference": lp, "loss_tolerance": LM_BF16_LOSS_TOL,
          "grad_tolerance": LM_BF16_GRAD_TOL, "attn_grad_tolerance": LM_BF16_ATTN_GRAD_TOL,
          "control": "dk x 1.01", **bf16})
    del gk, gp, gf, ak, ab, af

    checks = [
        ("f32 loss", f32["finite"] and f32["loss_diff"] <= 1e-4),
        ("f32 gradients", f32["grad_rel_diff"] <= 1e-4),
        ("f32 dk fault caught", f32["control_grad_rel_diff"] > 1e-4),
        ("bf16 loss", bf16["finite"] and bf16["loss_diff"] <= LM_BF16_LOSS_TOL),
        ("bf16 gradients", bf16["grad_rel_diff"] <= LM_BF16_GRAD_TOL),
        ("bf16 projection gradients",
         max(bf16["last_attn_grad_rel_diff"].values()) <= LM_BF16_ATTN_GRAD_TOL),
        ("bf16 dk fault caught",
         max(bf16["control_last_attn_grad_rel_diff"].values()) > LM_BF16_ATTN_GRAD_TOL),
        ("same forward", bf16["loss_diff_plain_backward"] == 0.0),
    ]
    failed = [name for name, ok in checks if not ok]
    if failed:
        raise AssertionError("compare_lm failed: {} (f32 {}, bf16 {})".format(failed, f32, bf16))


def main():
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch {} sees no CUDA device; this script runs on the card "
                 "only".format(torch.__version__))
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isfile(os.path.join(here, "tensorflowonspark_tpu_torch", "__init__.py")):
        sys.exit("chip_smoke: no tensorflowonspark_tpu_torch package beside {}; run it from "
                 "the root of a checkout".format(__file__))
    sys.path.insert(0, here)
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.models import resnet, transformer
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.ops import fused_bn

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    import triton

    emit({"phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "triton": triton.__version__})

    t0 = time.perf_counter()
    # nvcc builds the CUDA kernels while triton compiles the BN kernels
    cuda_build = {}

    def build_cuda():
        t = time.perf_counter()
        try:
            cuda_build["path"] = fa.build()
        except Exception as e:  # re-raised below, in the main thread
            cuda_build["error"] = e
        cuda_build["seconds"] = time.perf_counter() - t

    nvcc_thread = threading.Thread(target=build_cuda)
    nvcc_thread.start()
    for c in (64, 256):
        x = torch.randn(3136, c, device="cuda").to(torch.bfloat16)
        v = torch.ones(c, device="cuda")
        mean, var = fused_bn.bn_stats(x)
        fused_bn.bn_normalize(x, mean, var, v, v, 1e-5)
        dg, db = fused_bn.bn_bwd_reduce(x, x, mean, var, 1e-5)
        fused_bn.bn_bwd_dx(x, x, mean, var, v, dg, db, 1e-5)
    torch.cuda.synchronize()
    nvcc_thread.join()
    if "error" in cuda_build:
        raise cuda_build["error"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):  # load and launch each kernel once
        x = torch.randn(8, 130, 64, device="cuda", generator=gen).to(dtype)
        _, lse = fa.flash_fwd(x, x, x, None, 0.125, True, 1)
        fa.flash_bwd_dq(x, x, x, None, x, lse, lse, 0.125, True, 1)
        fa.flash_bwd_dkv(x, x, x, None, x, lse, lse, 0.125, True, 1)
    torch.cuda.synchronize()
    emit({"phase": "build", "kernels": [t[0] for t in KERNEL_TABLE] + [t[0] for t in FLASH_TABLE],
          "seconds": time.perf_counter() - t0, "cache": os.environ.get("TRITON_CACHE_DIR"),
          "cuda_seconds": cuda_build["seconds"], "cuda_library": cuda_build["path"]})

    shapes = bn_shapes(torch, fused_bn, resnet)
    if len(shapes) != 53:
        raise AssertionError("expected 53 BatchNorm layers, found {}".format(len(shapes)))
    totals = phase_kernel(torch, F, fused_bn, shapes)
    data_dir, lm_batch = lm_corpus(here)
    seg_slice = torch.as_tensor(lm_batch["segment_ids"][:, :-1]).cuda().contiguous()
    flash_totals = phase_flash_kernel(torch, F, fa, seg_slice)
    del seg_slice
    torch.cuda.empty_cache()  # hand the trainer child the card's memory
    launches = phase_slice(torch, fused_bn)
    phase_compare(torch, fused_bn, resnet)
    torch.cuda.empty_cache()
    flash_launches = phase_slice_lm(torch, fa, data_dir, STEPS)
    phase_compare_lm(torch, fa, transformer, lm_batch)
    emit({"phase": "kernels", "kernels": [
        {"name": name, "route": "triton", "source": SOURCE, "launched": launches[name] > 0}
        for name, *_ in KERNEL_TABLE] + [
        {"name": name, "route": "cuda", "source": FLASH_SOURCE, "launched": flash_launches[name] > 0}
        for name, *_ in FLASH_TABLE], "script_s": time.perf_counter() - t_start})
    emit({"kernels": [
        {"name": name, "route": "triton", "source": SOURCE, "replaces": replaces,
         "launches": launches[name], "max_abs_err": totals[name]["max_abs_err"],
         "ms": totals[name]["ms"], "plain_ms": totals[name]["plain_ms"],
         "bound_ms": totals[name]["bound_ms"], "bound_by": totals[name]["bound_by"],
         "library_ms": totals[name]["library_ms"],
         "per": "ResNet-50 step, batch {}, {} px, bf16: sum over its 53 BatchNorm "
                "layers".format(BATCH, IMAGE)}
        for name, replaces, *_ in KERNEL_TABLE] + [
        {"name": name, "route": "cuda", "source": FLASH_SOURCE, "replaces": replaces,
         "launches": flash_launches[name], "max_abs_err": flash_totals[name]["max_abs_err"],
         "ms": flash_totals[name]["ms"], "plain_ms": flash_totals[name]["plain_ms"],
         "bound_ms": flash_totals[name]["bound_ms"], "bound_by": flash_totals[name]["bound_by"],
         "library_ms": flash_totals[name]["library_ms"],
         "per": "transformer LM step, batch {}, seq {}, bf16, causal with packed segments: "
                "sum over its {} attention layers".format(LM_BATCH, LM_SEQ, LM["n_layers"])}
        for name, replaces, *_ in FLASH_TABLE]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
