"""On-card smoke run of the PyTorch/CUDA port (``tensorflowonspark_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``); any failure raises
and the script exits non-zero:

1. ``device``     the card's name and power limit (``nvidia-smi``).
2. ``build``      compiles the two elementwise fused-BatchNorm Triton
                  kernels (into ``build/triton``) and, at the same time, one
                  thread a source, the CUDA kernels with ``nvcc`` (into
                  ``build/cuda``): the two BatchNorm reductions
                  (``csrc/fused_bn.cu``) and the three flash-attention
                  kernels (``csrc/flash_attention.cu``), from the sources in
                  the checkout; reports each CUDA kernel's registers and
                  spill bytes from the ``-Xptxas -v`` logs.
3. ``kernel``     at every BatchNorm shape of a ResNet-50 step (batch 64,
                  224 px, bf16), each BN kernel against its plain PyTorch
                  version: the max error beside its stated tolerance, the
                  kernel's time, the plain version's, one PyTorch library
                  call computing the same function (a yardstick only; the
                  port never calls it) and the least time the card could take
                  (bytes moved / 3.35 TB/s, the H100 SXM data sheet); the two
                  reductions called again must give bitwise-equal outputs.
                  Lines are printed for the stem and a stage-3 shape, and one
                  ``kernel_odd`` line at 37 channels (the reductions' scalar
                  path).
   ``kernel_split`` B1 and B3 in their split mode (the mode of more than
                  one rank: f64 sums, an all-reduce, ``bn_finish``) at every
                  BN shape, in a one-rank NCCL group of this process:
                  bitwise equal to the single launch; the batch cut in two
                  halves, their sums added and finished: within the
                  per-channel tolerance above; ``bn_finish`` against
                  ``bn_finish_plain`` on the same f64 sums, within it too.
                  Split-mode ms per step beside the bound.
4. ``kernel``     each flash-attention kernel against its plain version at
                  the LM slice's shape ([B·H=64, L=2048, D=64] bf16, causal,
                  with the packed segment layout of the slice's own corpus),
                  and once in f32 at [16, 1024, 64]: the errors (bf16
                  outputs elementwise and as a norm) beside their limits,
                  two faults the bf16 limits must catch (an output off by
                  1%; O with a kv block dropped), kernel, plain and
                  yardstick times
                  (``scaled_dot_product_attention`` with the causal+segment
                  mask, and its backward), the bound from this run's
                  segments (989 TFLOP/s bf16 or 67 TFLOP/s f32, 3.35 TB/s)
                  and the 64 x 64 blocks each kernel visits (the bf16
                  kernels skip the pairs that the fence empties:
                  ``visited_blocks``) beside the causal ones. Then a bf16
                  line at the slice's shape without segment ids (pure
                  causal, ``kernel_causal``): the forward, dq and dk/dv
                  against their plain versions under the same limits, the
                  forward's time against SDPA's forward and the backward
                  pair's against SDPA's backward, both with
                  ``is_causal=True``.
5. ``slice``      the port's ResNet path: ``TFCluster.run`` on the local
                  backend, one executor, the port's ``resnet_spark.main_fun``
                  on full ResNet-50, bf16, ``bn_impl="pallas"``, batch 64, 5
                  steps. Per-step losses (finite), images/s over steps 2-5,
                  and each BN kernel's launch count read back from the
                  trainer's obs counters, which must be 53 per step.
   ``slice_loop`` the same with ``--steps_per_loop 5``, 20 steps: four
                  calls of the train loop (two eager warm-up steps and the
                  capture in the first, then replays of one CUDA graph a
                  step); each call's loss, images/s over calls 2 and 4, the
                  wrappers' launches (53 for each warm-up step and 53 for
                  the capture: a replay calls no wrapper), and call 3
                  traced in the trainer with ``torch.profiler``
                  (``--trace_call 3``): 53 device launches of each BN
                  kernel for each of its 5 replayed steps, 5 graph
                  launches, device busy ms and idle share.
6. ``compare``    one ResNet-50 train step, BN kernels vs their plain versions
                  (``bn_impl="plain"``: statistics from f64 sums), in
                  float32 and bf16 with TF32 off, then a 1% dgamma fault
                  that the gradient limit must catch.
7. ``slice_lm``   the port's LM path: ``TFCluster.run`` → the port's
                  ``transformer_spark.main_fun`` at ``TransformerConfig``'s
                  full width (vocab 32000, d_model 512, 6 layers, 8 heads,
                  d_ff 2048), seq 2048, batch 8, bf16, on byte-tokenized
                  packed text, 5 steps: losses (finite), tokens/s over steps
                  2-5, the packing efficiency, and each flash kernel's
                  launches, which must be 6 per step.
   ``slice_lm_loop`` the same with ``--steps_per_loop 5``, 20 steps, as
                  ``slice_loop``: tokens/s over calls 2 and 4, 6 wrapper
                  launches for each warm-up step and the capture, and in
                  the traced call 6 device launches of each flash kernel a
                  replayed step, with the host ms of the call's fetch, its
                  queueing and its sync.
8. ``compare_lm`` one LM train step on the same weights (seed 0) and packed
                  batch through the kernels (``attention="flash"``) and
                  through a reference, with TF32 off: in float32 plain
                  attention, in bf16 the kernels' plain versions on the
                  same autograd path. Loss and gradient differences
                  against stated limits; then, in each dtype, a 1% dk fault
                  in the dk/dv kernel's output that the gradient limit
                  must catch.
   ``compare_loop`` for each slice, 5 captured steps (the train loop)
                  against 5 eager steps from the same weights on the same 5
                  batches, cuDNN deterministic: every parameter, BN
                  statistic and the last loss bitwise equal, after two eager
                  runs are shown bitwise equal to each other.
9. ``ckpt_engine`` ResNet-50 at the slice's shape in this process,
                  ``compile_train_loop`` (K = 5) driven by ``run_steps``:
                  runs with an ``AsyncCheckpointEngine`` (``keep=2``, a save
                  every 10 steps) and runs without, alternating, 3 pairs,
                  cuDNN deterministic. Step ms both ways, the training
                  thread's ms a snapshot, the writer's seconds a commit,
                  commits and supersedes; every committed checkpoint must
                  equal, bitwise, a blocking copy of the engine-less twin's
                  state at its step.
10. ``recover``   the port's ResNet example at the slice's shape with
                  ``--steps_per_loop 5 --checkpoint_steps 10
                  --deterministic``, twice: run A uninterrupted through
                  ``TFCluster.run``, run B through ``--auto_recover 1``
                  (``TFCluster.run_with_recovery``) with the ``node.kill``
                  chaos site killing the trainer once, mid-run, at a
                  heartbeat placed from run A's timeline. One relaunch, the
                  second life resumed from a checkpoint (step >= 10), both
                  final checkpoints manifest-verified and B's bitwise equal
                  to A's; checkpoint bytes, the blocking save's median
                  seconds, restore seconds, seconds from the kill to the
                  second life's first logged step, and both wall times, read
                  from the runs' flight shards (``TOS_TRACE_DIR``).
11. ``mnist_compare`` ``MnistMLP`` (784-512-10) and ``MnistCNN`` at full
                  width, float32 with TF32 off: eval logits and one Adam step
                  through ``SyncDataParallel`` on the card against the same
                  on the CPU, from the same weights (seed 0) and 64 rows of
                  the examples' data (``synthetic_mnist``): logits, loss,
                  every gradient tensor and the parameters after the step
                  (against their starting values), each within 1e-4
                  relative; then a 1% fault in one gradient that the
                  gradient limit must catch.
12. ``slice_mnist`` the port's InputMode.SPARK path: ``mnist_spark.main``
                  through ``TFCluster.run``, one executor and the card, one
                  epoch of 60,000 synthetic rows (MNIST's train split) in 8
                  partitions, batch 64, with ``--model_dir`` (a checkpoint
                  every 250 steps) and ``--export_dir``: rows fed, rows the
                  trainer took off the feed and trained on (the example's
                  90% cap: 843 steps), the epoch's seconds (``cluster.train``)
                  and images/s, first and last loss (finite, falling), the
                  checkpoints and the bundle, and each kernel wrapper's
                  launches in the trainer (0: MNIST runs none of them).
13. ``pipeline_mnist`` ``mnist_pipeline.main`` on the card:
                  ``TFEstimator.fit`` on 10,000 rows, then
                  ``TFModel.transform`` of 2,048 rows in the executor; the
                  predictions must equal, row for row, the bundle's
                  ``predict_fn`` run in this process on the card, and every
                  row must report the executor's predict ran on ``cuda:0``.
14. ``parallel_mnist`` ``mnist_inference.main`` through TFParallel, one
                  instance on the card, over ``slice_mnist``'s bundle: its
                  part file must equal, row for row, the direct predict of
                  the same 2,048 rows, and so give the same correct count.
                  Each MNIST phase prints its seconds (``<phase>_seconds``).
15. ``kernels``   every kernel of the port and whether the eager and the
                  loop paths of phases 5 and 7 launched it, the traced loop
                  call ran it on the card, and (the BN kernels) run A of the
                  recover phase launched it.

Then one JSON line with every kernel's measurements (``launches``: its
wrapper's on the eager path; ``launches_loop_path``: its wrapper's on the
loop path; ``device_launches_traced_loop_call``: the card's in the traced
loop call; ``launches_recover_path``: its wrapper's in the recover phase's
run A; ``launches_mnist_path``: its wrapper's in ``slice_mnist``'s
trainer), the ``nvidia-smi``
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
#: the loop paths: four calls of ``--steps_per_loop 5`` (the first holds
#: the two eager warm-up steps and the capture), the third traced
LOOP_STEPS, TRACE_CALL = 20, 3
#: the recover phase: the example with a checkpoint every 10 steps (the
#: newest 3 kept), a kill placed KILL_AT of the way from run A's first
#: checkpoint to its last call, on a heartbeat of HEARTBEAT_S; run A must
#: leave RECOVER_MIN_ROOM_S between the two. 300 steps leave ~19 s of room
#: on an H100: run B's first life starts up to 3 s off run A's
RECOVER_STEPS, RECOVER_EVERY, RECOVER_KEEP = 300, 10, 3
HEARTBEAT_S, KILL_AT, RECOVER_MIN_ROOM_S = 0.25, 0.35, 6.0
#: the ckpt_engine phase: 8 calls of K = 5 a run, a save every 2 calls (10
#: steps), 3 pairs of runs with and without the engine
CKPT_CALLS, CKPT_EVERY, CKPT_PAIRS = 8, 2, 3
BF16_ULP = 2.0 ** -7  # bf16 keeps 8 significant bits
#: f32 per-channel outputs of sums of up to 8e5 values, relative to the
#: largest (floor 1): the kernels round each sum once from near-exact
#: partials, the plain versions sum in f64 (bn_stats) or in torch's f32
#: order (bn_bwd_reduce)
REL_F32_SUM = 1e-4

#: (wrapper, TPU kernel it replaces, (bytes per element of the activation
#: moved, f32 per-channel vectors moved), flops per element, route, source)
KERNEL_TABLE = [
    ("bn_stats", "tensorflowonspark_tpu/ops/fused_bn.py:87", (1, 2), 3,
     "cuda", "tensorflowonspark_tpu_torch/csrc/fused_bn.cu"),
    ("bn_normalize", "tensorflowonspark_tpu/ops/fused_bn.py:108", (2, 4), 3,
     "triton", "tensorflowonspark_tpu_torch/ops/fused_bn.py"),
    ("bn_bwd_reduce", "tensorflowonspark_tpu/ops/fused_bn.py:116", (2, 4), 5,
     "cuda", "tensorflowonspark_tpu_torch/csrc/fused_bn.cu"),
    ("bn_bwd_dx", "tensorflowonspark_tpu/ops/fused_bn.py:138", (3, 5), 7,
     "triton", "tensorflowonspark_tpu_torch/ops/fused_bn.py"),
]
#: the reductions, which must repeat bitwise
REDUCTIONS = ("bn_stats", "bn_bwd_reduce")

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


def bn_cases(torch, F, fused_bn, nhwc, x, dy, gamma, beta, eps):
    """``{wrapper: (kernel, plain version, library call, relative tolerance)}``
    of the four BN kernels on ``x``, ``dy`` ``[R, C]``, the activation of
    shape ``nhwc``."""
    x4 = x.view(nhwc).permute(0, 3, 1, 2)  # NCHW view, channels-last memory
    dy4 = dy.view(nhwc).permute(0, 3, 1, 2)
    mean, var = fused_bn.bn_stats_plain(x)
    dgamma, dbeta = fused_bn.bn_bwd_reduce_plain(x, dy, mean, var, eps)
    invstd = torch.rsqrt(var + eps)
    nbb = torch.ops.aten.native_batch_norm_backward
    return {
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


def check_bn(torch, name, kernel, plain, rel_tol, where):
    """The kernel's max abs error against its plain version and its
    tolerance; raises beyond it, and for a reduction whose second call is
    not bitwise equal to its first."""
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
        raise AssertionError("{} at {}: max abs err {} > tolerance {}".format(name, where, err, tol))
    if name in REDUCTIONS and not all(torch.equal(a, b) for a, b in zip(kernel(), got)):
        raise AssertionError("{} at {}: a second call is not bitwise equal to the first".format(
            name, where))
    return err, tol


def phase_kernel(torch, F, fused_bn, shapes):
    """Every kernel against its plain version at each distinct shape, and the
    reductions' repeat bitwise; per-step totals weight each shape by how
    many layers have it. Then every kernel at 37 channels."""
    from tensorflowonspark_tpu_torch.examples.resnet.bench_bn import time_ms

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
        cases = bn_cases(torch, F, fused_bn, shape, x, dy, gamma, beta, eps)
        for name, (kernel, plain, library, rel_tol) in cases.items():
            err, tol = check_bn(torch, name, kernel, plain, rel_tol, shape)
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
                      "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "repeat_bitwise": name in REDUCTIONS})
        del x, dy, cases
    # 37 channels: 74-byte rows, so the reductions take their scalar path
    rows, c = BATCH * 14 * 14, 37
    x = (torch.randn(rows, c, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
    dy = torch.randn(rows, c, device="cuda", generator=gen).to(torch.bfloat16)
    gamma, beta = torch.randn(c, device="cuda", generator=gen), torch.randn(c, device="cuda", generator=gen)
    line = {"phase": "kernel_odd", "shape": [rows, c], "dtype": "bfloat16",
            "vector_path": fused_bn._vector_path(x, dy)}
    odd = bn_cases(torch, F, fused_bn, (BATCH, 14, 14, c), x, dy, gamma, beta, eps)
    for name, (kernel, plain, _, rel_tol) in odd.items():
        err, tol = check_bn(torch, name, kernel, plain, rel_tol, (rows, c))
        line[name] = {"max_abs_err": err, "tolerance": tol, "ms": time_ms(torch, kernel, flush),
                      "bound_ms": bound(name, rows, c, x.element_size())[0],
                      "repeat_bitwise": name in REDUCTIONS}
    emit(line)
    return totals


def phase_kernel_split(torch, fused_bn, shapes):
    """B1 and B3 in their split mode (the mode of more than one rank: f64
    sums, an all-reduce, ``bn_finish``) at every BN shape of the step, in a
    one-rank NCCL group of this process: equal bitwise to the single launch.
    Then the batch cut in two halves, their sums added (the all-reduce's
    arithmetic without a second card) and finished over all rows: within
    the kernel phase's per-channel tolerance of the single launch on the
    whole. Times the split mode (sums launch + finish launch, no
    all-reduce) per step, beside the single launch's bound (the same bytes
    moved, and 32 bytes a channel more)."""
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch import util
    from tensorflowonspark_tpu_torch.examples.resnet.bench_bn import time_ms

    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:{}".format(
        util.find_free_port("127.0.0.1")), rank=0, world_size=1)
    try:
        if util.world_size() != 1:
            raise AssertionError("a one-rank group must keep the single launches")
        counts = {}
        for shp in shapes:
            counts[shp] = counts.get(shp, 0) + 1
        flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(5)
        eps = 1e-5
        totals = {name: {"split_ms": 0.0, "bound_ms": 0.0, "max_abs_err_halves": 0.0, "shapes_bitwise": 0}
                  for name in REDUCTIONS}
        finish_ms = None
        finish = {"max_abs_err": 0.0, "bitwise": 0, "cases": 0}
        for (n, h, w, c), n_layers in sorted(counts.items()):
            rows = n * h * w
            x = (torch.randn(rows, c, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
            dy = torch.randn(rows, c, device="cuda", generator=gen).to(torch.bfloat16)
            mean, var = fused_bn.bn_stats(x)
            cases = {
                "bn_stats": ((mean, var), lambda a: fused_bn.bn_stats_sums(a), True, (x,)),
                "bn_bwd_reduce": (fused_bn.bn_bwd_reduce(x, dy, mean, var, eps),
                                  lambda a, b: fused_bn.bn_bwd_reduce_sums(a, b, mean, var, eps), False,
                                  (x, dy)),
            }
            half = rows // 2
            for name, (single, sums_fn, stats, args) in cases.items():
                sums = sums_fn(*args)
                dist.all_reduce(sums)
                split = fused_bn.bn_finish(sums, rows, stats)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(split, single)):
                    raise AssertionError("{} split at one rank differs from the single launch at "
                                         "{}".format(name, (rows, c)))
                halves = sums_fn(*(a[:half] for a in args)) + sums_fn(*(a[half:] for a in args))
                got = fused_bn.bn_finish(halves, rows, stats)
                err = max(float((g - r).abs().max()) for g, r in zip(got, single))
                tol = REL_F32_SUM * max(1.0, max(float(r.abs().max()) for r in single))
                if not err <= tol:
                    raise AssertionError("{} from two halves at {}: max abs err {} > {}".format(
                        name, (rows, c), err, tol))
                # the finish kernel against its plain version on the same f64 sums
                for finished, on in ((split, sums), (got, halves)):
                    plain = fused_bn.bn_finish_plain(on, rows, stats)
                    err_plain = max(float((g - r).abs().max()) for g, r in zip(finished, plain))
                    tol_plain = REL_F32_SUM * max(1.0, max(float(r.abs().max()) for r in plain))
                    if not err_plain <= tol_plain:
                        raise AssertionError("bn_finish ({}) vs bn_finish_plain at {}: max abs err {} > "
                                             "{}".format(name, (rows, c), err_plain, tol_plain))
                    finish["max_abs_err"] = max(finish["max_abs_err"], err_plain)
                    finish["bitwise"] += all(torch.equal(g, r) for g, r in zip(finished, plain))
                    finish["cases"] += 1
                ms = time_ms(torch, lambda: fused_bn.bn_finish(sums_fn(*args), rows, stats), flush)
                tot = totals[name]
                tot["split_ms"] += n_layers * ms
                b_ms, _ = bound(name, rows, c, x.element_size())
                tot["bound_ms"] += n_layers * (b_ms + 32 * c / HBM_BYTES_PER_S * 1e3)
                tot["max_abs_err_halves"] = max(tot["max_abs_err_halves"], err)
                tot["shapes_bitwise"] += 1
            if (n, h, w, c) == (BATCH, 112, 112, 64):
                stem_sums = fused_bn.bn_stats_sums(x)
                finish_ms = time_ms(torch, lambda: fused_bn.bn_finish(stem_sums, rows, True), flush)
            del x, dy
        emit({"phase": "kernel_split", "world": dist.get_world_size(), "backend": "nccl",
              "per": "ResNet-50 step, batch {}, {} px, bf16: sum over its 53 BatchNorm layers".format(
                  BATCH, IMAGE),
              "tolerance_halves": "{} x max(1, max |single|)".format(REL_F32_SUM),
              "bn_finish_ms_at_stem": finish_ms,
              "bn_finish_vs_plain": dict(finish, tolerance="{} x max(1, max |plain|)".format(REL_F32_SUM)),
              **totals})
        return totals
    finally:
        dist.destroy_process_group()


def wrapper_calls(steps, steps_per_loop):
    """How many steps' launches the kernel wrappers make in a run: every
    step's eagerly; on the loop path (K > 1) the warm-up steps' and the
    capture's, since a replay calls no wrapper."""
    from tensorflowonspark_tpu_torch.train.strategy import _CapturedLoop

    return steps if steps_per_loop == 1 else _CapturedLoop.WARMUP + 1


def loop_trace(events, names, per_step, steps_per_loop):
    """The readings of the loop call the trainer traced (``--trace_call``),
    a call of replays only: the card ran ``per_step`` of each kernel in
    ``names`` for each of its K steps, in K graph launches."""
    traced = [e["device_trace"] for e in events if "device_trace" in e]
    if len(traced) != 1:
        raise AssertionError("expected one traced call, got {}".format(len(traced)))
    trace = traced[0]
    bad = {n: trace["launches"].get(n) for n in names if trace["launches"].get(n) != per_step * steps_per_loop}
    if bad or trace["graph_launches"] != steps_per_loop:
        raise AssertionError("traced loop call: device launches {} (want {} x {} each), graph launches {} "
                             "(want {})".format(bad, per_step, steps_per_loop, trace["graph_launches"],
                                                steps_per_loop))
    return trace


def phase_slice(torch, fused_bn, steps=STEPS, steps_per_loop=1):
    """The port's main path through the user's entry points; with
    ``steps_per_loop`` K > 1 its loop path (``--steps_per_loop K``: one
    captured CUDA graph a step, replayed), whose call ``TRACE_CALL`` the
    trainer traces. Returns each BN wrapper's launches in the run (53 a
    step for :func:`wrapper_calls` steps) and, on the loop path, the traced
    call's device launches of each BN kernel (53 a replayed step)."""
    from tensorflowonspark_tpu_torch import TFCluster, util
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.examples.resnet import resnet_spark

    args = resnet_spark.build_parser().parse_args([
        "--dataset", "imagenet", "--bn_impl", "pallas", "--batch_size", str(BATCH),
        "--train_steps", str(steps), "--log_steps", "1", "--steps_per_loop", str(steps_per_loop),
        "--trace_call", str(TRACE_CALL if steps_per_loop > 1 else 0),
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
    events = sorted(
        (e for e in metrics["events"] if e.get("span") == "train_step"), key=lambda e: e["step"]
    )
    losses = [e.get("loss") for e in events]
    calls = steps // steps_per_loop
    if len(events) != calls or not all(isinstance(v, float) and math.isfinite(v) for v in losses):
        raise AssertionError("expected {} finite losses, got {}".format(calls, losses))
    # past the first call (build, warm-up, capture), the traced call left out
    timed = [e["dur_s"] for e in events[1:] if "device_trace" not in e]
    launches = {
        name: int(metrics["counters"].get("fused_bn_{}_launches_total".format(name), {}).get("value", 0))
        for name, *_ in KERNEL_TABLE
    }
    want = 53 * wrapper_calls(steps, steps_per_loop)
    line = {"phase": "slice" if steps_per_loop == 1 else "slice_loop", "model": "resnet50",
            "dtype": "bfloat16", "bn_impl": "pallas", "batch": BATCH, "image": IMAGE, "steps": steps,
            "steps_per_loop": steps_per_loop, "logged_steps": [e["step"] for e in events],
            "losses": losses, "call_s": [e["dur_s"] for e in events],
            "images_per_sec_after_first_call": BATCH * steps_per_loop * len(timed) / sum(timed),
            "launches": launches, "expected_launches": want, "wall_s": wall}
    bad = {k: v for k, v in launches.items() if v != want}
    trace = None
    if steps_per_loop > 1 and not bad:
        trace = loop_trace(events, [name for name, *_ in KERNEL_TABLE], 53, steps_per_loop)
        line.update(traced_call=TRACE_CALL, device_trace=trace)
    emit(line)
    if bad:
        raise AssertionError("kernel wrapper launches {} != 53 x {} steps".format(
            bad, wrapper_calls(steps, steps_per_loop)))
    return launches, trace and trace["launches"]


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
    # (loss limit, gradient limit). float32: the gradient limit sits between
    # the sound reading (3.1e-7 on an H100) and the 1% dgamma fault below
    # (9.0e-4); it holds only because both sides round each layer's Σx and
    # Σx² once from exact sums (any two f32 summation orders of the stem's
    # statistics move the gradients about 2e-4). bfloat16: BN outputs that
    # round one bf16 ulp apart propagate through the network (the gradients
    # read 3.8e-3 apart)
    limits = {"float32": (1e-3, 1e-4), "bfloat16": (5e-2, 3e-2)}
    grads = {}
    for dtype_name, (tol, grad_tol) in limits.items():
        dtype = getattr(torch, dtype_name)
        lk, gk, nk = _train_grads(torch, fused_bn, resnet, dtype, "pallas", batch, loss_fn)
        lp, gp, np_ = _train_grads(torch, fused_bn, resnet, dtype, "plain", batch, loss_fn)
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
    from tensorflowonspark_tpu_torch.examples.resnet.bench_bn import time_ms

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
        n_blk = -(-length // 64)
        blocks_causal = b * n_blk * (n_blk + 1) // 2
        blocks_fenced = int(fa.visited_blocks(seg.cpu(), True).sum())
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
                    "bound_ms": b_ms, "bound_by": b_by, "bound_ms_dense_causal": causal_ms,
                    # 64 x 64 block pairs of the batch: the bf16 kernels
                    # skip those the fence empties, the f32 ones only the
                    # causal ones
                    "blocks_visited": blocks_fenced if dtype_name == "bfloat16" else blocks_causal,
                    "blocks_causal": blocks_causal}
            emit(line)
            if dtype_name == "bfloat16":
                n_layers = LM["n_layers"]
                totals[name] = {"ms": n_layers * ms, "plain_ms": n_layers * plain_ms,
                                "library_ms": n_layers * library_ms, "bound_ms": n_layers * b_ms,
                                "bound_by": b_by, "max_abs_err": err}
        del q, k, v, do, q4, k4, v4, do4, qg, kg, vg, out, o_ref, lse_ref, delta, mask
        torch.cuda.empty_cache()
    return totals


def phase_flash_causal(torch, F, fa):
    """The bf16 kernels at the slice's shape without segment ids (pure
    causal, every causal block visited): the forward, dq and dk/dv against
    their plain versions under the bf16 limits, the forward's time against
    SDPA's forward and the backward pair's against SDPA's whole backward,
    both with ``is_causal=True``. This shows the kernels' design apart from
    the fence's skipped blocks."""
    from tensorflowonspark_tpu_torch.examples.resnet.bench_bn import time_ms

    from torch.nn.attention import SDPBackend, sdpa_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    gen = torch.Generator(device="cuda").manual_seed(2)
    heads, d = LM["n_heads"], LM["d_model"] // LM["n_heads"]
    shape = (LM_BATCH * heads, LM_SEQ, d)
    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    o_ref, lse = fa.flash_fwd_plain(q, k, v, None, scale, True, heads)
    bwd = (None, do, lse, (do.float() * o_ref.float()).sum(-1), scale, True, heads)
    q4, k4, v4, do4 = (t.view(LM_BATCH, heads, LM_SEQ, d) for t in (q, k, v, do))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def library_fwd():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    n_blk = -(-LM_SEQ // 64)
    pairs = LM_BATCH * heads * LM_SEQ * (LM_SEQ + 1) // 2
    no_ids = torch.zeros(LM_BATCH, LM_SEQ, dtype=torch.int32)
    line = {"phase": "kernel_causal", "shape": list(shape), "dtype": "bfloat16", "causal": True,
            "segments": None, "blocks_visited": int(fa.visited_blocks(no_ids, True).sum()),
            "blocks_causal": LM_BATCH * n_blk * (n_blk + 1) // 2,
            "library": "sdpa backward (dq+dk+dv), is_causal=True"}
    for name, kernel, plain in (
            ("flash_fwd", lambda: fa.flash_fwd(q, k, v, None, scale, True, heads), lambda: (o_ref, lse)),
            ("flash_bwd_dq", lambda: fa.flash_bwd_dq(q, k, v, *bwd), lambda: fa.flash_bwd_dq_plain(q, k, v, *bwd)),
            ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(q, k, v, *bwd),
             lambda: fa.flash_bwd_dkv_plain(q, k, v, *bwd))):
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        err, failures, readings = flash_errors(name, got, want)
        if failures:
            raise AssertionError("{} bfloat16 at {} without segment ids: {}".format(name, shape, failures))
        del got, want
        b_ms, b_by = flash_bound(name, no_ids, heads, LM_SEQ, d, q.element_size(), pairs)
        line[name] = {"ms": time_ms(torch, kernel, flush), "max_abs_err": err, "elem_err": readings["elem"],
                      "norm_err": readings["norm"], "bound_ms": b_ms, "bound_by": b_by}
    line["flash_fwd"].update(library="sdpa forward, is_causal=True", library_ms=time_ms(torch, library_fwd, flush))
    line["library_ms"] = time_ms(
        torch, lambda: torch.autograd.grad(out, (qg, kg, vg), do4, retain_graph=True), flush)
    line["pair_ms"] = line["flash_bwd_dq"]["ms"] + line["flash_bwd_dkv"]["ms"]
    emit(line)
    del q, k, v, do, q4, k4, v4, do4, qg, kg, vg, out, o_ref, lse, bwd
    torch.cuda.empty_cache()


def phase_slice_lm(torch, fa, data_dir, steps, steps_per_loop=1):
    """The port's LM path through the user's entry points; with
    ``steps_per_loop`` K > 1 its loop path, traced as in :func:`phase_slice`.
    Returns each flash wrapper's launches in the run (6 a step for
    :func:`wrapper_calls` steps) and, on the loop path, the traced call's
    device launches of each flash kernel (6 a replayed step)."""
    from tensorflowonspark_tpu_torch import TFCluster, util
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.examples.transformer import transformer_spark

    args = transformer_spark.build_parser().parse_args([
        "--vocab_size", str(LM["vocab_size"]), "--d_model", str(LM["d_model"]),
        "--n_layers", str(LM["n_layers"]), "--n_heads", str(LM["n_heads"]),
        "--d_ff", str(LM["d_ff"]), "--seq_len", str(LM_SEQ), "--batch_size", str(LM_BATCH),
        "--dtype", "bfloat16", "--tokenizer", "byte", "--train_steps", str(steps),
        "--log_steps", "1", "--data_dir", data_dir, "--steps_per_loop", str(steps_per_loop),
        "--trace_call", str(TRACE_CALL if steps_per_loop > 1 else 0),
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
    calls = steps // steps_per_loop
    if len(events) != calls or not all(isinstance(v, float) and math.isfinite(v) for v in losses):
        raise AssertionError("expected {} finite LM losses, got {}".format(calls, losses))
    # past the first call (build, warm-up, capture), the traced call left out
    timed = [e["dur_s"] for e in events[1:] if "device_trace" not in e]
    launches = {
        name: int(metrics["counters"].get(
            "flash_attention_{}_launches_total".format(name[len("flash_"):]), {}).get("value", 0))
        for name, *_ in FLASH_TABLE
    }
    want = LM["n_layers"] * wrapper_calls(steps, steps_per_loop)
    efficiency = metrics["gauges"].get("text_pack_efficiency", {}).get("value")
    line = {"phase": "slice_lm" if steps_per_loop == 1 else "slice_lm_loop", "model": "transformer",
            "config": dict(LM, seq_len=LM_SEQ), "dtype": "bfloat16", "batch": LM_BATCH, "steps": steps,
            "steps_per_loop": steps_per_loop, "logged_steps": [e["step"] for e in events],
            "losses": losses, "call_s": [e["dur_s"] for e in events],
            "tokens_per_sec_after_first_call": LM_BATCH * LM_SEQ * steps_per_loop * len(timed) / sum(timed),
            "packing_efficiency": efficiency, "launches": launches,
            "expected_launches": want, "wall_s": wall}
    bad = {k: v for k, v in launches.items() if v != want}
    trace = None
    if steps_per_loop > 1 and not bad:
        trace = loop_trace(events, [name for name, *_ in FLASH_TABLE], LM["n_layers"], steps_per_loop)
        line.update(traced_call=TRACE_CALL, device_trace=trace)
    emit(line)
    if bad:
        raise AssertionError("flash kernel wrapper launches {} != {} x {} steps".format(
            bad, LM["n_layers"], wrapper_calls(steps, steps_per_loop)))
    if not (isinstance(efficiency, float) and 0 < efficiency <= 1):
        raise AssertionError("packing efficiency {} outside (0, 1]".format(efficiency))
    return launches, trace and trace["launches"]


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


def _snapshot(torch, state):
    return {k: v.detach().clone() for k, v in dict(state.params, **state.model_state).items()}


def _mismatches(torch, a, b):
    """Names of the tensors of snapshot ``a`` that are not bitwise equal
    to ``b``'s."""
    return [k for k in a if not torch.equal(a[k], b[k])]


def phase_compare_loop(torch, resnet, transformer, lm_host_batch, k=STEPS):
    """For each slice, K captured steps (``compile_train_loop``: two eager
    warm-up steps, the capture, replays) against K eager steps from the same
    weights on the same K batches, with cuDNN deterministic: every
    parameter and BN statistic, and the last step's loss, must be bitwise
    equal. Two eager runs are held bitwise equal first, so that a mismatch
    is the capture's, not a non-deterministic algorithm's. Peak memory of
    each side beside."""
    import numpy as np

    from tensorflowonspark_tpu_torch.examples.resnet import resnet_spark
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    strategy = SyncDataParallel("cuda")
    rng = np.random.default_rng(7)
    image_batches = [strategy.shard_batch({
        "image": rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
        "label": rng.integers(0, 1000, BATCH)}) for _ in range(k)]
    lm_batch = strategy.shard_batch(lm_host_batch)
    lm_batches = [{key: torch.roll(v, shifts=i, dims=1) for key, v in lm_batch.items()} for i in range(k)]
    args = resnet_spark.build_parser().parse_args(["--dataset", "imagenet", "--batch_size", str(BATCH)])

    def resnet_run(loop):
        optimizer = optim.sgd(resnet_spark.lr_schedule(args), momentum=0.9)
        state = strategy.create_state(lambda: resnet.resnet50(
            dtype=torch.bfloat16, bn_impl="pallas", generator=torch.Generator().manual_seed(0)), optimizer)
        loss_fn = resnet.make_loss_fn(weight_decay=1e-4)
        if loop:
            return strategy.compile_train_loop(loss_fn, optimizer, k, mutable=True), state, image_batches
        return strategy.compile_train_step(loss_fn, optimizer, mutable=True), state, image_batches

    def lm_run(loop):
        model = transformer.create_model(dtype="bfloat16", **LM)
        optimizer = optim.adamw(3e-4)
        state = strategy.create_state(transformer.make_init_fn(model), optimizer,
                                      torch.Generator().manual_seed(0))
        loss_fn = transformer.make_loss_fn(model)
        if loop:
            return strategy.compile_train_loop(loss_fn, optimizer, k, has_aux=True), state, lm_batches
        return strategy.compile_train_step(loss_fn, optimizer, has_aux=True), state, lm_batches

    try:
        for name, build in (("resnet50", resnet_run), ("transformer", lm_run)):
            runs = {}
            for side in ("eager", "eager_again", "captured"):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                fn, state, batches = build(side == "captured")
                t0 = time.perf_counter()
                if side == "captured":
                    state, metrics = fn(state, batches)
                else:
                    for b in batches:
                        state, metrics = fn(state, b)
                torch.cuda.synchronize()
                runs[side] = (_snapshot(torch, state), metrics["loss"].clone(), time.perf_counter() - t0,
                              torch.cuda.max_memory_allocated() / 1e9, state.step)
                del fn, state, metrics
            repeat = _mismatches(torch, runs["eager"][0], runs["eager_again"][0])
            captured = _mismatches(torch, runs["eager"][0], runs["captured"][0])
            loss_equal = torch.equal(runs["eager"][1], runs["captured"][1])
            emit({"phase": "compare_loop", "model": name, "dtype": "bfloat16", "steps": k,
                  "cudnn_deterministic": True, "tensors": len(runs["eager"][0]),
                  "eager_repeat_mismatches": repeat, "captured_mismatches": captured,
                  "loss_eager": float(runs["eager"][1]), "loss_captured": float(runs["captured"][1]),
                  "loss_bitwise": loss_equal, "steps_after": runs["captured"][4],
                  "seconds": {side: r[2] for side, r in runs.items()},
                  "peak_memory_gb": {side: r[3] for side, r in runs.items()}})
            if repeat:
                raise AssertionError("{}: two eager runs differ in {} tensors: the comparison "
                                     "cannot blame the capture".format(name, len(repeat)))
            if captured or not loss_equal or runs["captured"][4] != k:
                raise AssertionError("{}: the captured loop differs from the eager steps in {} "
                                     "tensors (loss bitwise: {})".format(name, len(captured), loss_equal))
            del runs
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        torch.cuda.empty_cache()


def _state_host(torch, state):
    """A blocking copy of a TrainState's checkpointed tensors, in the
    layout of a checkpoint file's tree."""
    torch.cuda.synchronize()
    opt = state.opt_state
    return {"step": state.step,
            "params": {k: v.detach().cpu().clone() for k, v in state.params.items()},
            "model_state": {k: v.detach().cpu().clone() for k, v in state.model_state.items()},
            "opt_state": {"count": opt["count"].cpu().clone(),
                          "trace": {k: v.cpu().clone() for k, v in opt["trace"].items()}}}


def _tree_mismatches(torch, got, want, where=""):
    """Paths where two checkpoint trees differ: keys, step, or any tensor
    not bitwise equal."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [where or "/"]
        return [m for k in sorted(want) for m in _tree_mismatches(torch, got[k], want[k], where + "/" + str(k))]
    if isinstance(want, torch.Tensor):
        ok = isinstance(got, torch.Tensor) and got.dtype == want.dtype and torch.equal(got, want)
        return [] if ok else [where]
    return [] if got == want else [where]


def _count_tensors(torch, tree):
    if isinstance(tree, dict):
        return sum(_count_tensors(torch, v) for v in tree.values())
    return int(isinstance(tree, torch.Tensor))


def phase_ckpt_engine(torch, resnet, work):
    """ResNet-50 at the slice's shape in this process, ``compile_train_loop``
    with K = 5 driven by ``run_steps``: runs with an ``AsyncCheckpointEngine``
    (``keep=2``, a save every ``CKPT_EVERY`` calls = every 10 steps) and runs
    without one, alternating, ``CKPT_PAIRS`` pairs, cuDNN deterministic. Step
    ms both ways after the first call (host clock from a sync after one call
    to a sync after the next; in the engine runs the interval holds the
    snapshot queued after the first), the training thread's ms in each
    ``ckpt_snapshot`` span, the writer's seconds per commit, commits and
    supersedes. The ordering check: every committed checkpoint — each one
    hard-linked aside as soon as a sync sees it, before ``keep`` prunes it —
    equals, bitwise, a blocking copy of the engine-less twin's state at the
    same step (taken outside the timed intervals)."""
    import shutil

    import numpy as np

    from tensorflowonspark_tpu_torch import ckpt, obs
    from tensorflowonspark_tpu_torch.examples.resnet import resnet_spark
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, checkpoint, optim
    from tensorflowonspark_tpu_torch.train.strategy import run_steps

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    strategy = SyncDataParallel("cuda")
    rng = np.random.default_rng(11)
    windows = [[strategy.shard_batch({
        "image": rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
        "label": rng.integers(0, 1000, BATCH)}) for _ in range(STEPS)] for _ in range(CKPT_CALLS)]
    args = resnet_spark.build_parser().parse_args(["--dataset", "imagenet", "--batch_size", str(BATCH)])
    loss_fn = resnet.make_loss_fn(weight_decay=1e-4)
    counters = ("ckpt_commits_total", "ckpt_superseded_total", "ckpt_write_seconds_total")

    def keep_aside(model_dir, aside):
        """Hard-link every published checkpoint not yet kept aside (no data
        is copied; a later prune leaves the links)."""
        for name in os.listdir(model_dir):
            src, dst = os.path.join(model_dir, name), os.path.join(aside, name)
            if name.startswith("ckpt_") and not os.path.isdir(dst):
                os.makedirs(dst + ".part")
                for f in os.listdir(src):
                    os.link(os.path.join(src, f), os.path.join(dst + ".part", f))
                os.rename(dst + ".part", dst)

    def run(model_dir):
        optimizer = optim.sgd(resnet_spark.lr_schedule(args), momentum=0.9)
        state = strategy.create_state(lambda: resnet.resnet50(
            dtype=torch.bfloat16, bn_impl="pallas", generator=torch.Generator().manual_seed(0)), optimizer)
        loop = strategy.compile_train_loop(loss_fn, optimizer, STEPS, mutable=True)
        ends, starts, copies = [], [], {}
        aside = model_dir and model_dir + "_committed"

        def hook(s, call, metrics):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
            if model_dir is None and call % CKPT_EVERY == 0:
                copies[s.step] = _state_host(torch, s)
            if aside:
                keep_aside(model_dir, aside)
            starts.append(time.perf_counter())

        engine = None
        if model_dir:
            os.makedirs(aside)
            engine = ckpt.AsyncCheckpointEngine(model_dir, keep=2, save_every_n=CKPT_EVERY)
        before = {c: obs.counter(c).value for c in counters}
        t0 = time.time()
        run_steps(loop, state, windows, engine=engine, hooks=[hook])
        if engine is not None:
            engine.close()
            keep_aside(model_dir, aside)
        step_ms = [(b - a) / STEPS * 1e3 for a, b in zip(starts[:-1], ends[1:])][1:]  # after call 1
        snaps = [e["dur_s"] * 1e3 for e in obs.get_registry().events()
                 if e.get("span") == "ckpt_snapshot" and e["ts"] >= t0]
        delta = {c: obs.counter(c).value - before[c] for c in counters}
        return step_ms, snaps, delta, copies, aside

    work = os.path.join(work, "engine")
    try:
        shutil.rmtree(work, ignore_errors=True)
        sides = {"engine": [], "none": []}
        twin = None
        for pair in range(CKPT_PAIRS):
            for side in (("engine", "none") if pair % 2 == 0 else ("none", "engine")):
                model_dir = os.path.join(work, "engine_{}".format(pair)) if side == "engine" else None
                torch.cuda.empty_cache()
                step_ms, snaps, delta, copies, aside = run(model_dir)
                sides[side].append({"step_ms": step_ms, "snapshot_ms": snaps, "counters": delta, "aside": aside})
                if side == "none" and twin is None:
                    twin = copies
        checked, bad = [], []
        for r in sides["engine"]:
            for name in sorted(os.listdir(r["aside"])):
                path = os.path.join(r["aside"], name)
                ok, reason = ckpt.verify(path)
                tree = checkpoint.restore_checkpoint(path)
                want = twin.get(tree["step"])
                diff = ["no twin copy"] if want is None else _tree_mismatches(torch, tree, want)
                checked.append({"checkpoint": name, "step": tree["step"], "verify": reason,
                                "mismatches": len(diff)})
                if diff or not ok:
                    bad.append((path, reason, diff[:5]))
        commits = int(sum(r["counters"]["ckpt_commits_total"] for r in sides["engine"]))
        per_side = {side: [v for r in runs for v in r["step_ms"]] for side, runs in sides.items()}
        line = {
            "phase": "ckpt_engine", "model": "resnet50", "dtype": "bfloat16", "bn_impl": "pallas",
            "batch": BATCH, "steps_per_loop": STEPS, "calls": CKPT_CALLS, "pairs": CKPT_PAIRS,
            "save_every_n_calls": CKPT_EVERY, "keep": 2, "cudnn_deterministic": True,
            "step_ms": {side: [[round(v, 4) for v in r["step_ms"]] for r in runs] for side, runs in sides.items()},
            "step_ms_median": {side: float(np.median(v)) for side, v in per_side.items()},
            "snapshot_ms": [[round(v, 3) for v in r["snapshot_ms"]] for r in sides["engine"]],
            "writer_s_per_commit": [r["counters"]["ckpt_write_seconds_total"] / max(1, r["counters"]["ckpt_commits_total"])
                                    for r in sides["engine"]],
            "commits": [r["counters"]["ckpt_commits_total"] for r in sides["engine"]],
            "supersedes": [r["counters"]["ckpt_superseded_total"] for r in sides["engine"]],
            "checked": checked, "tensors": _count_tensors(torch, twin[min(twin)]) if twin else 0,
        }
        emit(line)
        if bad or not checked or len(checked) != commits:
            raise AssertionError("ckpt_engine: {} of {} committed checkpoints ({} commits) differ from the "
                                 "blocking copy at their step or fail verify: {}".format(
                                     len(bad), len(checked), commits, bad))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        torch.cuda.empty_cache()


def _trainer_lives(flight, root):
    """``[(start wall time, records)]`` of the trainer children's flight
    shards under ``root``, oldest first."""
    lives = []
    for shard in flight.list_shards(root):
        records, _ = flight.read_shard(shard)
        meta = [r for r in records if r.get("kind") == "meta"]
        if meta and str(meta[0].get("proc", "")).startswith("trainer-"):
            lives.append((meta[0]["wall"], records))
    return sorted(lives, key=lambda life: life[0])


def _spans(records, name):
    return [r for r in records if r.get("kind") == "span" and r.get("name") == name]


def phase_recover(torch, fused_bn, work):
    """The port's ResNet example at the slice's shape (``--steps_per_loop 5
    --checkpoint_steps 10``, cuDNN deterministic), twice. Run A
    uninterrupted through ``TFCluster.run``; run B through the example's
    ``--auto_recover 1`` (``TFCluster.run_with_recovery``) with a chaos plan
    arming ``node.kill`` on executor 0, once-latched, at a heartbeat placed
    from run A's own timeline (``KILL_AT`` of the way from its first
    checkpoint to its last call). Both runs trace into flight shards
    (``TOS_TRACE_DIR``): the kill, each life's ``ckpt_restore`` /
    ``ckpt_save`` / ``train_step`` spans. Fails unless B relaunched once,
    its second life resumed at a step >= ``RECOVER_EVERY``, both final
    checkpoints pass ``manifest.verify``, and B's final checkpoint equals
    A's bitwise, tensor for tensor, and in ``step``. Returns each BN
    wrapper's launches in run A (its counts start at 0 in the fresh
    trainer)."""
    import shutil
    import statistics

    from tensorflowonspark_tpu_torch import TFCluster, chaos, util
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.ckpt import manifest
    from tensorflowonspark_tpu_torch.examples.resnet import resnet_spark
    from tensorflowonspark_tpu_torch.obs import flight
    from tensorflowonspark_tpu_torch.train import checkpoint

    def argv(model_dir):
        return ["--dataset", "imagenet", "--bn_impl", "pallas", "--batch_size", str(BATCH),
                "--train_steps", str(RECOVER_STEPS), "--log_steps", str(STEPS), "--steps_per_loop", str(STEPS),
                "--checkpoint_steps", str(RECOVER_EVERY), "--keep_checkpoints", str(RECOVER_KEEP),
                "--model_dir", model_dir, "--deterministic"]

    dirs = {side: os.path.join(work, "recover_" + side) for side in ("a", "b")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    keys = ("TOS_HEARTBEAT_INTERVAL", "TOS_MONITOR_INTERVAL", flight.TRACE_DIR_ENV)
    saved_env = {k: os.environ.get(k) for k in keys}
    os.environ.update({"TOS_HEARTBEAT_INTERVAL": str(HEARTBEAT_S), "TOS_MONITOR_INTERVAL": "1"})
    try:
        # run A: uninterrupted
        os.environ[flight.TRACE_DIR_ENV] = os.path.join(dirs["a"], "trace")
        model_a = os.path.join(dirs["a"], "model")
        fused_bn.reset_launch_counts()
        t0 = time.perf_counter()
        sc = LocalSparkContext(num_executors=1)
        try:
            cluster = TFCluster.run(sc, resnet_spark.main_fun, resnet_spark.build_parser().parse_args(argv(model_a)),
                                    1, input_mode=TFCluster.InputMode.TENSORFLOW, master_node="chief",
                                    env={util.ENV_PLATFORM: "gpu"})
            if not cluster.wait_for_completion(timeout=900):
                raise TimeoutError("run A did not finish within 900 s")
            metrics = cluster.metrics(include_driver=False)
            cluster.shutdown()
        finally:
            sc.stop()
        wall_a = time.perf_counter() - t0
        launches = {name: int(metrics["counters"].get("fused_bn_{}_launches_total".format(name), {}).get("value", 0))
                    for name, *_ in KERNEL_TABLE}
        lives_a = _trainer_lives(flight, os.path.join(dirs["a"], "trace"))
        if len(lives_a) != 1:
            raise AssertionError("run A: expected one trainer life, found {}".format(len(lives_a)))
        start_a, recs_a = lives_a[0]
        saves_a = _spans(recs_a, "ckpt_save")
        calls_a = _spans(recs_a, "train_step")
        first_save = min(r["ts"] + r["dur_s"] for r in saves_a)
        last_call = max(r["ts"] for r in calls_a)
        room = last_call - first_save
        if room < RECOVER_MIN_ROOM_S:
            raise AssertionError("run A leaves {:.2f} s between its first checkpoint and its last call, "
                                 "too little to place the kill".format(room))
        kill_into_life = first_save - start_a + KILL_AT * room
        after_beats = int(math.ceil(kill_into_life / HEARTBEAT_S))

        # run B: killed once, relaunched by run_with_recovery, resumed
        os.environ[flight.TRACE_DIR_ENV] = os.path.join(dirs["b"], "trace")
        model_b = os.path.join(dirs["b"], "model")
        latch = os.path.join(dirs["b"], "killed.latch")
        chaos.install(chaos.ChaosPlan(seed=0).site("node.kill", probability=1.0, max_count=1, victim=0,
                                                   after_beats=after_beats, once_path=latch))
        t0 = time.perf_counter()
        sc = LocalSparkContext(num_executors=1)
        try:
            relaunches = resnet_spark.main(argv(model_b) + ["--auto_recover", "1"], sc=sc)
        finally:
            sc.stop()
            chaos.uninstall()
        wall_b = time.perf_counter() - t0
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    lives_b = _trainer_lives(flight, os.path.join(dirs["b"], "trace"))
    kills = [r for _, recs in lives_b for r in _spans(recs, "chaos_fault")
             if r.get("attrs", {}).get("site") == "node.kill"]
    kill_ts = kills[0]["ts"] if len(kills) == 1 else None
    second = [recs for start, recs in lives_b if kill_ts is not None and start > kill_ts]
    restores = _spans(second[0], "ckpt_restore") if len(second) == 1 else []
    resumed = restores[0]["attrs"].get("step") if restores else None
    calls_b2 = sorted(_spans(second[0], "train_step"), key=lambda r: r["ts"]) if len(second) == 1 else []
    final = "ckpt_{}".format(RECOVER_STEPS)
    paths = {side: os.path.join(model, final) for side, model in (("a", model_a), ("b", model_b))}
    verified = {side: manifest.verify(path) if os.path.isdir(path) else (False, "absent")
                for side, path in paths.items()}
    trees = {side: checkpoint.restore_checkpoint(path) for side, path in paths.items() if verified[side][0]}
    diff = _tree_mismatches(torch, trees["b"], trees["a"]) if len(trees) == 2 else ["a final checkpoint is missing"]
    saves_b = [r for _, recs in lives_b for r in _spans(recs, "ckpt_save")]
    line = {
        "phase": "recover", "model": "resnet50", "dtype": "bfloat16", "bn_impl": "pallas", "batch": BATCH,
        "image": IMAGE, "steps": RECOVER_STEPS, "steps_per_loop": STEPS, "checkpoint_steps": RECOVER_EVERY,
        "keep_checkpoints": RECOVER_KEEP, "cudnn_deterministic": True, "heartbeat_s": HEARTBEAT_S,
        "kill_after_beats": after_beats, "kill_planned_s_into_life": kill_into_life,
        "room_s": room, "relaunches": relaunches, "kills": len(kills), "lives": len(lives_b),
        "resumed_at_step": resumed,
        "checkpoint_bytes": sum(os.path.getsize(os.path.join(paths["a"], n)) for n in os.listdir(paths["a"]))
        if os.path.isdir(paths["a"]) else None,
        "save_s_median": {"a": statistics.median(r["dur_s"] for r in saves_a),
                          "b": statistics.median(r["dur_s"] for r in saves_b) if saves_b else None},
        "saves": {"a": len(saves_a), "b": len(saves_b)},
        "restore_s": restores[0]["dur_s"] if restores else None,
        "kill_to_first_step_s": (calls_b2[0]["ts"] + calls_b2[0]["dur_s"] - kill_ts) if calls_b2 else None,
        "second_life_first_call_s": calls_b2[0]["dur_s"] if calls_b2 else None,
        "wall_s": {"a": wall_a, "b": wall_b},
        "manifest_verify": {side: v[1] for side, v in verified.items()},
        "tensors": _count_tensors(torch, trees.get("a", {})), "final_mismatches": diff[:10],
        "launches_run_a": launches,
    }
    emit(line)
    if relaunches != 1 or len(kills) != 1 or len(second) != 1:
        raise AssertionError("recover: {} relaunch(es), {} kill(s), {} life after the kill (want 1 each)".format(
            relaunches, len(kills), len(second)))
    if resumed is None or resumed < RECOVER_EVERY:
        raise AssertionError("recover: the second life resumed at step {}, not from a checkpoint".format(resumed))
    if not all(v[0] and v[1] == "verified" for v in verified.values()):
        raise AssertionError("recover: final checkpoints fail verify: {}".format(verified))
    if diff:
        raise AssertionError("recover: the resumed run's final checkpoint differs from the uninterrupted "
                             "run's in {} place(s): {}".format(len(diff), diff[:10]))
    want = 53 * wrapper_calls(RECOVER_STEPS, STEPS)
    if any(v != want for v in launches.values()):
        raise AssertionError("recover: run A's BN wrapper launches {} != {}".format(launches, want))
    return launches


#: the MNIST phases: the example's batch, one epoch of MNIST's train split
#: (synthetic rows) in 8 partitions, a checkpoint every MNIST_CKPT steps; the
#: pipeline trains on MNIST_PIPELINE rows and transforms MNIST_TEST of them,
#: TFParallel predicts MNIST_TEST rows of the inference example's own
MNIST_BATCH, MNIST_EXAMPLES, MNIST_PARTITIONS, MNIST_CKPT = 64, 60000, 8, 250
MNIST_PIPELINE, MNIST_TEST = 10000, 2048
#: the device the MNIST phases run on, and report, on the card
MNIST_DEVICE = "cuda:0"
#: the card against the CPU, float32 with TF32 off: logits, loss, each
#: gradient tensor and the parameters after one Adam step, each as
#: ||card - cpu|| / ||cpu|| (all the parameters as one vector, against their
#: starting values: the biases start at 0)
MNIST_REL_TOL = 1e-4


def timed(name, phase, *args):
    """Run ``phase(*args)``, print its seconds as ``<name>_seconds``, return
    its result."""
    t0 = time.perf_counter()
    out = phase(*args)
    emit({"phase": name + "_seconds", "seconds": time.perf_counter() - t0})
    return out


def _mnist_run(torch, mnist, kind, device, batch, fault=None):
    """One Adam step of an MNIST model (weights seed 0) through
    ``SyncDataParallel`` on ``device``: eval logits before it, the loss,
    each parameter's gradient and value after it (host tensors). The MLP
    trains through the example's loss at dropout 0, the CNN (dropout fixed
    at 0.5) through the eval-mode loss: the two devices' generators draw
    different masks. ``fault`` (a parameter name) scales that gradient by
    1.01 before the update."""
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

    cfg = {"dropout_rate": 0.0} if kind == "mlp" else {}
    model = mnist.create_model(kind, generator=torch.Generator().manual_seed(0), **cfg)
    strategy = SyncDataParallel(device)
    opt = optim.adam(1e-3)
    if fault is not None:
        real = opt.update

        def update(params, grads, state):
            grads[fault].mul_(1.01)
            return real(params, grads, state)

        opt.update = update
    state = strategy.create_state(lambda: model, opt)
    placed = strategy.shard_batch(batch)
    with torch.no_grad():
        logits = state.module(placed["image"]).cpu()
    if kind == "mlp":
        loss_fn = mnist.make_loss_fn(model)
    else:
        def loss_fn(module, b):
            return F.cross_entropy(module(b["image"], train=False), b["label"].long()), {}
    step = strategy.compile_train_step(loss_fn, opt, has_aux=True)
    state, metrics = step(state, placed)
    return {"logits": logits, "loss": float(metrics["loss"]),
            "grads": {n: p.grad.detach().cpu() for n, p in state.module.named_parameters()},
            "params": {n: p.detach().cpu() for n, p in state.module.named_parameters()}}


def phase_mnist_compare(torch):
    """``MnistMLP`` and ``MnistCNN`` at full width: logits and one Adam step
    on the card against the same on the CPU, from the same weights and 64
    rows of the examples' data, float32 with TF32 off, each within
    ``MNIST_REL_TOL``; then a 1% fault in one gradient on the card, which
    the gradient limit must catch (Adam's first step hardly moves with it:
    g/(|g| + eps) is about sign(g))."""
    from tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup import synthetic_mnist
    from tensorflowonspark_tpu_torch.models import mnist

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, labels = synthetic_mnist(MNIST_BATCH)
    batch = {"image": images, "label": labels}
    start = {kind: dict(mnist.create_model(kind, generator=torch.Generator().manual_seed(0)).named_parameters())
             for kind in ("mlp", "cnn")}
    for kind in ("mlp", "cnn"):
        card = _mnist_run(torch, mnist, kind, MNIST_DEVICE, batch)
        cpu = _mnist_run(torch, mnist, kind, "cpu", batch)
        grad_rel = {n: _rel(card["grads"][n], g) for n, g in cpu["grads"].items()}
        flat = lambda tree: torch.cat([tree[n].detach().flatten() for n in sorted(tree)])  # noqa: E731
        param_rel = float((flat(card["params"]) - flat(cpu["params"])).norm() / flat(start[kind]).norm())
        fault = max(cpu["grads"], key=lambda n: cpu["grads"][n].norm())
        faulted = _mnist_run(torch, mnist, kind, MNIST_DEVICE, batch, fault=fault)
        control = _rel(faulted["grads"][fault], cpu["grads"][fault])
        line = {"phase": "mnist_compare", "model": kind, "dtype": "float32", "tf32": False,
                "batch": MNIST_BATCH, "params": sum(p.numel() for p in cpu["params"].values()),
                "logits_rel": _rel(card["logits"], cpu["logits"]),
                "loss_card": card["loss"], "loss_cpu": cpu["loss"],
                "loss_rel": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
                "grad_rel_max": max(grad_rel.values()), "param_rel_to_start": param_rel,
                "tolerance": MNIST_REL_TOL, "fault": "{} gradient x 1.01".format(fault),
                "fault_grad_rel": control,
                "fault_param_rel_to_start": float((flat(faulted["params"]) - flat(cpu["params"])).norm()
                                                  / flat(start[kind]).norm()),
                "seconds": time.perf_counter() - t0}
        emit(line)
        worst = max(line["logits_rel"], line["loss_rel"], line["grad_rel_max"], line["param_rel_to_start"])
        if not (math.isfinite(card["loss"]) and worst <= MNIST_REL_TOL):
            raise AssertionError("mnist_compare {}: card vs CPU {} beyond {}: {}".format(
                kind, worst, MNIST_REL_TOL, line))
        if not control > MNIST_REL_TOL:
            raise AssertionError("mnist_compare {}: a 1% fault in {} reads {}, within the limit {}".format(
                kind, fault, control, MNIST_REL_TOL))


def phase_slice_mnist(torch, work):
    """The port's InputMode.SPARK path: ``mnist_spark.main`` through
    ``TFCluster.run`` on one executor and the card, one epoch of
    ``MNIST_EXAMPLES`` synthetic rows in ``MNIST_PARTITIONS`` partitions,
    batch ``MNIST_BATCH``, with ``--model_dir`` and ``--export_dir``. The
    trainer stops at the example's 90% cap (``steps_per_worker``) and ends
    the feed; the rows it took off the feed are the rows it trained on.
    Returns the bundle's directory and each kernel wrapper's launches in
    the trainer (the MNIST models call none)."""
    import shutil

    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.examples.mnist import mnist_spark
    from tensorflowonspark_tpu_torch.train import steps_per_worker

    model_dir, export_dir = os.path.join(work, "model"), os.path.join(work, "bundle")
    for d in (model_dir, export_dir):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    sc = LocalSparkContext(num_executors=1)
    try:
        out = mnist_spark.main([
            "--cluster_size", "1", "--epochs", "1", "--num_examples", str(MNIST_EXAMPLES),
            "--batch_size", str(MNIST_BATCH), "--num_partitions", str(MNIST_PARTITIONS),
            "--checkpoint_steps", str(MNIST_CKPT), "--log_steps", "200",
            "--model_dir", model_dir, "--export_dir", export_dir], sc=sc)
    finally:
        sc.stop()
    wall = time.perf_counter() - t0
    metrics = out["metrics"]
    (span,) = [e for e in metrics["events"] if e.get("span") == "mnist_train"]
    counters = {k: v["value"] for k, v in metrics["counters"].items()}
    launches = {fn: int(counters.get(fn + "_launches_total", -1))
                for fn in [t[0] for t in KERNEL_TABLE] + [t[0] for t in FLASH_TABLE]}
    cap = steps_per_worker(MNIST_EXAMPLES, MNIST_BATCH, 1)
    line = {"phase": "slice_mnist", "model": "mnist_mlp", "hidden": 512, "dtype": "float32",
            "input_mode": "SPARK", "batch": MNIST_BATCH, "examples": MNIST_EXAMPLES, "epochs": 1,
            "partitions": MNIST_PARTITIONS, "executors": 1, "device": span["device"],
            "rows_fed": int(counters.get("feed_rows_total", 0)),
            "feed_chunks": int(counters.get("feed_chunks_total", 0)),
            "rows_taken_off_the_feed": int(counters.get("train_rows_total", 0)),
            "rows_trained": span["steps"] * MNIST_BATCH, "steps": span["steps"], "step_cap": cap,
            "epoch_s": out["train_s"], "epoch_images_per_sec": span["rows"] / out["train_s"],
            "trainer_s": span["train_s"], "trainer_images_per_sec": span["images_per_sec"],
            "trainer_host_s": {k: span[k] for k in ("feed_s", "batch_s", "step_s")},
            "first_loss": span["first_loss"], "last_loss": span["last_loss"],
            "checkpoints": sorted(os.listdir(model_dir)) if os.path.isdir(model_dir) else [],
            "bundle": sorted(os.listdir(export_dir)) if os.path.isdir(export_dir) else [],
            "launches": launches, "wall_s": wall}
    emit(line)
    want_ckpts = ["ckpt_{}".format(s) for s in range(MNIST_CKPT, cap + 1, MNIST_CKPT)]
    if not (line["device"] == MNIST_DEVICE and span["steps"] == cap
            and line["rows_taken_off_the_feed"] == line["rows_trained"] == span["rows"]
            and line["rows_fed"] >= line["rows_trained"]):
        raise AssertionError("slice_mnist: steps {} (cap {}), rows fed {}, taken {}, trained {} on {}".format(
            span["steps"], cap, line["rows_fed"], line["rows_taken_off_the_feed"], line["rows_trained"],
            line["device"]))
    if not (math.isfinite(span["first_loss"]) and math.isfinite(span["last_loss"])
            and span["last_loss"] < span["first_loss"]):
        raise AssertionError("slice_mnist: loss {} -> {} is not finite and falling".format(
            span["first_loss"], span["last_loss"]))
    if line["checkpoints"] != sorted(want_ckpts) or line["bundle"] != ["predict_builder.pkl", "weights.npz"]:
        raise AssertionError("slice_mnist: checkpoints {} (want {}), bundle {}".format(
            line["checkpoints"], want_ckpts, line["bundle"]))
    if any(launches.values()):
        raise AssertionError("slice_mnist: kernel launches {} on the MNIST path".format(launches))
    return export_dir, launches


def _direct_predict(predict_fn, params, model_state, images, batch_size):
    """The bundle's ``predict_fn`` in this process, in the batches of the
    caller it is held against (a short last batch padded with its last row,
    as ``TFModel.transform`` pads it)."""
    import numpy as np

    preds, devices = [], set()
    for lo in range(0, len(images), batch_size):
        chunk = images[lo:lo + batch_size].reshape(-1, 28 * 28)
        n = len(chunk)
        if n < batch_size:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch_size - n, axis=0)])
        out = predict_fn(params, model_state, {"image": chunk})
        preds.extend(np.asarray(out["prediction"])[:n].tolist())
        devices.update(np.asarray(out["device"]).tolist())
    return preds, devices


def phase_pipeline_mnist(torch, work):
    """``mnist_pipeline.main`` on the card: ``TFEstimator.fit`` (one
    executor, InputMode.SPARK) exports a bundle, then ``TFModel.transform``
    predicts ``MNIST_TEST`` rows inside the executor, whose rows report the
    device they ran on. The predictions must equal, row for row, the
    bundle's ``predict_fn`` run in this process on the card."""
    import shutil

    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.examples.mnist import mnist_pipeline
    from tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup import synthetic_mnist
    from tensorflowonspark_tpu_torch.train import export

    export_dir = os.path.join(work, "pipeline_bundle")
    shutil.rmtree(export_dir, ignore_errors=True)
    t0 = time.perf_counter()
    sc = LocalSparkContext(num_executors=1)
    try:
        preds, labels, devices = mnist_pipeline.main([
            "--cluster_size", "1", "--epochs", "1", "--num_examples", str(MNIST_PIPELINE),
            "--batch_size", str(MNIST_BATCH), "--num_test", str(MNIST_TEST), "--export_dir", export_dir], sc=sc)
    finally:
        sc.stop()
    wall = time.perf_counter() - t0
    predict_fn, params, model_state = export.load_model(export_dir)  # on the card
    images, _ = synthetic_mnist(MNIST_PIPELINE)
    t1 = time.perf_counter()
    direct, direct_devices = _direct_predict(predict_fn, params, model_state, images[:MNIST_TEST], MNIST_BATCH)
    mismatches = sum(a != b for a, b in zip(preds, direct))
    line = {"phase": "pipeline_mnist", "train_rows": MNIST_PIPELINE, "batch": MNIST_BATCH,
            "transform_rows": len(preds), "executor_devices": sorted(set(devices)),
            "direct_devices": sorted(direct_devices), "mismatches": mismatches,
            "accuracy": sum(int(p == y) for p, y in zip(preds, labels)) / max(len(preds), 1),
            "direct_predict_s": time.perf_counter() - t1, "wall_s": wall}
    emit(line)
    if len(preds) != MNIST_TEST or mismatches or set(devices) != {MNIST_DEVICE} or direct_devices != {MNIST_DEVICE}:
        raise AssertionError("pipeline_mnist: {} rows, {} differ from the direct predict, executor devices {}, "
                             "direct {}".format(len(preds), mismatches, set(devices), direct_devices))


def phase_parallel_mnist(torch, bundle):
    """``mnist_inference.main`` through TFParallel, one instance on the
    card, over ``slice_mnist``'s bundle: its part file must give, row for
    row, the predictions of the bundle's ``predict_fn`` run in this
    process on the card, and so the same correct count."""
    import shutil

    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.examples.mnist import mnist_inference
    from tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup import synthetic_mnist
    from tensorflowonspark_tpu_torch.train import export

    output = os.path.join(os.path.dirname(bundle), "parallel_out")
    shutil.rmtree(output, ignore_errors=True)
    batch_size = 256  # the example's default
    t0 = time.perf_counter()
    sc = LocalSparkContext(num_executors=1)
    try:
        done = mnist_inference.main(["--cluster_size", "1", "--num_examples", str(MNIST_TEST),
                                     "--batch_size", str(batch_size), "--export_dir", bundle,
                                     "--output", output], sc=sc)
    finally:
        sc.stop()
    wall = time.perf_counter() - t0
    pairs = mnist_inference.read_parts(output)
    predict_fn, params, model_state = export.load_model(bundle)  # on the card
    images, labels = synthetic_mnist(MNIST_TEST, seed=99)
    direct, direct_devices = _direct_predict(predict_fn, params, model_state, images, batch_size)
    line = {"phase": "parallel_mnist", "instances": len(done), "rows": len(pairs),
            "correct": sum(int(y == p) for y, p in pairs),
            "correct_direct": sum(int(y == p) for y, p in zip(labels.tolist(), direct)),
            "mismatches": sum(a != b for a, b in zip(pairs, zip(labels.tolist(), direct))),
            "direct_devices": sorted(direct_devices), "wall_s": wall}
    emit(line)
    if done != [0] or len(pairs) != MNIST_TEST or line["mismatches"] or line["correct"] != line["correct_direct"]:
        raise AssertionError("parallel_mnist: {}".format(line))


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

    from tensorflowonspark_tpu_torch.examples.resnet import bench_bn
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
    # nvcc builds each CUDA source in a thread of its own while triton
    # compiles the two elementwise BN kernels
    cuda_builds = {"fused_bn": fused_bn.build, "flash_attention": fa.build}
    built = {}

    def build_cuda(name):
        t = time.perf_counter()
        try:
            built[name] = {"library": cuda_builds[name]()}
        except Exception as e:  # re-raised below, in the main thread
            built[name] = {"error": e}
        built[name]["seconds"] = time.perf_counter() - t

    nvcc_threads = [threading.Thread(target=build_cuda, args=(name,)) for name in cuda_builds]
    for t in nvcc_threads:
        t.start()
    for c in (64, 256):
        x = torch.randn(3136, c, device="cuda").to(torch.bfloat16)
        v = torch.ones(c, device="cuda")
        mean, var = fused_bn.bn_stats_plain(x)
        dg, db = fused_bn.bn_bwd_reduce_plain(x, x, mean, var, 1e-5)
        fused_bn.bn_normalize(x, mean, var, v, v, 1e-5)
        fused_bn.bn_bwd_dx(x, x, mean, var, v, dg, db, 1e-5)
    torch.cuda.synchronize()
    for t in nvcc_threads:
        t.join()
    for name in cuda_builds:
        if "error" in built[name]:
            raise built[name]["error"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):  # load and launch each kernel once
        x = torch.randn(8, 130, 64, device="cuda", generator=gen).to(dtype)
        _, lse = fa.flash_fwd(x, x, x, None, 0.125, True, 1)
        fa.flash_bwd_dq(x, x, x, None, x, lse, lse, 0.125, True, 1)
        fa.flash_bwd_dkv(x, x, x, None, x, lse, lse, 0.125, True, 1)
        x = x.view(-1, 64)
        mean, var = fused_bn.bn_stats(x)
        fused_bn.bn_bwd_reduce(x, x, mean, var, 1e-5)
    torch.cuda.synchronize()
    emit({"phase": "build", "kernels": [t[0] for t in KERNEL_TABLE] + [t[0] for t in FLASH_TABLE],
          "seconds": time.perf_counter() - t0, "cache": os.environ.get("TRITON_CACHE_DIR"),
          "cuda_seconds": {name: b["seconds"] for name, b in built.items()},
          "cuda_libraries": {name: b["library"] for name, b in built.items()},
          "cuda_kernels": fused_bn.kernel_resources() + fa.kernel_resources()})

    shapes = bench_bn.bn_shapes(torch, BATCH, IMAGE)
    if len(shapes) != 53:
        raise AssertionError("expected 53 BatchNorm layers, found {}".format(len(shapes)))
    totals = phase_kernel(torch, F, fused_bn, shapes)
    phase_kernel_split(torch, fused_bn, shapes)
    data_dir, lm_batch = lm_corpus(here)
    seg_slice = torch.as_tensor(lm_batch["segment_ids"][:, :-1]).cuda().contiguous()
    flash_totals = phase_flash_kernel(torch, F, fa, seg_slice)
    phase_flash_causal(torch, F, fa)
    del seg_slice
    torch.cuda.empty_cache()  # hand the trainer child the card's memory
    launches, _ = phase_slice(torch, fused_bn)
    loop_launches, traced_launches = phase_slice(torch, fused_bn, LOOP_STEPS, STEPS)
    phase_compare(torch, fused_bn, resnet)
    torch.cuda.empty_cache()
    flash_launches, _ = phase_slice_lm(torch, fa, data_dir, STEPS)
    loop_flash_launches, traced_flash_launches = phase_slice_lm(torch, fa, data_dir, LOOP_STEPS, STEPS)
    phase_compare_lm(torch, fa, transformer, lm_batch)
    torch.cuda.empty_cache()
    phase_compare_loop(torch, resnet, transformer, lm_batch)
    work = os.path.join(here, "build", "chip_smoke_ckpt")
    phase_ckpt_engine(torch, resnet, work)
    recover_launches = phase_recover(torch, fused_bn, work)
    mnist_work = os.path.join(here, "build", "chip_smoke_mnist")
    timed("mnist_compare", phase_mnist_compare, torch)
    bundle, mnist_launches = timed("slice_mnist", phase_slice_mnist, torch, mnist_work)
    timed("pipeline_mnist", phase_pipeline_mnist, torch, mnist_work)
    timed("parallel_mnist", phase_parallel_mnist, torch, bundle)
    emit({"phase": "kernels", "kernels": [
        {"name": name, "route": route, "source": source,
         "launched": (launches[name] > 0 and loop_launches[name] > 0 and traced_launches[name] > 0
                      and recover_launches[name] > 0)}
        for name, _, _, _, route, source in KERNEL_TABLE] + [
        {"name": name, "route": "cuda", "source": FLASH_SOURCE,
         "launched": (flash_launches[name] > 0 and loop_flash_launches[name] > 0
                      and traced_flash_launches[name] > 0)}
        for name, *_ in FLASH_TABLE], "script_s": time.perf_counter() - t_start})
    emit({"kernels": [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": launches[name], "launches_loop_path": loop_launches[name],
         "device_launches_traced_loop_call": traced_launches[name],
         "launches_recover_path": recover_launches[name],
         "launches_mnist_path": mnist_launches[name],
         "max_abs_err": totals[name]["max_abs_err"],
         "ms": totals[name]["ms"], "plain_ms": totals[name]["plain_ms"],
         "bound_ms": totals[name]["bound_ms"], "bound_by": totals[name]["bound_by"],
         "library_ms": totals[name]["library_ms"],
         "per": "ResNet-50 step, batch {}, {} px, bf16: sum over its 53 BatchNorm "
                "layers".format(BATCH, IMAGE)}
        for name, replaces, _, _, route, source in KERNEL_TABLE] + [
        {"name": name, "route": "cuda", "source": FLASH_SOURCE, "replaces": replaces,
         "launches": flash_launches[name], "launches_loop_path": loop_flash_launches[name],
         "device_launches_traced_loop_call": traced_flash_launches[name],
         "launches_mnist_path": mnist_launches[name],
         "max_abs_err": flash_totals[name]["max_abs_err"],
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
