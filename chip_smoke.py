"""On-card smoke run of the PyTorch/CUDA port (``tensorflowonspark_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``); any failure raises
and the script exits non-zero:

1. ``device``   the card's name and power limit (``nvidia-smi``).
2. ``build``    compiles the four fused-BatchNorm Triton kernels from the
                sources in the checkout (into ``build/triton``).
3. ``kernel``   at every BatchNorm shape of a ResNet-50 step (batch 64,
                224 px, bf16), each kernel against its plain PyTorch version:
                the max error beside its stated tolerance, the kernel's time,
                the plain version's, one PyTorch library call computing the
                same function (a yardstick only; the port never calls it) and
                the least time the card could take (bytes moved / 3.35 TB/s,
                the H100 SXM data sheet). Lines are printed for the stem and a
                stage-3 shape; the ``kernels`` line carries per-step totals.
4. ``slice``    the port's main path: ``TFCluster.run`` on the local backend,
                one executor, the port's ``resnet_spark.main_fun`` on full
                ResNet-50, bf16, ``bn_impl="pallas"``, batch 64, 5 steps. Per-
                step losses (finite), images/s over steps 2-5, and each
                kernel's launch count read back from the trainer's obs
                counters (``cluster.metrics()``), which must be 53 per step.
5. ``compare``  in this process, one train step of the same model, weights
                (seed 0) and batch through the kernels and through their
                plain versions (``bn_impl="flax"``), in float32 and in bf16,
                with TF32 off for convs and matmuls: both losses and their
                difference, and the relative difference of the gradients,
                each against a stated limit; then a control run with a 1%
                dgamma fault that the gradient limit must catch.
6. ``kernels``  every kernel of the port and whether phases 3-4 launched it.

Then one JSON line with every kernel's measurements, the ``nvidia-smi``
line, and last ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside it, the script fails before printing anything.
"""

import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
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


def main():
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

    from tensorflowonspark_tpu_torch.models import resnet
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
    for c in (64, 256):
        x = torch.randn(3136, c, device="cuda").to(torch.bfloat16)
        v = torch.ones(c, device="cuda")
        mean, var = fused_bn.bn_stats(x)
        fused_bn.bn_normalize(x, mean, var, v, v, 1e-5)
        dg, db = fused_bn.bn_bwd_reduce(x, x, mean, var, 1e-5)
        fused_bn.bn_bwd_dx(x, x, mean, var, v, dg, db, 1e-5)
    torch.cuda.synchronize()
    emit({"phase": "build", "kernels": [t[0] for t in KERNEL_TABLE], "seconds":
          time.perf_counter() - t0, "cache": os.environ.get("TRITON_CACHE_DIR")})

    shapes = bn_shapes(torch, fused_bn, resnet)
    if len(shapes) != 53:
        raise AssertionError("expected 53 BatchNorm layers, found {}".format(len(shapes)))
    totals = phase_kernel(torch, F, fused_bn, shapes)
    torch.cuda.empty_cache()  # hand the trainer child the card's memory
    launches = phase_slice(torch, fused_bn)
    phase_compare(torch, fused_bn, resnet)
    emit({"phase": "kernels", "kernels": [
        {"name": name, "route": "triton", "source": SOURCE, "launched": launches[name] > 0}
        for name, *_ in KERNEL_TABLE]})
    emit({"kernels": [
        {"name": name, "route": "triton", "source": SOURCE, "replaces": replaces,
         "launches": launches[name], "max_abs_err": totals[name]["max_abs_err"],
         "ms": totals[name]["ms"], "plain_ms": totals[name]["plain_ms"],
         "bound_ms": totals[name]["bound_ms"], "bound_by": totals[name]["bound_by"],
         "library_ms": totals[name]["library_ms"],
         "per": "ResNet-50 step, batch {}, {} px, bf16: sum over its 53 BatchNorm "
                "layers".format(BATCH, IMAGE)}
        for name, replaces, *_ in KERNEL_TABLE]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
