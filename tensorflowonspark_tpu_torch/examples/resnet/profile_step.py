"""Where the time of one ResNet-50 train step goes on the card.

Builds the model, loss, optimizer and train step as ``resnet_spark.main_fun``
does (ImageNet ResNet-50, bf16, a synthetic seeded batch, SGD momentum 0.9
with the example's warmup schedule, L2 in the loss, the step from
``SyncDataParallel.compile_train_step``) in this process on ``cuda:0``, warms
up, then:

* times ``--steps`` steps with a device sync after each (host clock) →
  step time and images/s;
* traces ``--traced`` more steps, ending in a sync, with ``torch.profiler``
  and reads from that one trace: the window's length, the device time of
  the kernels by group (the port's Triton BN kernels, cuDNN convs, GEMMs,
  other PyTorch kernels), the device's busy time (the union of the kernel
  intervals) and so its idle share of the window, and the step's phases
  (the ``train_step.forward`` / ``.backward`` / ``.optimizer`` ranges of the
  step): host ms of each range, and device ms of the kernels launched under
  the forward and optimizer ranges (backward: every other kernel, since the
  autograd engine launches them from its own thread).

Prints one JSON line per ``--bn_impl`` given::

    python -m tensorflowonspark_tpu_torch.examples.resnet.profile_step \\
        --bn_impl pallas flax --batch_size 64
"""

import argparse
import json
import statistics
import subprocess
import time

#: kernel-name fragments of each group, matched in this order
GROUPS = [
    ("fused_bn_triton", ("stats_partial", "finish", "normalize", "bwd_reduce_partial", "bwd_dx")),
    ("conv_cudnn", ("conv", "xmma", "cudnn", "implicit_gemm", "dgrad", "wgrad", "fprop", "nhwc",
                    "nchw")),
    ("gemm", ("gemm", "cublas", "cutlass")),
]
PHASES = ("train_step.forward", "train_step.backward", "train_step.optimizer")


def _group(name, groups=GROUPS):
    low = name.lower()
    for group, frags in groups:
        if any(f in low for f in frags):
            return group
    return "other_pytorch"


def _union_us(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for lo, hi in sorted(intervals):
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


def read_trace(events, traced, groups=GROUPS):
    """Per-step readings from the profiler events of ``traced`` steps run
    inside one ``profile_window`` range; kernels are summed by ``groups``
    (``(name, kernel-name fragments)``, matched in order)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events
               if e.device_type == cuda and not getattr(e, "is_user_annotation", False)]
    ranges = [e for e in events if e.device_type != cuda]
    window = next(e for e in ranges if e.name == "profile_window")
    by_group, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        group = _group(e.name, groups)
        by_group[group] = by_group.get(group, 0.0) + us / 1e3 / traced
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / traced
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in kernels])
    window_us = window.time_range.elapsed_us()
    host_ms, device_ms = {}, {}
    for phase in PHASES:
        spans = [e for e in ranges if e.name == phase]
        if len(spans) != traced:
            raise RuntimeError("found {} {} ranges in {} traced steps".format(
                len(spans), phase, traced))
        host_ms[phase] = sum(e.time_range.elapsed_us() for e in spans) / 1e3 / traced
        device_ms[phase] = sum(e.device_time_total for e in spans) / 1e3 / traced
    kernel_ms = sum(by_group.values())
    device_ms["train_step.backward"] = (
        kernel_ms - device_ms["train_step.forward"] - device_ms["train_step.optimizer"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "traced_steps": traced, "window_ms_per_step": window_us / 1e3 / traced,
        "device_kernels_per_step": len(kernels) / traced,
        "device_kernel_ms_per_step": kernel_ms,
        "device_busy_ms_per_step": busy_us / 1e3 / traced,
        "device_idle_share": 1.0 - busy_us / window_us,
        "phase_host_ms": host_ms, "phase_device_ms": device_ms,
        "device_ms_by_group": by_group,
        "top_kernels_ms_per_step": [[name[:80], ms] for name, ms in top],
    }


def profile(bn_impl, batch_size, steps, traced):
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.examples.resnet import resnet_spark
    from tensorflowonspark_tpu_torch.models import resnet
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

    torch.cuda.reset_peak_memory_stats()
    args = resnet_spark.build_parser().parse_args(
        ["--dataset", "imagenet", "--batch_size", str(batch_size), "--bn_impl", bn_impl])
    strategy = SyncDataParallel(torch.device("cuda", 0))
    optimizer = optim.sgd(resnet_spark.lr_schedule(args), momentum=0.9)
    state = strategy.create_state(
        lambda: resnet.resnet50(dtype=torch.bfloat16, bn_impl=bn_impl,
                                generator=torch.Generator().manual_seed(0)), optimizer)
    step = strategy.compile_train_step(resnet.make_loss_fn(weight_decay=1e-4), optimizer,
                                       mutable=True)
    rng = np.random.default_rng(0)
    batch = strategy.shard_batch({
        "image": rng.standard_normal((batch_size, 224, 224, 3)).astype(np.float32),
        "label": rng.integers(0, 1000, batch_size),
    })

    for _ in range(3):  # warm-up: Triton builds, cuDNN heuristics, allocator
        state, _ = step(state, batch)
    torch.cuda.synchronize()

    wall = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("profile_window"):
            for _ in range(traced):
                state, metrics = step(state, batch)
            torch.cuda.synchronize()
    out = {
        "bn_impl": bn_impl, "batch": batch_size, "dtype": "bfloat16", "steps_timed": steps,
        "step_ms_median": statistics.median(wall) * 1e3,
        "images_per_sec": batch_size / statistics.median(wall),
        "loss": float(metrics["loss"]),
    }
    out.update(read_trace(prof.events(), traced))
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def main(argv=None):
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--bn_impl", nargs="+", choices=["flax", "pallas"], default=["pallas"])
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--traced", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    for bn_impl in args.bn_impl:
        out = profile(bn_impl, args.batch_size, args.steps, args.traced)
        out["card"] = card
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
