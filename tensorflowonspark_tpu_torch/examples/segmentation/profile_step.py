"""Where the time of one U-Net train step goes on the card.

Builds the model, loss, Adam 1e-3 and train step as
``segmentation_spark.main_fun`` does (the U-Net at ``--base_filters`` /
``--depth``, float32 with PyTorch's default TF32 convs, the step from
``SyncDataParallel.compile_train_step``) in this process on ``cuda:0``, on
one batch of the example's ``synthetic_shapes``, warms up, then:

* times ``--steps`` steps with a device sync after each (host clock) →
  step time and images/s;
* traces ``--traced`` more steps with ``torch.profiler`` and reads from
  that one trace (the ResNet profiler's ``read_trace``) the kernels' device
  time by group (cuDNN convs, GroupNorm, gelu, max pooling, the
  concatenations, the loss, the optimizer, other PyTorch kernels), the
  device's busy time and idle share of the window, kernels a step, and the
  ``train_step.forward`` / ``.backward`` / ``.optimizer`` ranges.

Prints one JSON line::

    python -m tensorflowonspark_tpu_torch.examples.segmentation.profile_step \\
        --base_filters 32 --depth 4 --image_size 128 --batch_size 64
"""

import argparse
import json
import statistics
import subprocess
import time

from tensorflowonspark_tpu_torch.examples.resnet.profile_step import read_trace

#: kernel-name fragments of each group, matched in this order (PyTorch's
#: GroupNorm kernels first: some of their names hold "nchw")
GROUPS = [
    ("group_norm", ("groupnorm", "group_norm", "rowwisemoments", "fusedparams", "internalgradients",
                    "gammabeta")),
    ("gelu", ("gelu",)),
    ("max_pool", ("max_pool", "maxpool")),
    ("concat", ("catarray",)),
    ("loss", ("softmax", "nll_loss")),
    ("optimizer", ("foreach", "multi_tensor")),
    ("conv_cudnn", ("conv", "xmma", "cudnn", "implicit_gemm", "dgrad", "wgrad", "fprop", "nhwc", "nchw",
                    "sm90_", "cutlass")),
    ("gemm", ("gemm", "cublas")),
]


def profile(base_filters, depth, image_size, batch_size, steps, traced):
    import torch

    from tensorflowonspark_tpu_torch.examples.segmentation.segmentation_spark import synthetic_shapes
    from tensorflowonspark_tpu_torch.models import segmentation
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

    cfg = dict(num_classes=3, base_filters=base_filters, depth=depth)
    strategy = SyncDataParallel(torch.device("cuda", 0))
    optimizer = optim.adam(1e-3)
    model = segmentation.create_model(**cfg)
    state = strategy.create_state(segmentation.make_init_fn(model, image_size=image_size), optimizer,
                                  torch.Generator().manual_seed(0))
    step = strategy.compile_train_step(segmentation.make_loss_fn(model), optimizer, has_aux=True)
    images, masks = synthetic_shapes(batch_size, image_size, seed=0)
    batch = strategy.shard_batch({"image": images, "mask": masks})
    torch.cuda.reset_peak_memory_stats()

    for _ in range(3):  # warm-up: cuDNN heuristics, the allocator
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
    out = {"model": "unet", **cfg, "image": image_size, "batch": batch_size, "dtype": "float32",
           "tf32_convs": torch.backends.cudnn.allow_tf32, "steps_timed": steps,
           "step_ms_median": statistics.median(wall) * 1e3,
           "images_per_sec": batch_size / statistics.median(wall), "loss": float(metrics["loss"])}
    out.update(read_trace(prof.events(), traced, GROUPS))
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def main(argv=None):
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--base_filters", type=int, default=32)
    parser.add_argument("--depth", type=int, default=4)
    parser.add_argument("--image_size", type=int, default=128)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--traced", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    out = profile(args.base_filters, args.depth, args.image_size, args.batch_size, args.steps, args.traced)
    out["card"] = card
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
