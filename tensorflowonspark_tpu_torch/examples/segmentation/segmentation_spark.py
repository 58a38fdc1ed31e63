"""Image segmentation (U-Net) on a cluster, with distributed inference — the
port of ``examples/segmentation/segmentation_spark.py`` (BASELINE config 5).

The JAX example's flow: ``TFCluster.run`` (InputMode.TENSORFLOW) trains the
U-Net (128×128×3 → 3 classes) with Adam 1e-3 on synthetic shapes (a bright
square of class 1 and a dimmer one of class 2 on noise, so pixel accuracy
means something); the chief exports a model bundle; then
``TFParallel.run`` starts independent instances that each load the bundle
on their device and segment their own shard of images. ``synthetic_shapes``
is the JAX example's, so a seed gives the same images and masks.

Each trainer runs on ``--platform`` (default ``gpu``: one CUDA device a
process, raising without one) and publishes, through its obs plane, a
``train_step`` span a step (the loss, pixel accuracy and images/s of the
logged steps, every ``--log_steps``), a ``seg_train`` span (steps, final
loss and pixel accuracy, device, peak device memory) and each kernel
wrapper's launches as ``<wrapper>_launches_total`` (the U-Net calls none of
the port's kernels: its convs and GroupNorm are cuDNN's and PyTorch's).
Each inference instance writes ``inference-<id>.txt`` (images, mask
height, pixel accuracy) and ``inference-<id>.npz`` (its masks and the
device each image ran on) into ``--export_dir``.

CUDA cards take several processes, where a TPU chip takes one:
``--instances_per_card`` lets that many inference instances share a card.

Usage (one executor, one card)::

    python -m tensorflowonspark_tpu_torch.examples.segmentation.segmentation_spark \\
        --cluster_size 1 --base_filters 32 --depth 4 --batch_size 64 \\
        --export_dir /tmp/seg_bundle
"""

import argparse
import os
import time


def synthetic_shapes(n, size=128, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    images = rng.normal(0.2, 0.05, (n, size, size, 3)).astype(np.float32)
    masks = np.zeros((n, size, size), np.int64)
    lo, hi = max(size // 8, 2), max(size // 4, 4)
    for i in range(n):
        h, w = rng.integers(lo, hi, 2)
        r, c = rng.integers(0, size - h), rng.integers(0, size - w)
        images[i, r : r + h, c : c + w] += 0.7
        masks[i, r : r + h, c : c + w] = 1
        # second class: a dimmer box
        h2 = w2 = lo
        r2, c2 = rng.integers(0, size - h2), rng.integers(0, size - w2)
        images[i, r2 : r2 + h2, c2 : c2 + w2] += 0.35
        masks[i, r2 : r2 + h2, c2 : c2 + w2] = 2
    return images, masks


def model_config(args):
    """The U-Net's configuration, as the JAX example builds it."""
    return dict(num_classes=3, base_filters=args.base_filters, depth=args.depth)


def main_fun(args, ctx):
    """Runs inside the trainer child of every cluster node."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import obs
    from tensorflowonspark_tpu_torch.models import segmentation
    from tensorflowonspark_tpu_torch.ops import kernel_trace
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, export, optim

    ctx.initialize_distributed()  # no-op for one process
    strategy = SyncDataParallel(ctx.device)
    model = segmentation.create_model(**model_config(args))
    optimizer = optim.adam(1e-3)
    state = strategy.create_state(segmentation.make_init_fn(model, image_size=args.image_size), optimizer,
                                  torch.Generator().manual_seed(0))
    step = strategy.compile_train_step(segmentation.make_loss_fn(model), optimizer, has_aux=True)
    on_card = strategy.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(strategy.device)

    images, masks = synthetic_shapes(args.batch_size * 4, args.image_size, seed=ctx.executor_id)
    launches0 = {fn.__name__: fn.launches for fn in kernel_trace.counted_wrappers()}
    metrics = {}
    t0, last_log = time.perf_counter(), 0
    for i in range(args.train_steps):
        sel = np.arange(i * args.batch_size, (i + 1) * args.batch_size) % len(images)
        with obs.span("train_step", step=i + 1, steps=1) as sp:
            state, metrics = step(state, strategy.shard_batch({"image": images[sel], "mask": masks[sel]}))
            if (i + 1) % args.log_steps == 0:
                loss, acc = float(metrics["loss"]), float(metrics["pixel_accuracy"])  # waits for the device
                ips = args.batch_size * (i + 1 - last_log) / (time.perf_counter() - t0)
                sp.set(loss=loss, pixel_accuracy=acc, images_per_sec=ips)
                print("step {}: loss {:.3f} pixel_acc {:.3f}".format(i + 1, loss, acc))
                last_log, t0 = i + 1, time.perf_counter()
    with obs.span("seg_train", steps=args.train_steps) as sp:
        if metrics:
            acc = float(metrics["pixel_accuracy"])
            sp.set(loss=float(metrics["loss"]), pixel_accuracy=acc)
            print("final pixel accuracy: {:.3f}".format(acc))
        sp.set(device=str(strategy.device), rank=ctx.process_id,
               peak_memory_bytes=torch.cuda.max_memory_allocated(strategy.device) if on_card else None)
        # inside the span: a reader that waits for it finds the counters
        for fn in kernel_trace.counted_wrappers():
            obs.counter("{}_launches_total".format(fn.__name__),
                        help="launches of the {} kernel by the training loop".format(fn.__name__)
                        ).inc(fn.launches - launches0[fn.__name__])

    if args.export_dir and ctx.job_name in ("chief", "master"):
        with obs.span("export"):
            export.export_model(args.export_dir, segmentation.bundle_builder(**model_config(args)),
                                state.params)
        print("exported segmentation bundle to", args.export_dir)


def inference_shard(args, executor_id, num_workers):
    """``(images, masks)`` an inference instance segments: its shard of
    ``--inference_count`` images drawn from its own seed, as in the JAX
    example."""
    import numpy as np

    images, masks = synthetic_shapes(args.inference_count, args.image_size, seed=1000 + executor_id)
    sel = np.arange(executor_id, len(images), max(num_workers, 1))
    return images[sel], masks[sel]


def inference_fun(args, ctx):
    """Independent-instance inference from the exported bundle: each
    TFParallel instance segments its own shard of images on its device (the
    multi-worker inference leg of BASELINE config 5)."""
    import numpy as np

    from tensorflowonspark_tpu_torch.train import export

    predict_fn, params, model_state = export.load_model(args.export_dir, device=ctx.device)
    images, masks = inference_shard(args, ctx.executor_id, ctx.num_workers)
    out = predict_fn(params, model_state, {"image": images})
    pred = np.asarray(out["mask"])
    acc = float(np.mean(pred == masks))
    path = os.path.join(args.export_dir, "inference-{}".format(ctx.executor_id))
    np.savez(path + ".npz", mask=pred, device=np.asarray(out["device"]))
    with open(path + ".txt", "w") as f:
        f.write("{} {} {:.4f}".format(len(images), pred.shape[1], acc))
    print("worker {} segmented {} images (pixel acc {:.3f})".format(ctx.executor_id, len(images), acc))


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--base_filters", type=int, default=16)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--cluster_size", type=int, default=None,
                        help="explicit cluster size (default: from the Spark conf/parallelism under "
                             "Spark; 1 on the local backend)")
    parser.add_argument("--depth", type=int, default=3)
    parser.add_argument("--export_dir", default=None)
    parser.add_argument("--image_size", type=int, default=128)
    parser.add_argument("--inference_count", type=int, default=16)
    parser.add_argument("--inference_instances", type=int, default=None,
                        help="TFParallel instances of the inference leg (default: the cluster size)")
    parser.add_argument("--instances_per_card", type=int, default=1,
                        help="inference instances that may share one card")
    parser.add_argument("--log_steps", type=int, default=10)
    parser.add_argument("--train_steps", type=int, default=20)
    parser.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                        help="device of each trainer and instance: one CUDA device per process, or the CPU")
    return parser


def main(argv=None, sc=None):
    """Run the example. Returns ``{"metrics", "inference"}``: the
    trainers' merged metrics (read once they are done) and the inference
    instances that completed (None without ``--export_dir``)."""
    args = build_parser().parse_args(argv)

    from tensorflowonspark_tpu_torch import TFCluster, TFParallel, util
    from tensorflowonspark_tpu_torch.backends import get_spark_context

    # spark-submit / pyspark when present, local backend otherwise;
    # a caller-supplied sc is passed through with owned=False
    sc, args.cluster_size, owned = get_spark_context("segmentation_spark", args.cluster_size, sc=sc,
                                                     local_default=1,
                                                     min_local_executors=args.inference_instances or 1)
    env = {util.ENV_PLATFORM: args.platform}
    result = {"metrics": None, "inference": None}
    try:
        cluster = TFCluster.run(
            sc, main_fun, args, args.cluster_size,
            input_mode=TFCluster.InputMode.TENSORFLOW, master_node="chief", env=env,
        )
        try:
            cluster.wait_for_completion()
            result["metrics"] = cluster.metrics(include_driver=False)
        finally:
            cluster.shutdown()  # raises a node's error
        print("segmentation training complete")
        if args.export_dir:
            # multi-worker inference: N independent instances over the bundle
            result["inference"] = TFParallel.run(
                sc, inference_fun, args, args.inference_instances or args.cluster_size, env=env,
                instances_per_card=args.instances_per_card)
            print("segmentation inference complete")
    finally:
        if owned:
            sc.stop()
    return result


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import util

    util.setup_logging()
    main()
