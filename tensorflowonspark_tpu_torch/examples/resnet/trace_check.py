"""Does a traced loop call hold every kernel the card ran? A check of
``ops/kernel_trace.KernelTrace`` on the card.

Builds ResNet-50 and its captured train loop as ``profile_step.py`` does (bf16,
batch 64, ``bn_impl="pallas"``, K steps a call) in this process on
``cuda:0``, runs two calls (the warm-up steps and the capture), then traces
``--calls`` more calls one by one with ``KernelTrace``, taking its lead and
trail (``GUARD_S``) from ``--guard_s`` in turns, and counts each BN kernel's
device launches in each trace: a whole trace holds 53 x K of each. Prints one
JSON line with, for each guard, the traced calls and those that came up
short (their counts)::

    python -m tensorflowonspark_tpu_torch.examples.resnet.trace_check \\
        --calls 300 --guard_s 0 0.1
"""

import argparse
import json
import subprocess


def main(argv=None):
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.examples.resnet import resnet_spark
    from tensorflowonspark_tpu_torch.models import resnet
    from tensorflowonspark_tpu_torch.ops import fused_bn, kernel_trace
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

    parser = argparse.ArgumentParser()
    parser.add_argument("--calls", type=int, default=100)
    parser.add_argument("--steps_per_loop", type=int, default=5)
    parser.add_argument("--guard_s", type=float, nargs="+", default=[kernel_trace.GUARD_S])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_check: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    k = args.steps_per_loop
    cfg = resnet_spark.build_parser().parse_args(["--dataset", "imagenet", "--batch_size", "64",
                                                  "--bn_impl", "pallas"])
    strategy = SyncDataParallel(torch.device("cuda", 0))
    optimizer = optim.sgd(resnet_spark.lr_schedule(cfg), momentum=0.9)
    state = strategy.create_state(lambda: resnet.resnet50(dtype=torch.bfloat16, bn_impl="pallas",
                                                          generator=torch.Generator().manual_seed(0)), optimizer)
    loop = strategy.compile_train_loop(resnet.make_loss_fn(weight_decay=1e-4), optimizer, k, mutable=True)
    rng = np.random.default_rng(0)
    batch = strategy.shard_batch({"image": rng.standard_normal((64, 224, 224, 3)).astype(np.float32),
                                  "label": rng.integers(0, 1000, 64)})
    for _ in range(2):  # the warm-up steps and the capture
        state, metrics = loop(state, [batch] * k)
    float(metrics["loss"])
    names = [fn.__name__ for fn in fused_bn.KERNELS]
    want = 53 * k
    runs = {g: {"calls": 0, "short": []} for g in args.guard_s}
    for call in range(args.calls):
        guard = args.guard_s[call % len(args.guard_s)]
        kernel_trace.GUARD_S = guard
        with kernel_trace.KernelTrace() as trace:
            state, metrics = loop(state, [batch] * k)
            float(metrics["loss"])
        got = {n: trace.readings["launches"][n] for n in names}
        runs[guard]["calls"] += 1
        if any(v != want for v in got.values()):
            runs[guard]["short"].append({"call": call, **got})
    print(json.dumps({"card": card, "steps_per_loop": k, "want_each": want,
                      "guards": [{"guard_s": g, **r} for g, r in runs.items()]}), flush=True)


if __name__ == "__main__":
    main()
