"""MNIST train-and-evaluate with a dedicated evaluator node — the port of
``examples/mnist/mnist_estimator.py``.

The reference's estimator example is its only workload with
``eval_node=True``: workers train and checkpoint; the evaluator node
evaluates every new checkpoint and appends a record to
``eval_results.jsonl`` beside the model, until the driver shuts the cluster
down (TF's train_and_evaluate loop, as explicit roles). Here the workers
train the port's ``MnistMLP`` with Adam from ``DataFeed`` (InputMode.SPARK)
and checkpoint through ``train/checkpoint.py``; the evaluator restores each
new checkpoint onto the device of its own ``ctx`` (the card by default: it
shares it with the trainers) and scores ``--eval_examples`` rows of the
examples' data. An evaluator that fails surfaces its error at
``cluster.shutdown()``.

Usage::

    python -m tensorflowonspark_tpu_torch.examples.mnist.mnist_estimator \\
        --cluster_size 2 --epochs 1 --model_dir /tmp/mnist_est
"""

import argparse
import json
import os

#: the evaluator's records, one JSON object a line, in ``--model_dir``
RESULTS = "eval_results.jsonl"
#: the evaluator's and the driver's poll interval, seconds
POLL_S = 0.5


def main_fun(args, ctx):
    if ctx.job_name == "evaluator":
        _evaluate_forever(args, ctx)
    else:
        _train(args, ctx)


def _train(args, ctx):
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import util
    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, checkpoint, optim, steps_per_worker

    strategy = SyncDataParallel(ctx.device)
    model = mnist.create_model("mlp")
    optimizer = optim.adam(args.learning_rate)
    state = strategy.create_state(mnist.make_init_fn(model), optimizer, torch.Generator().manual_seed(0))
    step = strategy.compile_train_step(mnist.make_loss_fn(model, dropout_seed=ctx.process_id), optimizer,
                                       has_aux=True)

    # LOCKSTEP INVARIANT (multi-process worlds): every training process must
    # run the same number of collective steps, or the world deadlocks at
    # the first divergence; steps_per_worker's 0.9 factor lets every
    # worker's feed fill max_steps batches despite uneven partitions
    max_steps = steps_per_worker(args.num_examples * args.epochs, args.batch_size, ctx.num_workers)
    feed = ctx.get_data_feed(train_mode=True)
    steps = 0
    # every rank of a world holds the same state: one saver
    is_saver = ctx.process_id == 0 if util.world_size() > 1 else (
        ctx.job_name in ("chief", "master") or ctx.num_workers <= 1)
    while not feed.should_stop() and steps < max_steps:
        batch = feed.next_batch(args.batch_size)
        if not batch:
            break
        images = np.asarray([b[0] for b in batch], np.float32).reshape(-1, 28, 28)
        labels = np.asarray([b[1] for b in batch])
        state, metrics = step(state, strategy.shard_batch({"image": images, "label": labels}))
        steps += 1
        if steps % args.checkpoint_steps == 0 and is_saver:
            checkpoint.save_checkpoint(os.path.join(args.model_dir, "ckpt_{}".format(steps)), state)
            print("saved ckpt_{} (loss {:.4f})".format(steps, float(metrics["loss"])))
    if is_saver and steps % args.checkpoint_steps != 0:
        # the final state: the checkpoint the evaluator's last record must
        # come from (train_and_evaluate parity)
        checkpoint.save_checkpoint(os.path.join(args.model_dir, "ckpt_{}".format(steps)), state)
        print("saved final ckpt_{}".format(steps))
    if not feed.should_stop():
        feed.terminate()


def evaluate(path, device, eval_examples):
    """Accuracy of the checkpoint at ``path`` on ``eval_examples`` rows of
    the examples' data (``synthetic_mnist``, seed 99), the MLP on
    ``device``."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup import synthetic_mnist
    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.train import checkpoint

    images, labels = synthetic_mnist(eval_examples, seed=99)
    module = mnist.create_model("mlp").to(device).eval()
    module.load_state_dict(checkpoint.restore_checkpoint(path)["params"])
    with torch.no_grad():
        pred = module(torch.as_tensor(np.asarray(images, np.float32)).to(device)).argmax(-1).cpu().numpy()
    return float(np.mean(pred == labels))


def _evaluate_forever(args, ctx):
    """The evaluator role: evaluate every new checkpoint until shutdown
    (the reference estimator's continuous-eval loop)."""
    from tensorflowonspark_tpu_torch import resilience
    from tensorflowonspark_tpu_torch.train import checkpoint

    seen = set()
    # no deadline: the driver's shutdown ends the role
    for _ in resilience.Backoff(base=POLL_S, factor=1.0, max_delay=POLL_S, jitter=0.0).attempts():
        latest = checkpoint.latest_checkpoint(args.model_dir)
        if latest and latest not in seen:
            seen.add(latest)
            acc = evaluate(latest, ctx.device, args.eval_examples)
            record = {"checkpoint": os.path.basename(latest), "accuracy": acc, "device": str(ctx.device)}
            with open(os.path.join(args.model_dir, RESULTS), "a") as f:
                f.write(json.dumps(record) + "\n")
            print("evaluated {}: accuracy {:.3f}".format(record["checkpoint"], acc))


def read_results(model_dir):
    """The evaluator's records so far, oldest first."""
    path = os.path.join(model_dir, RESULTS)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--checkpoint_steps", type=int, default=10)
    parser.add_argument("--cluster_size", type=int, default=None,
                        help="explicit cluster size (default: from the Spark conf/parallelism under "
                             "Spark; 3 on the local backend)")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--eval_examples", type=int, default=256)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--num_examples", type=int, default=2048)
    parser.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                        help="device of each node: one CUDA device per process, or the CPU")
    return parser


def main(argv=None, sc=None):
    """Run the example; returns the evaluator's records."""
    args = build_parser().parse_args(argv)

    from tensorflowonspark_tpu_torch import TFCluster, resilience, util
    from tensorflowonspark_tpu_torch.backends import get_spark_context
    from tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup import synthetic_mnist, to_rows
    from tensorflowonspark_tpu_torch.train import checkpoint

    data = to_rows(*synthetic_mnist(args.num_examples))

    # spark-submit / pyspark when present, local backend otherwise;
    # a caller-supplied sc is passed through with owned=False
    sc, args.cluster_size, owned = get_spark_context("mnist_estimator", args.cluster_size, sc=sc,
                                                     local_default=3)
    try:
        cluster = TFCluster.run(
            sc, main_fun, args, args.cluster_size,
            input_mode=TFCluster.InputMode.SPARK, master_node="chief",
            eval_node=True, env={util.ENV_PLATFORM: args.platform},
        )
        try:
            cluster.train(sc.parallelize(data, 4), num_epochs=args.epochs)
            # wait until the NEWEST checkpoint has an eval record (not merely
            # the first one) before tearing the evaluator down
            tick = resilience.Backoff(base=POLL_S, factor=1.0, max_delay=POLL_S, jitter=0.0)
            for _ in tick.attempts(deadline=resilience.Deadline(60)):
                latest = checkpoint.latest_checkpoint(args.model_dir)
                if latest and os.path.basename(latest) in {r["checkpoint"] for r in read_results(args.model_dir)}:
                    break
        finally:
            # also after a failed feed: stop the nodes and the reservation
            # server (shutdown raises a node's error, the evaluator's too)
            cluster.shutdown(grace_secs=5)
        records = read_results(args.model_dir)
        if records:
            print("eval records:\n" + "\n".join(json.dumps(r) for r in records))
        print("estimator training complete")
    finally:
        if owned:
            sc.stop()
    return records


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import util

    util.setup_logging()
    main()
