"""The port's cluster path on the CPU: TFCluster.run on the port's local
backend with trainer children on ``--platform cpu``, one executor and two
(a gloo torch.distributed world), and the port's import boundary."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tensorflowonspark_tpu_torch import TFCluster, util
from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
from tensorflowonspark_tpu_torch.examples.resnet import resnet_spark
from tensorflowonspark_tpu_torch.examples.transformer import transformer_spark

CPU_ENV = {util.ENV_PLATFORM: "cpu"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--platform", "cpu", "--dataset", "cifar", "--image_size", "8", "--batch_size", "4",
        "--train_steps", "2", "--log_steps", "1", "--bn_impl", "pallas"]


def fn_train_and_save(args, ctx):
    """Two data-parallel SGD steps of a tiny ResNet on each rank's own
    synthetic batch; saves the rank's parameters."""
    import torch

    from tensorflowonspark_tpu_torch.models import resnet
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

    ctx.initialize_distributed()
    strategy = SyncDataParallel(ctx.device)
    optimizer = optim.sgd(0.1, momentum=0.9)
    state = strategy.create_state(
        lambda: resnet.ResNet((1, 1), (8, 16), num_classes=10, bottleneck=False, stem="cifar",
                              bn_impl="pallas", generator=torch.Generator().manual_seed(0)),
        optimizer,
    )
    step = strategy.compile_train_step(resnet.make_loss_fn(weight_decay=1e-4), optimizer, mutable=True)
    rng = np.random.default_rng(ctx.executor_id)
    batch = strategy.shard_batch({
        "image": rng.standard_normal((4, 8, 8, 3)).astype(np.float32),
        "label": rng.integers(0, 10, 4),
    })
    for _ in range(2):
        state, _ = step(state, batch)
    torch.save(
        {"world": ctx.num_processes, "device": str(ctx.device),
         "params": {k: v.detach() for k, v in state.params.items()},
         "running_mean": state.module.stem_bn.running_mean.clone()},
        os.path.join(args["out_dir"], "rank{}.pt".format(ctx.process_id)),
    )


TINY_LM = ["--platform", "cpu", "--vocab_size", "300", "--d_model", "32", "--n_layers", "1",
           "--n_heads", "2", "--d_ff", "64", "--seq_len", "64", "--batch_size", "2",
           "--dtype", "float32", "--train_steps", "3", "--log_steps", "1"]


def fn_lm_train_and_save(args, ctx):
    """Two data-parallel AdamW steps of a tiny transformer, as the LM
    example's main_fun takes them, on each rank's own shards of packed
    text; saves the rank's parameters."""
    import torch

    from tensorflowonspark_tpu_torch import tfrecord
    from tensorflowonspark_tpu_torch.data import TextPipeline, Tokenizer, shard_files
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

    ctx.initialize_distributed()
    strategy = SyncDataParallel(ctx.device)
    model = transformer.create_model(vocab_size=300, d_model=32, n_layers=1, n_heads=2, d_ff=64)
    optimizer = optim.adamw(1e-2)
    state = strategy.create_state(transformer.make_init_fn(model), optimizer,
                                  torch.Generator().manual_seed(ctx.process_id))
    step = strategy.compile_train_step(transformer.make_loss_fn(model), optimizer, has_aux=True)
    files = shard_files(tfrecord.list_shards(args["data_dir"]), ctx.num_workers, ctx.executor_id)
    stream = iter(TextPipeline(files, Tokenizer(kind="byte"), seq_len=33, batch_size=2,
                               seed=ctx.executor_id, epochs=None, pack_workers=0))
    losses = []
    for _ in range(2):
        state, metrics = step(state, strategy.shard_batch(next(stream)))
        losses.append(float(metrics["loss"]))
    stream.close()
    torch.save(
        {"world": ctx.num_processes, "losses": losses,
         "params": {k: v.detach() for k, v in state.params.items()}},
        os.path.join(args["out_dir"], "lm_rank{}.pt".format(ctx.process_id)),
    )


def test_transformer_spark_main_fun_trains_through_one_executor_cluster(tmp_path):
    """The LM example's main_fun through TFCluster.run on packed text: per-
    step losses and tokens/s land in the trainer's obs plane, and on the
    CPU the flash-attention wrappers take their plain versions (0
    launches)."""
    data_dir = str(tmp_path / "corpus")
    transformer_spark.make_text_corpus(data_dir, num_shards=2, records_per_shard=40)
    args = transformer_spark.build_parser().parse_args(TINY_LM + ["--data_dir", data_dir])
    sc = LocalSparkContext(num_executors=1, task_timeout=120)
    try:
        cluster = TFCluster.run(sc, transformer_spark.main_fun, args, 1,
                                input_mode=TFCluster.InputMode.TENSORFLOW, env=CPU_ENV)
        assert cluster.wait_for_completion(timeout=120)
        metrics = cluster.metrics(include_driver=False)
        cluster.shutdown()
    finally:
        sc.stop()
    steps = sorted((e for e in metrics["events"] if e.get("span") == "train_step"),
                   key=lambda e: e["step"])
    assert [e["step"] for e in steps] == [1, 2, 3]
    assert all(np.isfinite(e["loss"]) and e["tokens_per_sec"] > 0 for e in steps)
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        assert metrics["counters"]["flash_attention_{}_launches_total".format(name)]["value"] == 0
    assert 0 < metrics["gauges"]["text_pack_efficiency"]["value"] <= 1


def test_two_executor_gloo_lm_keeps_params_bit_identical(tmp_path):
    """Rank 1 draws other initial weights; the broadcast from rank 0 and
    the averaged gradients keep both replicas bit-identical, and both ranks
    report the global batch's loss (the mean of the ranks', as the JAX
    package's SPMD step reports it)."""
    data_dir = str(tmp_path / "corpus")
    transformer_spark.make_text_corpus(data_dir, num_shards=2, records_per_shard=40)
    sc = LocalSparkContext(num_executors=2, task_timeout=120)
    try:
        cluster = TFCluster.run(sc, fn_lm_train_and_save, {"out_dir": str(tmp_path), "data_dir": data_dir},
                                2, input_mode=TFCluster.InputMode.TENSORFLOW, env=CPU_ENV)
        cluster.shutdown(timeout=120)
    finally:
        sc.stop()
    import torch

    ranks = [torch.load(tmp_path / "lm_rank{}.pt".format(r)) for r in (0, 1)]
    assert [r["world"] for r in ranks] == [2, 2]
    assert all(np.isfinite(r["losses"]).all() for r in ranks)
    assert ranks[0]["losses"] == ranks[1]["losses"]  # each rank trains on its own shard
    for name, value in ranks[0]["params"].items():
        assert torch.equal(value, ranks[1]["params"][name]), name


def test_two_executor_lm_on_a_dp_fsdp_mesh(tmp_path):
    """The LM example with ``--mesh dp=1,fsdp=2`` on 2 executors: the
    batch is split over the mesh's data axes (the parameters replicated,
    as in the JAX example), and both ranks report the same global loss at
    every step."""
    data_dir = str(tmp_path / "corpus")
    transformer_spark.make_text_corpus(data_dir, num_shards=2, records_per_shard=40)
    args = transformer_spark.build_parser().parse_args(TINY_LM + ["--data_dir", data_dir, "--mesh", "dp=1,fsdp=2"])
    sc = LocalSparkContext(num_executors=2, task_timeout=120)
    try:
        cluster = TFCluster.run(sc, transformer_spark.main_fun, args, 2,
                                input_mode=TFCluster.InputMode.TENSORFLOW, env=CPU_ENV)
        assert cluster.wait_for_completion(timeout=120)
        metrics = cluster.metrics(include_driver=False)
        cluster.shutdown(timeout=120)
    finally:
        sc.stop()
    losses = {}
    for e in metrics["events"]:
        if e.get("span") == "train_step":
            losses.setdefault(e["step"], []).append(e["loss"])
    assert sorted(losses) == [1, 2, 3]
    for step, values in losses.items():
        assert len(values) == 2 and values[0] == values[1] and np.isfinite(values[0]), (step, values)


@pytest.mark.parametrize("flag", [["--mesh", "dp=1,sp=2"]])
def test_unported_lm_options_are_refused(tmp_path, flag):
    """Once refused, now ported: the LM example on ``--mesh dp=1,sp=2``
    (each of 2 ranks on its half of every row, ring attention between
    them) trains through ``TFCluster.run``, with the same finite loss on
    both ranks at every logged step."""
    data_dir = str(tmp_path / "corpus")
    transformer_spark.make_text_corpus(data_dir, num_shards=2, records_per_shard=40)
    args = transformer_spark.build_parser().parse_args(TINY_LM + ["--data_dir", data_dir] + flag)
    sc = LocalSparkContext(num_executors=2, task_timeout=120)
    try:
        cluster = TFCluster.run(sc, transformer_spark.main_fun, args, 2,
                                input_mode=TFCluster.InputMode.TENSORFLOW, env=CPU_ENV)
        assert cluster.wait_for_completion(timeout=120)
        metrics = cluster.metrics(include_driver=False)
        cluster.shutdown(timeout=120)
    finally:
        sc.stop()
    losses = {}
    for e in metrics["events"]:
        if e.get("span") == "train_step":
            losses.setdefault(e["step"], []).append(e["loss"])
    assert sorted(losses) == [1, 2, 3]
    for step, values in losses.items():
        assert len(values) == 2 and values[0] == values[1] and np.isfinite(values[0]), (step, values)


@pytest.mark.parametrize("flag", [["--moe_experts", "2"], ["--remat"]])
def test_lm_options_run(tmp_path, flag):
    """The LM example's mixture of experts and rematerialization train
    through ``TFCluster.run``: a finite loss at every logged step."""
    data_dir = str(tmp_path / "corpus")
    transformer_spark.make_text_corpus(data_dir, num_shards=2, records_per_shard=40)
    steps, _ = _run_events(transformer_spark.main_fun,
                           transformer_spark.build_parser().parse_args(TINY_LM + ["--data_dir", data_dir] + flag))
    assert [e["step"] for e in steps] == [1, 2, 3]
    assert all(np.isfinite(e["loss"]) for e in steps)


def test_two_executor_lm_on_a_dp_tp_mesh(tmp_path):
    """The LM example with ``--mesh dp=1,tp=2`` on 2 executors: the two
    ranks of the tp group read the same shards with the same seed, so they
    train on the same batches (equal digests) and log the same loss at
    every step."""
    data_dir = str(tmp_path / "corpus")
    transformer_spark.make_text_corpus(data_dir, num_shards=2, records_per_shard=40)
    args = transformer_spark.build_parser().parse_args(TINY_LM + ["--data_dir", data_dir, "--mesh", "dp=1,tp=2"])
    sc = LocalSparkContext(num_executors=2, task_timeout=120)
    try:
        cluster = TFCluster.run(sc, transformer_spark.main_fun, args, 2,
                                input_mode=TFCluster.InputMode.TENSORFLOW, env=CPU_ENV)
        assert cluster.wait_for_completion(timeout=120)
        metrics = cluster.metrics(include_driver=False)
        cluster.shutdown(timeout=120)
    finally:
        sc.stop()
    seen = {}
    for e in metrics["events"]:
        if e.get("span") == "train_step":
            seen.setdefault(e["step"], []).append((e["loss"], e["batch_digest"]))
    assert sorted(seen) == [1, 2, 3]
    for step, values in seen.items():
        assert len(values) == 2 and values[0] == values[1] and np.isfinite(values[0][0]), (step, values)
    assert len({v[0][1] for v in seen.values()}) == 3  # a digest of the batches so far: it moves each step


def _run_events(main_fun, args, timeout=120):
    """``(train_step spans, ckpt_restore spans)`` of a one-executor run."""
    sc = LocalSparkContext(num_executors=1, task_timeout=timeout)
    try:
        cluster = TFCluster.run(sc, main_fun, args, 1, input_mode=TFCluster.InputMode.TENSORFLOW,
                                env=CPU_ENV)
        assert cluster.wait_for_completion(timeout=timeout)
        events = cluster.metrics(include_driver=False)["events"]
        cluster.shutdown()
    finally:
        sc.stop()
    return ([e for e in sorted(events, key=lambda e: e.get("step", 0)) if e.get("span") == "train_step"],
            [e for e in events if e.get("span") == "ckpt_restore"])


def test_transformer_model_dir_saves_and_resumes(tmp_path):
    """``--model_dir`` on the LM example: the final state is saved as
    ``ckpt_<train_steps>``; a second run with more steps restores it and
    trains only the rest."""
    from tensorflowonspark_tpu_torch import ckpt
    from tensorflowonspark_tpu_torch.train import checkpoint

    data_dir, model_dir = str(tmp_path / "corpus"), str(tmp_path / "model")
    transformer_spark.make_text_corpus(data_dir, num_shards=2, records_per_shard=40)
    argv = TINY_LM + ["--data_dir", data_dir, "--model_dir", model_dir]
    first, restores = _run_events(transformer_spark.main_fun, transformer_spark.build_parser().parse_args(argv))
    assert [e["step"] for e in first] == [1, 2, 3] and restores[0]["path"] is None
    assert sorted(os.listdir(model_dir)) == ["ckpt_3"]
    argv[argv.index("--train_steps") + 1] = "5"
    second, restores = _run_events(transformer_spark.main_fun, transformer_spark.build_parser().parse_args(argv))
    assert [e["step"] for e in second] == [4, 5]
    assert restores[0]["path"].endswith("ckpt_3") and restores[0]["step"] == 3
    assert sorted(os.listdir(model_dir)) == ["ckpt_3", "ckpt_5"]
    assert ckpt.verify(os.path.join(model_dir, "ckpt_5")) == (True, "verified")
    tree = checkpoint.restore_checkpoint(os.path.join(model_dir, "ckpt_5"))
    assert tree["step"] == 5 and int(tree["opt_state"]["count"]) == 5


def _train_step_losses(main_fun, args, timeout=120):
    """``{step: loss}`` of the ``train_step`` spans of a one-executor run."""
    sc = LocalSparkContext(num_executors=1, task_timeout=timeout)
    try:
        cluster = TFCluster.run(sc, main_fun, args, 1, input_mode=TFCluster.InputMode.TENSORFLOW,
                                env=CPU_ENV)
        assert cluster.wait_for_completion(timeout=timeout)
        metrics = cluster.metrics(include_driver=False)
        cluster.shutdown()
    finally:
        sc.stop()
    return {e["step"]: (e["loss"], e["steps"], e.get("device_trace"))
            for e in metrics["events"] if e.get("span") == "train_step"}


@pytest.mark.parametrize("example", ["resnet", "transformer"])
def test_steps_per_loop_gives_the_eager_runs_losses(example, tmp_path):
    """``--steps_per_loop 2`` through TFCluster.run: two loops of two steps,
    whose losses (logged at steps 2 and 4) are the eager run's at the same
    steps, bitwise (on the CPU the loop runs the eager step). The second
    call is traced (``--trace_call 2``): its span carries the trace's
    readings, no device kernel on the CPU, the host time of the call."""
    if example == "resnet":
        mod, argv = resnet_spark, list(TINY)
    else:
        data_dir = str(tmp_path / "corpus")
        transformer_spark.make_text_corpus(data_dir, num_shards=2, records_per_shard=40)
        mod, argv = transformer_spark, TINY_LM + ["--data_dir", data_dir]
    argv[argv.index("--train_steps") + 1] = "4"
    eager = _train_step_losses(mod.main_fun, mod.build_parser().parse_args(argv))
    looped = _train_step_losses(mod.main_fun, mod.build_parser().parse_args(
        argv + ["--steps_per_loop", "2", "--trace_call", "2"]))
    assert sorted(eager) == [1, 2, 3, 4] and all(n == 1 and t is None for _, n, t in eager.values())
    assert sorted(looped) == [2, 4] and all(n == 2 for _, n, _ in looped.values())
    for step, (loss, _, _) in looped.items():
        assert np.isfinite(loss) and loss == eager[step][0], (step, loss, eager[step])
    assert looped[2][2] is None
    trace = looped[4][2]
    assert trace["kernels"] == 0 and trace["graph_launches"] == 0 and trace["idle_share"] == 1.0
    assert set(trace["launches"].values()) == {0}
    assert 0 < trace["host_ms"]["train.call"] <= trace["window_ms"]


def test_resnet_spark_main_fun_trains_through_one_executor_cluster():
    """The example's main_fun through TFCluster.run: per-step losses land in
    the trainer's obs plane (read back with cluster.metrics()), and on the
    CPU the fused-BN wrappers take their plain versions (0 launches)."""
    args = resnet_spark.build_parser().parse_args(TINY)
    sc = LocalSparkContext(num_executors=1, task_timeout=120)
    try:
        cluster = TFCluster.run(sc, resnet_spark.main_fun, args, 1,
                                input_mode=TFCluster.InputMode.TENSORFLOW, env=CPU_ENV)
        assert cluster.wait_for_completion(timeout=120)
        metrics = cluster.metrics(include_driver=False)
        cluster.shutdown()
    finally:
        sc.stop()
    steps = sorted((e for e in metrics["events"] if e.get("span") == "train_step"),
                   key=lambda e: e["step"])
    assert [e["step"] for e in steps] == [1, 2]
    assert all(np.isfinite(e["loss"]) and e["images_per_sec"] > 0 for e in steps)
    for name in ("bn_stats", "bn_normalize", "bn_bwd_reduce", "bn_bwd_dx"):
        assert metrics["counters"]["fused_bn_{}_launches_total".format(name)]["value"] == 0


def test_two_executor_gloo_world_keeps_params_bit_identical(tmp_path):
    sc = LocalSparkContext(num_executors=2, task_timeout=120)
    try:
        cluster = TFCluster.run(sc, fn_train_and_save, {"out_dir": str(tmp_path)}, 2,
                                input_mode=TFCluster.InputMode.TENSORFLOW, env=CPU_ENV)
        cluster.shutdown(timeout=120)
    finally:
        sc.stop()
    import torch

    ranks = [torch.load(tmp_path / "rank{}.pt".format(r)) for r in (0, 1)]
    assert [r["world"] for r in ranks] == [2, 2] and ranks[0]["device"] == "cpu"
    for name, value in ranks[0]["params"].items():
        assert torch.equal(value, ranks[1]["params"][name]), name
    # global BN: both ranks' statistics come from the global batch
    assert torch.equal(ranks[0]["running_mean"], ranks[1]["running_mean"])


def test_gpu_platform_without_cuda_fails_the_cluster():
    """--platform gpu (the default) never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sc = LocalSparkContext(num_executors=1, task_timeout=120)
    try:
        with pytest.raises(RuntimeError, match="sees no CUDA device"):
            resnet_spark.main([a if a != "cpu" else "gpu" for a in TINY], sc=sc)
    finally:
        sc.stop()


def test_resnet_model_dir_checkpoints_prunes_and_resumes(tmp_path):
    """``--model_dir --checkpoint_steps 2 --keep_checkpoints 2`` on the
    ResNet example: saves on loop-call boundaries, pruned to the newest
    two, each manifest-verified; a second run with more steps restores the
    newest (a ``ckpt_restore`` span) and trains only the rest, so its
    ``train_step`` spans start past it."""
    from tensorflowonspark_tpu_torch import ckpt
    from tensorflowonspark_tpu_torch.train import checkpoint

    model_dir = str(tmp_path / "model")
    argv = list(TINY) + ["--model_dir", model_dir, "--checkpoint_steps", "2", "--keep_checkpoints", "2",
                         "--steps_per_loop", "2"]
    argv[argv.index("--train_steps") + 1] = "6"
    first, restores = _run_events(resnet_spark.main_fun, resnet_spark.build_parser().parse_args(argv))
    assert [e["step"] for e in first] == [2, 4, 6] and restores[0]["path"] is None
    assert sorted(os.listdir(model_dir)) == ["ckpt_4", "ckpt_6"]
    argv[argv.index("--train_steps") + 1] = "10"
    second, restores = _run_events(resnet_spark.main_fun, resnet_spark.build_parser().parse_args(argv))
    assert [e["step"] for e in second] == [8, 10]
    assert restores[0]["path"].endswith("ckpt_6") and restores[0]["step"] == 6
    assert sorted(os.listdir(model_dir)) == ["ckpt_10", "ckpt_8"]
    for name in os.listdir(model_dir):
        assert ckpt.verify(os.path.join(model_dir, name)) == (True, "verified")
    tree = checkpoint.restore_checkpoint(os.path.join(model_dir, "ckpt_10"))
    assert tree["step"] == 10 and int(tree["opt_state"]["count"]) == 10
    assert tree["model_state"] and all(k.endswith(("running_mean", "running_var")) for k in tree["model_state"])


def test_resnet_auto_recover_runs_through_run_with_recovery(tmp_path):
    """``--auto_recover`` runs the example through
    ``TFCluster.run_with_recovery`` (0 relaunches on a healthy run, the
    final checkpoint written), and refuses to run without a checkpoint to
    resume from."""
    model_dir = str(tmp_path / "model")
    sc = LocalSparkContext(num_executors=1, task_timeout=120)
    try:
        relaunches = resnet_spark.main(TINY + ["--auto_recover", "1", "--model_dir", model_dir,
                                               "--checkpoint_steps", "2"], sc=sc)
    finally:
        sc.stop()
    assert relaunches == 0 and sorted(os.listdir(model_dir)) == ["ckpt_2"]
    with pytest.raises(SystemExit):
        resnet_spark.main(TINY + ["--auto_recover", "1"])


def test_run_with_recovery_checks_its_input_mode():
    """``run_with_recovery`` runs (tests/test_torch_resume.py kills and
    resumes a trainer through it); it checks the feed mode first, as the
    JAX package's does."""
    with pytest.raises(ValueError, match="feed_fn"):
        TFCluster.run_with_recovery(None, fn_train_and_save, {}, 1, input_mode=TFCluster.InputMode.SPARK)
    with pytest.raises(ValueError, match="InputMode.SPARK"):
        TFCluster.run_with_recovery(None, fn_train_and_save, {}, 1, input_mode=TFCluster.InputMode.TENSORFLOW,
                                    feed_fn=lambda cluster: None)


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """Every module of the port and chip_smoke.py import with jax, flax,
    optax, orbax and the JAX package blocked."""
    code = """
import importlib, pkgutil, sys
for name in ("jax", "flax", "optax", "orbax", "tensorflowonspark_tpu"):
    sys.modules[name] = None
import tensorflowonspark_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = [m for m, v in sys.modules.items() if v is not None and (
    m in ("jax", "flax", "optax", "orbax") or m == "tensorflowonspark_tpu"
    or m.startswith(("tensorflowonspark_tpu.", "jax.", "flax.", "optax.", "orbax.")))]
assert not leaked, leaked
assert len(names) >= 50, names
# the train loop, its input placement and the split BN reductions
from tensorflowonspark_tpu_torch.data.loader import PinnedPlacer, loop_prefetch, packed_prefetch
from tensorflowonspark_tpu_torch.ops.fused_bn import bn_finish, bn_stats_sums, bn_bwd_reduce_sums
from tensorflowonspark_tpu_torch.train.strategy import _CapturedLoop, run_steps, steps_per_worker
from tensorflowonspark_tpu_torch import ckpt, control, elastic
from tensorflowonspark_tpu_torch.ckpt import AsyncCheckpointEngine, snapshot_to_host, verify
from tensorflowonspark_tpu_torch.convert import convert_train_state
from tensorflowonspark_tpu_torch.train import checkpoint
from tensorflowonspark_tpu_torch.examples import sync_dp_check
from tensorflowonspark_tpu_torch.examples.resnet import bench_bn, profile_step
from tensorflowonspark_tpu_torch.ops.kernel_trace import KernelTrace, kernel_base
from tensorflowonspark_tpu_torch.examples.transformer import profile_step as lm_profile_step
# the MNIST slice: model, export, metrics, the pipeline, dfutil, TFParallel
from tensorflowonspark_tpu_torch import TFParallel, dfutil, pipeline
from tensorflowonspark_tpu_torch.models.mnist import MnistCNN, MnistMLP, bundle_builder
from tensorflowonspark_tpu_torch.train import TimeHistory, adam, build_stats, export
from tensorflowonspark_tpu_torch.examples.mnist import (
    mnist_data_setup, mnist_inference, mnist_pipeline, mnist_spark, mnist_spark_streaming, mnist_tf)
# the image real-data plane: native IO, parsing, the decode plane, the slab
# cache, the autotuners, the remote stores and staging
from tensorflowonspark_tpu_torch import native_io
from tensorflowonspark_tpu_torch.data import (AutotunedWindow, DecodeAutotuner, DecodePlane, FeedAutotuner,
    LinkEstimator, autotuned_prefetch, cifar, imagenet)
from tensorflowonspark_tpu_torch.data.autotune import ReadaheadAutotuner
from tensorflowonspark_tpu_torch.data.slab_cache import SlabCache
from tensorflowonspark_tpu_torch.store import HTTPStore, resolve_store, staging
from tensorflowonspark_tpu_torch.examples.resnet import resnet_data_setup
assert imagenet.make_parse_fn and native_io.jpg_decode_window
# the serving plane: the server, the batch CLI, the mesh and its exporter
from tensorflowonspark_tpu_torch.serving import InferenceClient, InferenceServer, load_bundle, run_batch_inference
from tensorflowonspark_tpu_torch.serving_mesh import MeshFrontend, ModelPointer, ReplicaRouter, ServingMesh
from tensorflowonspark_tpu_torch.obs.exporter import MetricsHTTPServer, histogram_quantile, render_prometheus
from tensorflowonspark_tpu_torch.obs.tracemerge import merge_directory
# the segmentation slice and its leftovers: the U-Net, compat, the estimator's
# evaluator role, stop_cluster
from tensorflowonspark_tpu_torch import compat
from tensorflowonspark_tpu_torch.models.segmentation import UNet, bundle_builder as seg_bundle_builder
from tensorflowonspark_tpu_torch.examples.segmentation import segmentation_spark
from tensorflowonspark_tpu_torch.examples.mnist import mnist_estimator
from tensorflowonspark_tpu_torch.examples.utils import stop_cluster
assert "tensorflowonspark_tpu_torch.examples.segmentation.segmentation_spark" in names
print("imported", len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "imported" in out.stdout
