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
    the averaged gradients keep both replicas bit-identical."""
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
    assert ranks[0]["losses"] != ranks[1]["losses"]  # each rank trains on its own shard
    for name, value in ranks[0]["params"].items():
        assert torch.equal(value, ranks[1]["params"][name]), name


@pytest.mark.parametrize("flag", [["--moe_experts", "2"], ["--mesh", "dp=1,tp=2"], ["--remat"],
                                  ["--steps_per_loop", "2"], ["--model_dir", "m"],
                                  ["--pack_workers", "2"], ["--slab_cache_dir", "s"]])
def test_unported_lm_options_are_refused(flag):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        transformer_spark.main(TINY_LM + flag)


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
    # per-replica BN: each rank's statistics come from its own batch
    assert not torch.equal(ranks[0]["running_mean"], ranks[1]["running_mean"])


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


@pytest.mark.parametrize("flag", [["--model_dir", "m"], ["--data_dir", "d"], ["--eval_dir", "e"],
                                  ["--profile_steps", "2,3"], ["--steps_per_loop", "4"],
                                  ["--auto_recover", "1"]])
def test_unported_options_are_refused(flag):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        resnet_spark.main(TINY + flag)


def test_run_with_recovery_is_refused():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        TFCluster.run_with_recovery(None, fn_train_and_save, {}, 1)


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
print("imported", len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "imported" in out.stdout
