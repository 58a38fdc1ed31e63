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


def _cards_of_life(template, cards, blacklist=(), hosts=None):
    """{executor: (rank, card)} of one life of ``template``'s world, each
    card placed as the executor's node places it (``_card_peers`` over the
    reservation, the relaunch's blacklist, ``TFNodeContext.card``)."""
    from tensorflowonspark_tpu_torch import TFSparkNode

    info = [{"executor_id": e, "job_name": j, "task_index": t, "host": (hosts or {}).get(e, "h"),
             "port": 7000 + e} for e, (j, t) in template.items()]
    placed = {}
    for eid, (job, task) in template.items():
        if job not in ("chief", "master", "worker"):
            continue
        me = {"executor_id": eid}
        _, world, rank = TFSparkNode._derive_world(info, me)
        ctx = TFSparkNode.TFNodeContext(eid, job, task, {}, "file://", ".", num_processes=world, process_id=rank,
                                        card_peers=TFSparkNode._card_peers(info, me), lost=blacklist)
        placed[eid] = (rank, ctx.card(cards))
    return placed


def test_a_card_stays_with_its_executor_across_a_shrink():
    """``ctx.card`` is the executor's card, not the rank's: after executor 1
    of 4 is blacklisted and the world re-forms at 3, every survivor keeps
    its card and none is handed executor 1's, which the rank would have
    given executor 2 (ranks 0, 1, 2 on executors 0, 2, 3); the regrown
    world of 4 puts executor 1 back on its own."""
    full = _cards_of_life(TFCluster.build_cluster_template(4, master_node=None), 4)
    shrunk = _cards_of_life(TFCluster.build_cluster_template(3, master_node=None, blacklist={1}), 4, blacklist=[1])
    assert {e: card for e, (_, card) in full.items()} == {0: 0, 1: 1, 2: 2, 3: 3}
    assert {e: rank for e, (rank, _) in shrunk.items()} == {0: 0, 2: 1, 3: 2}
    assert {e: card for e, (_, card) in shrunk.items()} == {0: 0, 2: 2, 3: 3}
    assert full[1][1] not in {card for _, card in shrunk.values()}
    assert shrunk[2][0] == full[1][1]  # the card the rank would have handed over
    assert _cards_of_life(TFCluster.build_cluster_template(4, master_node=None), 4) == full


def test_an_evaluator_leaves_no_two_ranks_on_one_card():
    """5 executors on a host of 4 cards with ``eval_node=True``: the chief
    (executor 0) and the workers (2, 3, 4) form the world of 4 around the
    evaluator (1); executor 4 would wrap onto the chief's card, so it takes
    the card no rank owns. After the loss of worker 2 the survivors keep
    their cards; after the loss of the chief (the roles re-laid from
    executor 1), no rank takes executor 0's card."""
    first = _cards_of_life(TFCluster.build_cluster_template(5, eval_node=True), 4)
    assert {e: card for e, (_, card) in first.items()} == {0: 0, 2: 2, 3: 3, 4: 1}
    after_2 = _cards_of_life(TFCluster.build_cluster_template(4, eval_node=True, blacklist={2}), 4, blacklist=[2])
    assert {e: card for e, (_, card) in after_2.items()} == {0: 0, 3: 3, 4: 1}
    after_0 = _cards_of_life(TFCluster.build_cluster_template(4, eval_node=True, blacklist={0}), 4, blacklist=[0])
    assert sorted(after_0) == [1, 3, 4]
    cards = [card for _, card in after_0.values()]
    assert len(set(cards)) == len(cards) and 0 not in cards


def test_a_spare_executor_takes_the_only_free_card():
    """A relaunch with a blacklist and a spare (``TFCluster.run`` of 4 on 5
    executors, executor 1 banned): the survivors 0, 2, 3 keep their cards
    and the spare, executor 4, whose own card is the chief's, takes the one
    card no rank holds; a world with more ranks on the host than cards
    raises before NCCL would."""
    life = _cards_of_life(TFCluster.build_cluster_template(4, blacklist={1}), 4, blacklist=[1])
    assert {e: card for e, (_, card) in life.items()} == {0: 0, 2: 2, 3: 3, 4: 1}
    with pytest.raises(ValueError, match="5 ranks of one world on a host with 4 card"):
        _cards_of_life(TFCluster.build_cluster_template(5), 4)


def test_cards_are_placed_per_host():
    """Two hosts of 4 cards, executors 0–3 on one and 4–7 on the other: each
    host's ranks take its 4 cards, executors past a host's cards included;
    the co-located executors of a world-less cluster (no peers: the ladder
    on one card) share the cards by id."""
    hosts = {e: "h{}".format(e // 4) for e in range(8)}
    life = _cards_of_life(TFCluster.build_cluster_template(8), 4, hosts=hosts)
    assert {e: card for e, (_, card) in life.items()} == {e: e % 4 for e in range(8)}
    assert [util.card_map([e], 1)[e] for e in range(2)] == [0, 0]
    assert [util.card_map([e], 2)[e] for e in range(4)] == [0, 1, 0, 1]


def test_zero3_on_a_world_of_three_replicates_what_the_jax_rule_replicates():
    """The full-width LM's parameters on ``{"fsdp": 3}`` (the ladder's world
    after a shrink from 4): the port's rule splits the same flax dimension
    as the JAX package's, leaf for leaf, and replicates the leaves it
    replicates (3 divides none of 32,000, 512 and 2,048)."""
    import jax
    import torch

    from tensorflowonspark_tpu import parallel as jparallel
    from tensorflowonspark_tpu.models import transformer as jtransformer
    from tensorflowonspark_tpu.parallel import sharding as jsharding
    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
    from tensorflowonspark_tpu_torch.parallel import sharding

    width = dict(vocab_size=32000, d_model=512, n_layers=6, n_heads=8, d_ff=2048)
    for n in (3, 4):
        jmodel = jtransformer.create_model(**width)
        shapes = jax.eval_shape(jtransformer.make_init_fn(jmodel), jax.random.PRNGKey(0))["params"]
        jspecs = jsharding.fsdp_param_specs(shapes, jparallel.build_mesh({"fsdp": n}, devices=jax.devices()[:n]))
        want = {"/".join(str(getattr(k, "key", k)) for k in path): next(
            (i for i, e in enumerate(spec) if e == "fsdp"), None)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
        with torch.device("meta"):
            module = transformer.create_model(**width)
        plan = mesh_lib.build_mesh({"fsdp": -1}, [mesh_lib.RankDevice(r, None) for r in range(n)],
                                   device_type="cpu", plan=True)
        specs = sharding.fsdp_param_specs(module, plan)
        layouts = convert.flax_layouts(module)
        leaf = {"kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight"}
        got = {}
        for key in want:
            name = ".".join(key.split("/")[:-1] + [leaf[key.split("/")[-1]]])
            shape, dims = layouts[name]
            port_dim = next((i for i, e in enumerate(specs[name]) if e == "fsdp"), None)
            got[key] = None if port_dim is None else next(d for d in range(len(shape)) if dims[d] == port_dim)
        assert got == want, n
        assert any(v is not None for v in want.values()) == (n == 4)


def test_cluster_check_rehearsal(tmp_path):
    """``cluster_check.py --platform cpu --size small`` on 4 gloo executors
    through ``TFCluster.run``: the dp and dp×tp LM legs (every rank's
    losses and gathered parameters equal), the MNIST example fed from Spark
    in uneven partitions under the chaos plan (every rank trains the same
    steps to the same parameters, every row and fault counted) and the
    ladder (worlds 4 → 3 → 4, every restore bitwise the checkpoint, one
    shrink, one regrow)."""
    import json

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "tensorflowonspark_tpu_torch.examples.cluster_check", "--platform", "cpu",
         "--size", "small", "--legs", "lm_dp4,lm_dp2_tp2,mnist_spark_dp4,ladder4", "--work_dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = {x["leg"]: x for x in (json.loads(y) for y in proc.stdout.splitlines() if y.startswith('{"leg"'))}
    assert sorted(lines) == ["ladder4", "lm_dp2_tp2", "lm_dp4", "mnist_spark_dp4"]
    for name in ("lm_dp4", "lm_dp2_tp2"):
        line = lines[name]
        assert line["failures"] == [] and line["gathered_params_equal_on_every_rank"]
        assert [c["executor"] for c in line["cards"]] == [0, 1, 2, 3]
        assert len({json.dumps(v) for v in line["losses_by_rank"].values()}) == 1
    mnist = lines["mnist_spark_dp4"]
    # steps_per_worker(2 x 1,200, 16, 4) = int(37 x 0.9) = 33 a rank
    assert mnist["failures"] == [] and mnist["steps"] == [33] * 4 and mnist["params_equal_on_every_rank"]
    assert len(set(mnist["last_losses"])) == 1 and mnist["rows_trained"] == 4 * 33 * 16
    assert sorted(set(mnist["partitions"])) == [60, 120, 180, 240] and mnist["trainers_left"] == []
    assert mnist["faults"] == {"chaos_fault_reservation_reg_drop_total": 1, "chaos_fault_feed_slow_consumer_total": 8,
                               "chaos_faults_injected_total": 9}
    ladder = lines["ladder4"]
    assert ladder["failures"] == [] and ladder["worlds"] == [4, 3, 4] and ladder["blacklist"] == []
    assert [sorted(life["cards"]) for life in ladder["lives"]] == [["0", "1", "2", "3"], ["0", "1", "2"],
                                                                   ["0", "1", "2", "3"]]
    assert all(life["restore_mismatches"] == [] and life["restore_tensors"] for life in ladder["lives"][1:])
    assert ladder["counters"]["recovery_shrinks_total"] == ladder["counters"]["recovery_regrows_total"] == 1
    # on gloo the survivors' collectives fail on the lost peer: the abort
    # finds each exited or ends it by SIGTERM, never by SIGKILL
    assert sorted(ladder["survivor_exits"]) == ["0", "1", "2"]
    assert "sigkill" not in ladder["survivor_exits"].values(), ladder["survivor_exits"]


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
from tensorflowonspark_tpu_torch.examples import cluster_check, sync_dp_check
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
# pipeline parallelism, the host all-reduce group, bucketed overlap and the
# per-K packed-loop cache
from tensorflowonspark_tpu_torch.parallel import (HostAllReduceGroup, Pipeline1F1B, merge_microbatches,
    pipeline_apply, pipeline_apply_local, schedule_1f1b, split_microbatches, stack_stage_params)
from tensorflowonspark_tpu_torch.train import BucketedOverlap, PackedLoopCache
assert {"tensorflowonspark_tpu_torch.parallel.pipeline_parallel",
        "tensorflowonspark_tpu_torch.parallel.hostreduce"} <= set(names)
# the main path across executors and the ladder on four cards
assert "tensorflowonspark_tpu_torch.examples.cluster_check" in names and cluster_check.leg_ladder
assert cluster_check.leg_mnist_spark and cluster_check.mnist_spark_story and cluster_check.tear_result
print("imported", len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "imported" in out.stdout
