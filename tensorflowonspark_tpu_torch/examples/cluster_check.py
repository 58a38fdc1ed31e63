"""The main path across executors: four executors, one card each, in one
NCCL world formed from the reservation, through the port's
``TFCluster.run`` and ``elastic.run_ladder``.

Every leg starts its trainers the way a user's driver does: ``TFCluster.run``
on the local backend's executors, each executor's trainer child on its own
card (``TFNodeContext.card``: the card follows the executor, not the rank),
the world from the reservation (``TFSparkNode._derive_world``,
``ctx.initialize_distributed``), the mesh from the reservation's hosts
(``ctx.mesh``). Each leg prints one JSON line:

* ``resnet_dp4`` — ``examples/resnet/resnet_spark.py``'s ``main_fun``,
  bf16, batch 64 a card, 224 px, synthetic, ``--bn_impl pallas``,
  ``--steps_per_loop 5`` (the loop's first call: two eager warm-up steps
  and the capture; then replays), cuDNN deterministic: images/s a card
  after the first call, each rank's BN wrapper launches (the reductions in
  their split mode: ``bn_finish`` after each all-reduce), and every rank's
  parameters and BN statistics, which must be bitwise equal.
* ``lm_dp4``, ``lm_dp2_tp2`` — ``examples/transformer/transformer_spark.py``'s
  ``main_fun`` at the full width (``TransformerConfig``'s defaults), seq
  2,048, 8 rows in all (``--mesh dp=4``; ``dp=2,tp=2``), ``--steps_per_loop
  5``: captured step ms, each rank's logged losses (global: equal on every
  rank) and its gathered parameters (equal on every rank), the flash
  kernels' launches.
* ``mnist_spark_dp4`` — InputMode.SPARK: ``examples/mnist/mnist_spark.py``'s
  ``main_fun`` (the MLP at its full width, 784-512-10 f32, Adam 1e-3, batch
  64 a rank) on 4 executors in one world, fed by ``cluster.train`` from an
  RDD of ``MNIST_ROWS`` synthetic rows × ``MNIST_EPOCHS`` epochs in uneven
  partitions (4:3:2:1:4:3:2:1 of an epoch) pinned so that every executor
  gets the same rows an epoch from partitions of other sizes, under the
  JAX package's chaos plan of ``test_chaos_cluster.py`` (a dropped
  registration in the driver, two slow dequeues in each trainer): every
  rank trains ``steps_per_worker``'s steps on its own card, ends with the
  same parameter bytes and the same last loss (the global batch's), and
  the merged metrics count the rows and the faults. Beside it, the same
  example on one executor (``chip_smoke.py``'s ``slice_mnist``: one epoch of
  ``MNIST_ROWS`` rows in 8 even partitions): rows/s a card.
* ``ladder4`` — the LM at the full width on ``{"fsdp": -1}`` with a
  checkpoint directory, through ``elastic.run_ladder`` on 4 executors: the
  kill of executor 3 is armed (its ``once_path`` latch removed) once a
  checkpoint of step ``kill_step`` or later is committed; the survivors
  block in their next collective until the driver's abort ends them; the
  ladder blacklists executor 3 and shrinks to 3 (a world of 3,
  ``reshard_restore`` 4 → 3); the mid-run regrow probe forgives it, the
  scaler votes to grow and the driver's preemption warning drains the
  world of 3; the relaunch restores 3 → 4 and trains to the end. Each life
  records its executor → card map, world, the step it resumed at and
  whether the restored tensors, gathered, equal the checkpoint's bitwise;
  the line adds how the survivors left (the abort's SIGTERM drain or its
  SIGKILL after the grace) and the kill → abort → first step seconds.
* ``mnist_spark_recover4`` — the JAX package's
  ``test_spark_feed_killed_node_training_finishes_anyway`` on
  ``mnist_spark.main_fun`` in one world of 4 (``mnist_spark_dp4``'s model,
  batch and pinned partitions, one epoch a feed wave, rank 0 saving every
  50 steps): executor 2's trainer is killed once a checkpoint is
  committed, mid-feed; ``TFCluster.run_with_recovery(feed_fn=...)`` aborts
  the world and relaunches it at 4, the reference's ``feed_fn`` re-feeds
  it, and every rank resumes from the newest checkpoint, bitwise rank 0's
  save, to ``steps_per_worker``'s step. The line reads kill → the
  driver's first error → ``feed_fn``'s return → abort → relaunch → first
  step → last step.

``--platform gpu`` (the default) raises unless torch sees 4 cards; ``--platform
cpu --size small`` rehearses every leg on 4 gloo executors at narrow widths.
Exits non-zero if any leg's check fails. On four cards::

    python -m tensorflowonspark_tpu_torch.examples.cluster_check
"""

import argparse
import contextlib
import glob
import hashlib
import json
import math
import os
import shutil
import sys
import threading
import time

WORLD = 4
LEGS = ("resnet_dp4", "lm_dp4", "lm_dp2_tp2", "mnist_spark_dp4", "ladder4", "mnist_spark_recover4")
LM_FULL = dict(vocab_size=32000, d_model=512, n_layers=6, n_heads=8, d_ff=2048)
LM_SMALL = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128)
SIZES = {
    "full": dict(resnet=["--dataset", "imagenet", "--batch_size", "64"], resnet_steps=60,
                 lm=LM_FULL, seq=2048, lm_steps=40, ladder_rows=12, ladder_every=50, ladder_kill=50,
                 ladder_tail=50, regrow_s=45.0, mnist_rows=30000, mnist_batch=64, recover_rows=30000,
                 recover_every=50, recover_feed_timeout=120),
    "small": dict(resnet=["--dataset", "cifar", "--image_size", "8", "--batch_size", "4"], resnet_steps=10,
                  lm=LM_SMALL, seq=64, lm_steps=10, ladder_rows=12, ladder_every=4, ladder_kill=4,
                  ladder_tail=4, regrow_s=12.0, mnist_rows=1200, mnist_batch=16, recover_rows=2400,
                  # the recovery leg's first checkpoint lands in the victim's last
                  # partition of the first wave (its partitions end at steps 22.5 and
                  # 37.5), so one feed task waits out the timeout, not two; the feed
                  # timeout (s; the reference test's 120 at full) is at least 5x the
                  # longest healthy wave measured on the CPU beside the test suite's 6
                  # workers, 3.60 s (a life's first wave, its trainers started): 6.9x
                  recover_every=24, recover_feed_timeout=25),
}
#: the MNIST leg's shutdown bound (seconds)
SHUTDOWN_S = 120
#: the LM legs' global batch (rows), split over each leg's data axes
LM_ROWS = 8
STEPS_PER_LOOP = 5
HEARTBEAT_S = 0.25
#: the MNIST leg's epochs, and its partitions' sizes in parts of an epoch's
#: rows, each pinned to an executor (PINS[i] takes partition i): every
#: executor gets 5 parts an epoch from partitions of two sizes
MNIST_EPOCHS = 2
MNIST_PARTS = (4, 3, 2, 1, 4, 3, 2, 1)
MNIST_PINS = (0, 1, 1, 0, 3, 2, 2, 3)
#: the JAX package's cluster chaos plan (``tests/test_chaos_cluster.py``):
#: one dropped registration in the driver, two 10 ms slow dequeues in each
#: trainer; both only delay
MNIST_CHAOS = (("reservation.reg_drop", dict(probability=1.0, max_count=1)),
               ("feed.slow_consumer", dict(probability=1.0, max_count=2, delay_s=0.01)))


def emit(obj):
    print(json.dumps(obj), flush=True)


def _digest(tree):
    """sha256 of a ``{name: tensor}`` tree's bytes, names in order."""
    import torch

    h = hashlib.sha256()
    for name in sorted(tree):
        t = tree[name].detach().cpu().contiguous().reshape(-1)
        h.update(name.encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _full(state):
    """The state's parameters and buffers as full tensors (a model split
    over tp gathers its blocks: collective)."""
    params = {k: v.detach() for k, v in state.params.items()}
    if state.blocks is not None:
        params = state.blocks.full_tree(params)
    return params, dict(state.model_state)


def _card(ctx, device):
    return {"executor_id": ctx.executor_id, "rank": ctx.process_id, "world": ctx.num_processes,
            "device": str(device), "card": device.index, "coordinator": ctx.coordinator_address}


def leg_fun(args, ctx):
    """An example's ``main_fun`` (``args.check_module``), then this rank's
    record: its executor → card, the digests of its final parameters and
    buffers (and of the initial ones, which a step must have changed), and
    its kernel wrappers' launches, into ``args.check_dir``."""
    import importlib

    from tensorflowonspark_tpu_torch.ops import flash_attention, fused_bn
    from tensorflowonspark_tpu_torch.train import strategy as strategy_mod

    made = []
    create = strategy_mod.SyncDataParallel.create_state

    def recording(self, *a, **kw):
        state = create(self, *a, **kw)
        made.append((state, _digest(_full(state)[0])))
        return state

    strategy_mod.SyncDataParallel.create_state = recording
    try:
        importlib.import_module(args.check_module).main_fun(args, ctx)
    finally:
        strategy_mod.SyncDataParallel.create_state = create
    state, initial = made[-1]
    params, buffers = _full(state)
    record = dict(_card(ctx, ctx.device), params_sha256=_digest(params), buffers_sha256=_digest(buffers),
                  initial_params_sha256=initial,
                  launches=dict(fused_bn.launch_counts(), bn_finish=fused_bn.bn_finish.launches,
                                **flash_attention.launch_counts()))
    with open(os.path.join(args.check_dir, "rank_{}.json".format(ctx.process_id)), "w") as f:
        json.dump(record, f)


def _ranks(check_dir):
    got = []
    for path in sorted(glob.glob(os.path.join(check_dir, "rank_*.json"))):
        with open(path) as f:
            got.append(json.load(f))
    return sorted(got, key=lambda r: r["rank"])


def _run(name, module, argv, work, platform, timeout=900):
    """One leg through ``TFCluster.run`` on ``WORLD`` executors; returns
    (its rank records, the merged metrics, wall seconds)."""
    import importlib

    from tensorflowonspark_tpu_torch import TFCluster, util
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext

    check_dir = os.path.join(work, name)
    os.makedirs(check_dir, exist_ok=True)
    for old in glob.glob(os.path.join(check_dir, "rank_*.json")):
        os.remove(old)
    args = importlib.import_module(module).build_parser().parse_args(argv)
    args.check_module, args.check_dir = module, check_dir
    t0 = time.perf_counter()
    sc = LocalSparkContext(num_executors=WORLD)
    try:
        cluster = TFCluster.run(sc, leg_fun, args, WORLD, input_mode=TFCluster.InputMode.TENSORFLOW,
                                master_node="chief", env={util.ENV_PLATFORM: platform})
        if not cluster.wait_for_completion(timeout=timeout):
            raise TimeoutError("{}: the trainers did not finish within {} s".format(name, timeout))
        metrics = cluster.metrics(include_driver=False)
        cluster.shutdown()
    finally:
        sc.stop()
    return _ranks(check_dir), metrics, time.perf_counter() - t0


def _calls(metrics, node):
    """The ``train_step`` spans of one node, in step order."""
    events = (metrics.get("nodes", {}).get(node) or {}).get("events", [])
    return sorted((e for e in events if e.get("span") == "train_step"), key=lambda e: e["step"])


def _world_checks(name, ranks, failures):
    cards = [r["card"] for r in ranks]
    if len(ranks) != WORLD or sorted(r["rank"] for r in ranks) != list(range(WORLD)):
        failures.append("{}: {} rank records".format(name, len(ranks)))
    if any(r["world"] != WORLD for r in ranks):
        failures.append("{}: worlds {}".format(name, [r["world"] for r in ranks]))
    if cards[0] is not None and len(set(cards)) != len(cards):
        failures.append("{}: ranks share cards {}".format(name, cards))
    if len({r["params_sha256"] for r in ranks}) != 1:
        failures.append("{}: the ranks' parameters differ".format(name))
    if any(r["params_sha256"] == r["initial_params_sha256"] for r in ranks):
        failures.append("{}: no step changed the parameters".format(name))


def leg_resnet(work, platform, size):
    s = SIZES[size]
    steps = s["resnet_steps"]
    argv = s["resnet"] + ["--bn_impl", "pallas", "--train_steps", str(steps), "--log_steps", str(STEPS_PER_LOOP),
                          "--steps_per_loop", str(STEPS_PER_LOOP), "--platform", platform, "--deterministic"]
    ranks, metrics, wall = _run("resnet_dp4", "tensorflowonspark_tpu_torch.examples.resnet.resnet_spark", argv,
                                work, platform)
    failures = []
    _world_checks("resnet_dp4", ranks, failures)
    if len({r["buffers_sha256"] for r in ranks}) != 1:
        failures.append("resnet_dp4: the ranks' BN statistics differ")
    calls = _calls(metrics, "chief:0")
    timed = [e["dur_s"] for e in calls[1:]]
    batch = int(s["resnet"][s["resnet"].index("--batch_size") + 1])
    launches = [r["launches"] for r in ranks]
    if platform == "gpu" and any(min(n[k] for k in ("bn_stats", "bn_bwd_reduce", "bn_finish")) == 0
                                 for n in launches):
        failures.append("resnet_dp4: a BN reduction or its split finish never launched: {}".format(launches))
    line = {"leg": "resnet_dp4", "platform": platform, "size": size, "world": WORLD, "batch_per_card": batch,
            "steps": steps, "steps_per_loop": STEPS_PER_LOOP, "cards": [_card_of(r) for r in ranks],
            "losses": [e.get("loss") for e in calls],
            "images_per_sec_per_card_after_first_call": batch * STEPS_PER_LOOP * len(timed) / sum(timed)
            if timed else None,
            "call_s": [e["dur_s"] for e in calls], "launches_by_rank": launches,
            "params_equal_on_every_rank": len({r["params_sha256"] for r in ranks}) == 1,
            "bn_statistics_equal_on_every_rank": len({r["buffers_sha256"] for r in ranks}) == 1,
            "wall_s": wall, "failures": failures}
    emit(line)
    return failures


def _card_of(r):
    return {"executor": r["executor_id"], "rank": r["rank"], "card": r["card"], "device": r["device"]}


def leg_lm(work, platform, size, data_dir, mesh):
    s = SIZES[size]
    name = "lm_" + mesh.replace("=", "").replace(",", "_")
    axes = dict((k, int(v)) for k, v in (p.split("=") for p in mesh.split(",")))
    steps, cfg = s["lm_steps"], s["lm"]
    argv = ["--vocab_size", str(cfg["vocab_size"]), "--d_model", str(cfg["d_model"]), "--n_layers",
            str(cfg["n_layers"]), "--n_heads", str(cfg["n_heads"]), "--d_ff", str(cfg["d_ff"]),
            "--seq_len", str(s["seq"]), "--batch_size", str(LM_ROWS // axes["dp"]), "--dtype", "bfloat16",
            "--tokenizer", "byte", "--train_steps", str(steps), "--log_steps", str(STEPS_PER_LOOP),
            "--steps_per_loop", str(STEPS_PER_LOOP), "--mesh", mesh, "--platform", platform,
            "--data_dir", data_dir]
    ranks, metrics, wall = _run(name, "tensorflowonspark_tpu_torch.examples.transformer.transformer_spark",
                                argv, work, platform)
    failures = []
    _world_checks(name, ranks, failures)
    nodes = ["chief:0"] + ["worker:{}".format(i) for i in range(WORLD - 1)]
    losses = {node: [e.get("loss") for e in _calls(metrics, node)] for node in nodes}
    if len({json.dumps(v) for v in losses.values()}) != 1 or not losses["chief:0"]:
        failures.append("{}: the ranks logged other losses: {}".format(name, losses))
    calls = _calls(metrics, "chief:0")
    timed = [e["dur_s"] for e in calls[1:]]
    launches = [r["launches"] for r in ranks]
    if platform == "gpu" and any(min(n[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")) == 0
                                 for n in launches):
        failures.append("{}: a flash kernel never launched: {}".format(name, launches))
    emit({"leg": name, "platform": platform, "size": size, "world": WORLD, "mesh": axes, "rows": LM_ROWS,
          "seq": s["seq"], "width": cfg, "steps": steps, "steps_per_loop": STEPS_PER_LOOP,
          "cards": [_card_of(r) for r in ranks], "losses_by_rank": losses,
          "captured_step_ms_after_first_call": 1e3 * sum(timed) / (STEPS_PER_LOOP * len(timed)) if timed else None,
          "tokens_per_sec_after_first_call": LM_ROWS * s["seq"] * STEPS_PER_LOOP * len(timed) / sum(timed)
          if timed else None,
          "call_s": [e["dur_s"] for e in calls], "launches_by_rank": launches,
          "gathered_params_equal_on_every_rank": len({r["params_sha256"] for r in ranks}) == 1,
          "wall_s": wall, "failures": failures})
    return failures


# -- InputMode.SPARK across executors -------------------------------------------


def mnist_leg_fun(args, ctx):
    """``mnist_spark.main_fun`` on ``args``, then this rank's record into
    ``args.check_dir``: its executor → card, its trainer's pid and the
    seconds of its first step (the call and its loss on the host: the
    world's first collective). With ``args.tear_dir`` the trainer first
    makes :func:`tear_saves` there."""
    from tensorflowonspark_tpu_torch.examples.mnist import mnist_spark
    from tensorflowonspark_tpu_torch.train import strategy as strategy_mod

    if args.tear_dir:
        tear_saves(args.tear_dir, args.batch_size, ctx.device)
    first = {}
    compile_step = strategy_mod.SyncDataParallel.compile_train_step

    def timing(self, *a, **kw):
        step = compile_step(self, *a, **kw)

        def timed_step(state, batch):
            if first:
                return step(state, batch)
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            float(metrics["loss"])  # waits for the device
            first["first_step_s"] = time.perf_counter() - t0
            return state, metrics

        return timed_step

    strategy_mod.SyncDataParallel.compile_train_step = timing
    try:
        mnist_spark.main_fun(args, ctx)
    finally:
        strategy_mod.SyncDataParallel.compile_train_step = compile_step
    with open(os.path.join(args.check_dir, "rank_{}.json".format(ctx.process_id)), "w") as f:
        json.dump(dict(_card(ctx, ctx.device), pid=os.getpid(), **first), f)


def mnist_partitions(rows, epochs, executors):
    """An RDD's partitions for ``epochs`` epochs of ``rows``: each epoch
    cut into ``MNIST_PARTS``' sizes, with the executor each is pinned to
    (``MNIST_PINS`` modulo ``executors``)."""
    unit, bounds = len(rows) // sum(MNIST_PARTS), [0]
    for part in MNIST_PARTS:
        bounds.append(bounds[-1] + part * unit)
    parts = [rows[a:b] for a, b in zip(bounds, bounds[1:])]
    return parts * epochs, [pin % executors for pin in MNIST_PINS] * epochs


def pinned_rdd(sc, parts, pins):
    """An RDD of :func:`mnist_partitions`' ``parts``, as cut, partition i
    pinned to executor ``pins[i]``."""
    rdd = sc.parallelize([r for part in parts for r in part], len(parts), pin_to_executors=pins)
    rdd._parts = [(part, ()) for part in parts]  # the uneven partitions, as cut
    return rdd


def _still_running(pids, timeout=10.0):
    """Those of ``pids`` still running after ``timeout`` seconds."""
    from tensorflowonspark_tpu_torch import resilience

    alive = list(pids)
    for _ in resilience.Backoff(base=0.1, factor=1.0, jitter=0.0).attempts(resilience.Deadline(timeout)):
        alive = [pid for pid in alive if _running(pid)]
        if not alive:
            break
    return alive


def _running(pid):
    """Whether ``pid`` runs (a zombie waiting for its reaper does not)."""
    try:
        with open("/proc/{}/stat".format(pid)) as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def mnist_one_executor(platform, rows, batch):
    """``chip_smoke.py``'s ``slice_mnist`` configuration: ``mnist_spark.main``
    on one executor, one epoch of ``rows`` rows in 8 even partitions.
    Returns its ``mnist_train`` span and the epoch's seconds."""
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.examples.mnist import mnist_spark

    sc = LocalSparkContext(num_executors=1)
    try:
        out = mnist_spark.main(["--cluster_size", "1", "--epochs", "1", "--num_examples", str(rows),
                                "--batch_size", str(batch), "--num_partitions", "8", "--log_steps", "1000",
                                "--platform", platform], sc=sc)
    finally:
        sc.stop()
    (span,) = [e for e in out["metrics"]["events"] if e.get("span") == "mnist_train"]
    return span, out["train_s"]


def chaos_plan(tear=False):
    """The JAX package's cluster chaos plan (``MNIST_CHAOS``); with
    ``tear``, also ``ckpt.commit_tear`` at ``TEAR_PROBABILITY`` once, under
    a seed that tears the second commit (the other sites fire at
    probability 1 under any seed)."""
    from tensorflowonspark_tpu_torch import chaos

    if not tear:
        plan = chaos.ChaosPlan(seed=7)
    else:
        plan = chaos.ChaosPlan(seed=seed_firing_on_nth("ckpt.commit_tear", 2, TEAR_PROBABILITY)).site(
            "ckpt.commit_tear", probability=TEAR_PROBABILITY, max_count=1)
    for site, spec in MNIST_CHAOS:
        plan = plan.site(site, **spec)
    return plan


def mnist_spark_story(work, name, executors, rows, epochs, batch, platform, tear=False):
    """``mnist_spark.main_fun`` (through :func:`mnist_leg_fun`) on
    ``executors`` executors in InputMode.SPARK under :func:`chaos_plan`,
    fed ``epochs`` epochs of ``rows`` synthetic rows in the uneven pinned
    partitions of :func:`mnist_partitions`, batch ``batch`` a rank. With
    ``tear`` (one executor) the trainer first makes :func:`tear_saves`
    under a ``ckpt.commit_tear`` site seeded to tear the second commit, and
    the driver then resumes from them (:func:`tear_result`). Returns a dict:
    ``ranks`` (the rank records), ``spans`` (the ``mnist_train`` spans by
    rank), ``counters`` (the trainers' merged counters), ``faults`` (the
    chaos counters merged with the driver's), ``steps``
    (``steps_per_worker``'s), ``parts``, ``pins``, ``train_s`` (the feed,
    end to end), ``shutdown_s``, ``left`` (trainers still running after the
    shutdown), ``wall_s``, ``hidden`` and ``tear`` (None without one)."""
    from tensorflowonspark_tpu_torch import TFCluster, chaos, util
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.examples.mnist import mnist_spark
    from tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup import synthetic_mnist, to_rows
    from tensorflowonspark_tpu_torch.train import steps_per_worker

    check_dir = os.path.join(work, name)
    os.makedirs(check_dir, exist_ok=True)
    for old in glob.glob(os.path.join(check_dir, "rank_*.json")):
        os.remove(old)
    args = mnist_spark.build_parser().parse_args([
        "--cluster_size", str(executors), "--epochs", str(epochs), "--num_examples", str(rows),
        "--batch_size", str(batch), "--log_steps", "1000", "--platform", platform])
    args.check_dir = check_dir
    args.tear_dir = os.path.join(work, name + "_tear") if tear else None
    if tear:
        shutil.rmtree(args.tear_dir, ignore_errors=True)
    parts, pins = mnist_partitions(to_rows(*synthetic_mnist(rows)), epochs, executors)
    t0 = time.perf_counter()
    sc = LocalSparkContext(num_executors=executors)
    chaos.install(chaos_plan(tear))  # the trainers inherit it through the env lane
    try:
        cluster = TFCluster.run(sc, mnist_leg_fun, args, executors, input_mode=TFCluster.InputMode.SPARK,
                                master_node="chief", env={util.ENV_PLATFORM: platform})
        try:
            rdd = pinned_rdd(sc, parts, pins)
            t1 = time.perf_counter()
            cluster.train(rdd, num_epochs=1)  # the epochs are the RDD's own partitions
            train_s = time.perf_counter() - t1
            metrics = mnist_spark.await_trainers(cluster)
            merged = cluster.metrics()  # with the driver's registry: the dropped registration
        finally:
            t2 = time.perf_counter()
            cluster.shutdown(grace_secs=5, timeout=SHUTDOWN_S)
            shutdown_s = time.perf_counter() - t2
    finally:
        chaos.uninstall()
        sc.stop()
    ranks = _ranks(check_dir)
    counters = {k: v["value"] for k, v in metrics["counters"].items()}
    return dict(ranks=ranks, spans=sorted((e for e in metrics["events"] if e.get("span") == "mnist_train"),
                                          key=lambda e: e["rank"]),
                counters=counters, tear=tear_result(args.tear_dir, platform, counters) if tear else None,
                faults={k: merged["counters"].get(k, {}).get("value", 0) for k in (
                    "chaos_fault_reservation_reg_drop_total", "chaos_fault_feed_slow_consumer_total",
                    "chaos_faults_injected_total")},
                steps=steps_per_worker(rows * epochs, batch, executors), parts=parts, pins=pins, train_s=train_s,
                shutdown_s=shutdown_s, left=_still_running([r["pid"] for r in ranks]),
                wall_s=time.perf_counter() - t0, hidden=args.hidden)


def mnist_story_failures(name, story, executors, batch, platform):
    """The checks on :func:`mnist_spark_story`'s run: a record and a span
    of every rank, executor e on card e (``cuda:e``), ``steps_per_worker``'s
    steps on every rank, the same parameter bytes and last loss on every
    rank, falling losses, the rows trained and fed, the plan's faults (one
    dropped registration, two slow dequeues a trainer) and a clean
    shutdown."""
    ranks, spans, counters, faults, steps = (story[k] for k in ("ranks", "spans", "counters", "faults", "steps"))
    failures = []
    if len(ranks) != executors or sorted(r["rank"] for r in ranks) != list(range(executors)) or \
            any(r["world"] != executors for r in ranks):
        failures.append("{}: rank records {}".format(name, [(r["rank"], r["world"]) for r in ranks]))
    if platform == "gpu" and any(r["card"] != r["executor_id"] or r["device"] != "cuda:{}".format(r["executor_id"])
                                 for r in ranks):
        failures.append("{}: executors off their cards {}".format(name, [_card_of(r) for r in ranks]))
    if platform == "gpu" and sorted(e["device"] for e in spans) != ["cuda:{}".format(i) for i in range(executors)]:
        failures.append("{}: mnist_train devices {}".format(name, [e["device"] for e in spans]))
    if len(spans) != executors or any(e["steps"] != steps for e in spans):
        failures.append("{}: steps {} (want {} on each of {} ranks)".format(
            name, [e["steps"] for e in spans], steps, executors))
    if len({e["params_sha256"] for e in spans}) != 1 or len({e["last_loss"] for e in spans}) != 1:
        failures.append("{}: the ranks' parameters or last losses differ: {}".format(
            name, [(e["params_sha256"][:12], e["last_loss"]) for e in spans]))
    if not all(math.isfinite(e["last_loss"]) and e["last_loss"] < e["first_loss"] for e in spans):
        failures.append("{}: losses {} are not finite and falling".format(
            name, [(e["first_loss"], e["last_loss"]) for e in spans]))
    trained = executors * steps * batch
    if counters.get("train_rows_total") != trained or counters.get("feed_rows_total", 0) < trained:
        failures.append("{}: rows trained {}, fed {} (want {} trained)".format(
            name, counters.get("train_rows_total"), counters.get("feed_rows_total"), trained))
    if faults["chaos_fault_reservation_reg_drop_total"] < 1 or \
            faults["chaos_fault_feed_slow_consumer_total"] < 2 * executors or \
            faults["chaos_faults_injected_total"] < 1 + 2 * executors:
        failures.append("{}: chaos counters {}".format(name, faults))
    if story["shutdown_s"] > SHUTDOWN_S or story["left"]:
        failures.append("{}: shutdown took {} s, trainers {} still running".format(
            name, story["shutdown_s"], story["left"]))
    return failures


def leg_mnist_spark(work, platform, size):
    s = SIZES[size]
    name, rows, batch = "mnist_spark_dp4", s["mnist_rows"], s["mnist_batch"]
    one_span, one_epoch_s = mnist_one_executor(platform, rows, batch)
    story = mnist_spark_story(work, name, WORLD, rows, MNIST_EPOCHS, batch, platform)
    failures = mnist_story_failures(name, story, WORLD, batch, platform)
    ranks, spans, counters = story["ranks"], story["spans"], story["counters"]
    emit({"leg": name, "platform": platform, "size": size, "world": WORLD, "model": "mnist_mlp",
          "width": [784, story["hidden"], 10], "dtype": "float32", "batch_per_rank": batch, "rows": rows,
          "epochs": MNIST_EPOCHS, "partitions": [len(p) for p in story["parts"]], "pins": story["pins"],
          "steps_per_rank": story["steps"], "cards": [_card_of(r) for r in ranks],
          "devices": [e["device"] for e in spans], "steps": [e["steps"] for e in spans],
          "params_equal_on_every_rank": len({e["params_sha256"] for e in spans}) == 1,
          "last_losses": [e["last_loss"] for e in spans], "first_losses": [e["first_loss"] for e in spans],
          "rows_trained": counters.get("train_rows_total"), "rows_fed": counters.get("feed_rows_total"),
          "feed_chunks": counters.get("feed_chunks_total"), "faults": story["faults"],
          "rows_per_sec_per_card": [e["images_per_sec"] for e in spans],
          "epoch_s": story["train_s"] / MNIST_EPOCHS, "train_s": story["train_s"],
          "trainer_s": [e["train_s"] for e in spans],
          "host_s": [{k: e[k] for k in ("feed_s", "batch_s", "step_s")} for e in spans],
          "feed_share_of_trainer_s": [e["feed_s"] / e["train_s"] for e in spans],
          "first_step_s": [r.get("first_step_s") for r in ranks],
          "world_first_step_s": max((r.get("first_step_s") or 0.0) for r in ranks) if ranks else None,
          "shutdown_s": story["shutdown_s"], "trainers_left": story["left"], "wall_s": story["wall_s"],
          "one_executor": {"rows": rows, "epochs": 1, "steps": one_span["steps"], "device": one_span["device"],
                           "rows_per_sec": one_span["images_per_sec"], "epoch_s": one_epoch_s,
                           "trainer_s": one_span["train_s"],
                           "host_s": {k: one_span[k] for k in ("feed_s", "batch_s", "step_s")}},
          "failures": failures})
    return failures


# -- a commit torn in a trainer child ------------------------------------------

#: the tear's firing probability; the seed is searched so that it fires on
#: the second commit (``tests/test_ckpt_chaos.py``'s cluster case)
TEAR_PROBABILITY = 0.5


def seed_firing_on_nth(site, n, probability):
    """A plan seed whose RNG for ``site`` stays quiet for the first ``n - 1``
    arrivals and fires on the n-th (the stream ``ChaosPlan`` rolls)."""
    import random

    for seed in range(10000):
        rng = random.Random("{}:{}".format(seed, site))
        draws = [rng.random() for _ in range(n)]
        if all(d >= probability for d in draws[:-1]) and draws[-1] < probability:
            return seed
    raise ValueError("no seed fires {} on arrival {}".format(site, n))


def mnist_state(device):
    """The MNIST example's trainer pieces on ``device``: its MLP (weights
    from seed 0), Adam 1e-3 through ``SyncDataParallel``; returns
    ``(strategy, state, step)``."""
    import torch

    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

    strategy = SyncDataParallel(device)
    model = mnist.create_model("mlp")
    optimizer = optim.adam(1e-3)
    state = strategy.create_state(mnist.make_init_fn(model), optimizer, torch.Generator().manual_seed(0))
    return strategy, state, strategy.compile_train_step(mnist.make_loss_fn(model), optimizer, has_aux=True)


def _saved_tensors(state):
    """The parameters and optimizer state a checkpoint of ``state`` holds,
    flat, on the host."""
    from tensorflowonspark_tpu_torch.train import checkpoint

    tree = checkpoint._to_saveable(state)
    return {k: v.detach().cpu() for k, v in _flat({k: tree[k] for k in ("params", "opt_state")}).items()
            if hasattr(v, "detach")}


def tear_saves(root, batch_size, device):
    """In the trainer child, on ``device``: two Adam steps of the MNIST MLP
    on one batch, each saved under ``root/model`` through the async engine
    (under the story's plan the second commit tears); the tensors of step 1
    are kept in ``root/step1.pt`` for the driver's bitwise check and the
    device's name in ``root/device.txt``."""
    import torch

    from tensorflowonspark_tpu_torch import chaos, ckpt
    from tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup import synthetic_mnist

    if not chaos.active:
        raise RuntimeError("the chaos plan did not reach the trainer child")
    strategy, state, step = mnist_state(device)
    images, labels = synthetic_mnist(batch_size)
    batch = strategy.shard_batch({"image": images, "label": labels})
    with ckpt.AsyncCheckpointEngine(os.path.join(root, "model")) as eng:
        for i in (1, 2):
            state, metrics = step(state, batch)
            float(metrics["loss"])
            eng.save(state, i)
            if not eng.drain(timeout=120):
                raise TimeoutError("the save of step {} did not drain".format(i))
            if i == 1:
                torch.save(_saved_tensors(state), os.path.join(root, "step1.pt"))
    with open(os.path.join(root, "device.txt"), "w") as f:
        f.write(str(device))


def tear_result(root, platform, counters):
    """The driver's resume after :func:`tear_saves` (the JAX package's
    ``TestClusterCommitTear``): ``restore_latest`` onto ``platform``'s device
    (``cuda:0`` or the CPU). Returns the trainer's device, the tear and
    commit counters, the model directory's entries, the restored checkpoint
    and step, and the restored tensors that differ from step 1's."""
    import torch

    from tensorflowonspark_tpu_torch.train import checkpoint

    model_dir = os.path.join(root, "model")
    _, state, _ = mnist_state(torch.device("cuda:0" if platform == "gpu" else "cpu"))
    _, path = checkpoint.restore_latest(model_dir, target=state)
    want = torch.load(os.path.join(root, "step1.pt"), map_location="cpu")
    got = _saved_tensors(state)
    with open(os.path.join(root, "device.txt")) as f:
        trainer_device = f.read()
    return {"trainer_device": trainer_device, "tears": counters.get("chaos_fault_ckpt_commit_tear_total", 0),
            "commits": counters.get("ckpt_commits_total", 0), "ckpt_bytes": counters.get("ckpt_bytes_total", 0),
            "entries": sorted(os.listdir(model_dir)), "restored": os.path.basename(path) if path else None,
            "restored_step": state.step, "restored_device": str(next(iter(state.params.values())).device),
            "restored_tensors": len(want),
            "mismatches": sorted(k for k in want if k not in got or not torch.equal(got[k], want[k]))}


def tear_failures(name, tear, platform):
    """The reference's checks on :func:`tear_result`: the tear and a commit
    counted, ``tmp.ckpt_2`` left unpublished, ``ckpt_1`` restored at step 1,
    bitwise step 1's tensors; on the card the trainer and the restore on
    ``cuda:0``."""
    failures = []
    if tear["tears"] < 1 or tear["commits"] < 1 or tear["ckpt_bytes"] <= 0:
        failures.append("{}: tears {}, commits {}, bytes {}".format(name, tear["tears"], tear["commits"],
                                                                 tear["ckpt_bytes"]))
    if "tmp.ckpt_2" not in tear["entries"] or "ckpt_2" in tear["entries"]:
        failures.append("{}: the torn commit was published: {}".format(name, tear["entries"]))
    if tear["restored"] != "ckpt_1" or tear["restored_step"] != 1:
        failures.append("{}: restored {} at step {} (want ckpt_1, 1)".format(name, tear["restored"],
                                                                           tear["restored_step"]))
    if tear["mismatches"] or not tear["restored_tensors"]:
        failures.append("{}: the restore differs from step 1 in {}".format(
            name, tear["mismatches"] or "every tensor (none saved)"))
    if platform == "gpu" and (tear["trainer_device"] != "cuda:0" or tear["restored_device"] != "cuda:0"):
        failures.append("{}: trainer on {}, restored onto {}".format(name, tear["trainer_device"],
                                                                   tear["restored_device"]))
    return failures


# -- the recovery ladder across executors -------------------------------------

#: the ladder's files under its root: the latch that holds the kill back, the
#: marker the arm thread leaves once it released it, and the trainers' flight
#: shards
KILL_LATCH, KILL_FIRED, TRACE = "kill.latch", "kill.fired", "trace"
#: how long the driver waits for the arm thread once the ladder is over, and
#: a paused shrunk life for the driver's drain
ARM_JOIN_S, SHRUNK_WAIT_S = 30.0, 900.0
#: the driver's counters the ladder moves, read as this run's deltas
LADDER_COUNTERS = ("recovery_attempts_total", "recovery_shrinks_total", "recovery_regrows_total",
                   "preemptions_drained_total")


def life_record(root, ctx, device, **extra):
    """Start this trainer life's record under ``root`` (one file a process):
    its executor → card, rank, world, the cluster's size, its flight shard's
    process name and pid, and when it started; returns ``record(**kw)``,
    which adds to it and rewrites it."""
    life = dict(_card(ctx, device), size=ctx.num_workers, pid=os.getpid(), t_start=time.time(), **extra)
    path = os.path.join(root, "life_{}_{}.json".format(ctx.executor_id, os.getpid()))

    def record(**kw):
        life.update(kw)
        with open(path + ".tmp", "w") as f:
            json.dump(life, f)
        os.replace(path + ".tmp", path)  # whole for a reader polling the lives

    record()
    return record


def resnet_ladder_fun(args, ctx):
    """One life of an executor of the ResNet ladder (``chip_smoke.py``'s
    ``ladder`` phase): the ResNet example's ``main_fun`` on ``args`` with the
    executor's own model directory under ``args.ladder_root``. A life below
    the full size (``args.ladder_size``) trains to ``args.ladder_pause`` and
    then waits: only the driver's regrow warning (the drain) ends it."""
    import copy

    from tensorflowonspark_tpu_torch.examples.resnet import resnet_spark

    args = copy.copy(args)
    args.model_dir = os.path.join(args.ladder_root, "executor_{}".format(ctx.executor_id))
    full = ctx.num_workers == args.ladder_size
    if not full:
        args.train_steps = args.ladder_pause
    record = life_record(args.ladder_root, ctx, ctx.device)
    resnet_spark.main_fun(args, ctx)
    record(trained_to=args.train_steps, t_end=time.time())
    if full:
        return
    from tensorflowonspark_tpu_torch import resilience

    # the drain ends this life; a life it never reaches fails here
    for _ in resilience.Backoff(base=1.0, factor=1.0, jitter=0.0).attempts(
            resilience.Deadline(SHRUNK_WAIT_S)):
        pass
    raise TimeoutError("executor {}: no drain within {} s of the shrunk life's pause".format(
        ctx.executor_id, SHRUNK_WAIT_S))


@contextlib.contextmanager
def latched_kill(root, victim, arm_dir, kill_step):
    """A latched ``node.kill`` of executor ``victim`` for the trainers of
    the local backend started inside: the latch ``root/kill.latch`` holds
    the kill back until a thread sees a checkpoint of step ``kill_step`` or
    later committed in ``arm_dir``, removes it and leaves
    ``root/kill.fired``; the victim's next heartbeat makes the latch again
    and SIGKILLs its trainer (the latch's mtime is the kill's time). Sets
    the heartbeat and monitor env (start the ``LocalSparkContext``
    inside) and the trainers' flight shards under ``root/trace``, and
    records the driver's aborts, preemption warnings and classified
    failures. Yields a dict that fills as the story runs: ``armed`` (the
    checkpoint step and the time the kill was armed), ``aborts`` (start
    and end of each driver abort), ``committed_at_abort`` (the committed
    steps in ``arm_dir`` when each abort started), ``preempts``,
    ``classified`` (time and kind of each classified failure) and, on
    exit, ``arm_wedged``."""
    from tensorflowonspark_tpu_torch import TFCluster, chaos, elastic
    from tensorflowonspark_tpu_torch.obs import flight

    latch, fired = os.path.join(root, KILL_LATCH), os.path.join(root, KILL_FIRED)
    with open(latch, "w"):
        pass  # holds the kill back until a checkpoint is committed
    moments = {"armed": {}, "aborts": [], "committed_at_abort": [], "preempts": [], "classified": []}
    done = threading.Event()

    def arm():
        while not done.wait(0.02):
            steps = _committed_steps(arm_dir)
            if steps and max(steps) >= kill_step:
                moments["armed"].update(step=max(steps), t=time.time())
                with open(fired, "w"):
                    pass  # the lives after this one are not the first
                os.remove(latch)
                return

    real = (TFCluster.TFCluster.abort, TFCluster.TFCluster.preempt, elastic.classify_failure)

    def abort(self, *a, **kw):
        t0 = time.time()
        moments["committed_at_abort"].append(sorted(_committed_steps(arm_dir)))
        try:
            return real[0](self, *a, **kw)
        finally:
            moments["aborts"].append((t0, time.time()))

    def preempt(self, *a, **kw):
        moments["preempts"].append(time.time())
        return real[1](self, *a, **kw)

    def classify(*a, **kw):
        event = real[2](*a, **kw)
        moments["classified"].append((time.time(), event.kind))
        return event

    env = {"TOS_HEARTBEAT_INTERVAL": str(HEARTBEAT_S), "TOS_MONITOR_INTERVAL": "1",
           flight.TRACE_DIR_ENV: os.path.join(root, TRACE)}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    chaos.install(chaos.ChaosPlan(seed=0).site("node.kill", probability=1.0, max_count=1, victim=victim,
                                               once_path=latch))
    TFCluster.TFCluster.abort, TFCluster.TFCluster.preempt, elastic.classify_failure = abort, preempt, classify
    watcher = threading.Thread(target=arm, name="ladder-arm", daemon=True)
    watcher.start()
    try:
        yield moments
    finally:
        done.set()
        watcher.join(timeout=ARM_JOIN_S)
        moments["arm_wedged"] = watcher.is_alive()
        chaos.uninstall()
        TFCluster.TFCluster.abort, TFCluster.TFCluster.preempt, elastic.classify_failure = real
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _life_records(root):
    records = []
    for path in glob.glob(os.path.join(root, "life_*.json")):
        with open(path) as f:
            records.append(json.load(f))
    return records


def trainer_lives(root):
    """The life records under ``root`` grouped by life, oldest first (a
    life's trainers share its coordinator, a fresh port each life), each
    life in executor order."""
    groups = {}
    for rec in _life_records(root):
        groups.setdefault(rec["coordinator"], []).append(rec)
    return [sorted(life, key=lambda r: r["executor_id"])
            for life in sorted(groups.values(), key=lambda life: min(r["t_start"] for r in life))]


def trainer_exits(root, lives):
    """The trainers' flight shards under ``root/trace`` as ``(start wall
    time, records)``, oldest first, and for each life but the last each
    trainer's way out: the reason of its last flight dump (``aborted`` for
    the abort's SIGTERM drain) or ``sigkill`` when it left none (the
    abort's SIGKILL after its grace, or the chaos kill)."""
    from tensorflowonspark_tpu_torch.obs import flight

    shards = []
    for shard in flight.list_shards(os.path.join(root, TRACE)):
        recs, _ = flight.read_shard(shard)
        meta = [r for r in recs if r.get("kind") == "meta"]
        if meta and str(meta[0].get("proc", "")).startswith("trainer-"):
            shards.append((meta[0]["wall"], recs))
    shards.sort(key=lambda shard: shard[0])
    last_dump = {}
    for _, recs in shards:
        pid = next(r.get("pid") for r in recs if r.get("kind") == "meta")
        dumps = [r for r in recs if r.get("kind") == "dump"]
        if dumps:
            last_dump[pid] = str(dumps[-1].get("reason", "")).split(":")[0]
    return shards, [{r["executor_id"]: last_dump.get(r["pid"], "sigkill") for r in life} for life in lives[:-1]]


def run_ladder_story(map_fun, args, root, executors, victim, arm_dir, kill_step, platform, jax_distributed,
                     master_node, regrow_s, task_timeout=None):
    """The story of the JAX package's ``test_preempt_drain_regrow_full_size_resume``
    through ``elastic.run_ladder`` on ``executors`` executors of the local
    backend, under :func:`latched_kill` of executor ``victim`` at a
    checkpoint of step ``kill_step`` or later in ``arm_dir``;
    ``blacklist_after=1``, so the ladder shrinks by one; the mid-run regrow
    probe (every ``regrow_s``, once the shrunk life committed a checkpoint
    past the newest at the abort) forgives the victim, the scaler votes to
    grow and the driver's preemption warning drains the shrunk world; the
    relaunch runs at full size. ``map_fun`` records each life with
    :func:`life_record` under ``root``.

    Returns :func:`latched_kill`'s moments and: ``result`` (the ladder's),
    ``lives`` (:func:`trainer_lives`), ``counters``
    (:data:`LADDER_COUNTERS`' deltas), ``exits`` and ``shards``
    (:func:`trainer_exits`) and ``wall_s``."""
    from tensorflowonspark_tpu_torch import TFCluster, control, elastic, obs, util
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext

    before = {name: obs.counter(name).value for name in LADDER_COUNTERS}
    t0 = time.time()
    poll = elastic._regrow_poll
    with latched_kill(root, victim, arm_dir, kill_step) as moments:

        def regrow_poll(*a, **kw):
            # the shrunk life must train before the regrow ends it: under a
            # loaded host its trainers can take longer to start than a
            # regrow period (the story's timing, not the ladder's rule)
            newest = max(moments["committed_at_abort"][0] or [0]) if moments["committed_at_abort"] else None
            if newest is None or max(_committed_steps(arm_dir) or [0]) <= newest:
                return False
            return poll(*a, **kw)

        elastic._regrow_poll = regrow_poll
        sc = LocalSparkContext(num_executors=executors, **({"task_timeout": task_timeout} if task_timeout else {}))
        try:
            result = elastic.run_ladder(
                sc, map_fun, args, num_executors=executors, max_relaunches=1, min_workers=1, blacklist_after=1,
                regrow=True, regrow_check_secs=regrow_s,
                scaler=control.ClusterScaler(executors, min_size=1, grow_patience=1),
                input_mode=TFCluster.InputMode.TENSORFLOW, master_node=master_node,
                env={util.ENV_PLATFORM: platform}, jax_distributed=jax_distributed, reservation_timeout=300,
                shutdown_timeout=300)
        finally:
            elastic._regrow_poll = poll
            sc.stop()
    wall = time.time() - t0
    lives = trainer_lives(root)
    shards, exits = trainer_exits(root, lives)
    return dict(result=result, lives=lives, counters={
        name: obs.counter(name).value - before[name] for name in LADDER_COUNTERS}, exits=exits, shards=shards,
        wall_s=wall, **moments)


def story_failures(name, story, executors):
    """The reference's assertions on the ladder's story: two relaunches, an
    empty blacklist at the end, sizes ``N → N−1 → N``, one shrink, one
    regrow and one drained preemption."""
    result, sizes = story["result"], [life[0]["size"] for life in story["lives"]]
    failures = []
    if result.relaunches != 2 or result.num_executors != executors or result.blacklist or \
            sizes != [executors, executors - 1, executors]:
        failures.append("{}: {} relaunches, blacklist {}, sizes {} (want 2, [], {})".format(
            name, result.relaunches, sorted(result.blacklist), sizes, [executors, executors - 1, executors]))
    if any(story["counters"][k] != 1 for k in LADDER_COUNTERS[1:]):
        failures.append("{}: counters {} (want one shrink, one regrow, one drain)".format(name, story["counters"]))
    if story["arm_wedged"]:
        failures.append("{}: the ladder-arm watcher did not stop within {} s".format(name, ARM_JOIN_S))
    return failures


def ladder_fun(args, ctx):
    """One life of the ladder's LM: ZeRO-3 on ``{"fsdp": -1}`` over the
    current world, AdamW 3e-4, each rank on its block of the step's global
    batch, an async checkpoint every ``every`` steps (collective: the
    gathers on every rank, rank 0 writes). Restores the newest checkpoint
    (``reshard_restore`` onto this world's mesh) and holds the restored
    tensors, gathered, to the checkpoint's bitwise. Trains without a stop
    condition at less than the full size (only the driver's regrow warning
    ends such a life) and in the first life (only the kill or the abort
    ends it); a later full-size life trains ``tail`` steps and saves. Each
    rank records its life under ``args["root"]``."""
    import torch

    from tensorflowonspark_tpu_torch import ckpt
    from tensorflowonspark_tpu_torch.ckpt.reshard import reshard_restore
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.parallel import sharding
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, checkpoint, optim

    t_start = time.time()
    mesh = ctx.mesh({"fsdp": -1})
    device = ctx.device
    strategy = SyncDataParallel(mesh, fsdp=True)
    model = transformer.create_model(max_seq_len=args["seq"], dtype="bfloat16", **args["lm"])
    optimizer = optim.adamw(3e-4)
    state = strategy.create_state(transformer.make_init_fn(model), optimizer, torch.Generator().manual_seed(0))
    step = strategy.compile_train_step(transformer.make_loss_fn(model), optimizer, has_aux=True)
    share, shares = sharding.data_shard(strategy.mesh, ctx.process_id)
    n = args["rows"] // shares

    def batch(i):
        rows = _lm_rows(args["rows"], args["seq"], args["lm"]["vocab_size"], i)
        return strategy.shard_batch({k: v[share * n:(share + 1) * n] for k, v in rows.items()})

    record = life_record(args["root"], ctx, device, resumed_from=0, restore_mismatches=None,
                         params_sharded=len(state.sharded.dims) if state.sharded is not None else 0)
    record(t_start=t_start)
    latest = checkpoint.latest_checkpoint(args["model_dir"])
    if latest:
        t0 = time.time()
        reshard_restore(latest, strategy=strategy, target=state)
        restore_s = time.time() - t0
        saved = checkpoint.restore_checkpoint(latest)
        got = checkpoint._to_saveable(state)  # the save path's gathers: collective
        want = _flat({k: saved[k] for k in ("params", "opt_state")})
        have = _flat({k: got[k] for k in ("params", "opt_state")})
        record(restore_s=restore_s, resumed_from=state.step, restored_path=os.path.basename(latest),
               restore_tensors=len(want),
               restore_mismatches=[k for k, v in want.items() if not torch.equal(have[k].cpu(), v)]
               + (["step"] if got["step"] != saved["step"] else []))
    full = ctx.num_workers == args["full_size"]
    first_life = not os.path.exists(os.path.join(args["root"], KILL_FIRED))
    stop = state.step + args["tail"] if full and not first_life else None
    first_step = True
    with ckpt.AsyncCheckpointEngine(args["model_dir"], keep=2) as eng:
        while stop is None or state.step < stop:
            state, metrics = step(state, batch(state.step))
            loss = float(metrics["loss"])  # waits for the device
            if first_step:
                record(t_first_step=time.time(), first_loss=loss)
                first_step = False
            if state.step % args["every"] == 0:
                eng.save(state, state.step)
        if state.step % args["every"]:
            eng.save(state, state.step)
        assert eng.drain(timeout=600)
    record(final_step=state.step, t_end=time.time())


def _lm_rows(rows, seq, vocab, step):
    """The global batch of ``step``: ``rows`` rows of ``seq + 1`` random
    tokens (seeded by the step), one segment each."""
    import numpy as np

    rng = np.random.default_rng(1000 + step)
    tokens = rng.integers(1, vocab, (rows, seq + 1)).astype(np.int32)
    return {"tokens": tokens, "segment_ids": np.ones_like(tokens),
            "positions": np.broadcast_to(np.arange(seq + 1, dtype=np.int32), tokens.shape).copy()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, "{}{}/".format(prefix, k)))
        return out
    return {prefix.rstrip("/"): tree}


def _committed_steps(model_dir):
    return [int(d[len("ckpt_"):]) for d in (os.listdir(model_dir) if os.path.isdir(model_dir) else [])
            if d.startswith("ckpt_") and d[len("ckpt_"):].isdigit()]


def leg_ladder(work, platform, size):
    s = SIZES[size]
    root = os.path.join(work, "ladder4")
    shutil.rmtree(root, ignore_errors=True)
    model_dir = os.path.join(root, "model")
    os.makedirs(model_dir)
    args = {"model_dir": model_dir, "root": root, "lm": s["lm"], "seq": s["seq"], "rows": s["ladder_rows"],
            "every": s["ladder_every"], "tail": s["ladder_tail"], "full_size": WORLD}
    story = run_ladder_story(ladder_fun, args, root, WORLD, WORLD - 1, model_dir, s["ladder_kill"], platform,
                             jax_distributed=True, master_node="chief", regrow_s=s["regrow_s"])
    result, lives, armed, aborts = story["result"], story["lives"], story["armed"], story["aborts"]
    summary = [{"world": life[0]["world"], "resumed_from": sorted({r["resumed_from"] for r in life}),
                "cards": {r["executor_id"]: r["card"] for r in life},
                "coordinator": life[0]["coordinator"],
                "restore_mismatches": sorted({m for r in life for m in (r["restore_mismatches"] or [])}),
                "restore_tensors": life[0].get("restore_tensors"),
                "restore_s": max((r.get("restore_s") or 0.0) for r in life),
                "params_sharded": life[0]["params_sharded"],
                "first_step_after_start_s": min(r["t_first_step"] for r in life if "t_first_step" in r)
                - min(r["t_start"] for r in life) if any("t_first_step" in r for r in life) else None,
                "final_step": max((r.get("final_step") or 0) for r in life) or None}
               for life in lives]
    first_steps = [min(r["t_first_step"] for r in life if "t_first_step" in r) if any(
        "t_first_step" in r for r in life) else None for life in lives]
    survivors = {e: how for e, how in (story["exits"][0] if story["exits"] else {}).items() if e != WORLD - 1}
    line = {"leg": "ladder4", "platform": platform, "size": size, "mesh": {"fsdp": -1}, "width": s["lm"],
            "seq": s["seq"], "rows": s["ladder_rows"], "checkpoint_every": s["ladder_every"],
            "kill_armed_at_checkpoint": armed.get("step"), "relaunches": result.relaunches,
            "final_world": result.num_executors, "blacklist": sorted(result.blacklist),
            "events": [e.kind for _, e in result.events], "lives": summary,
            "worlds": [life["world"] for life in summary], "counters": story["counters"],
            "survivor_exits": survivors, "exits_by_life": story["exits"],
            "abort_s": [b - a for a, b in aborts],
            "kill_armed_to_abort_start_s": aborts[0][0] - armed["t"] if aborts and armed else None,
            "abort_end_to_first_step_s": first_steps[1] - aborts[0][1] if len(first_steps) > 1 and aborts
            and first_steps[1] else None,
            "kill_armed_to_first_step_s": first_steps[1] - armed["t"] if len(first_steps) > 1 and armed
            and first_steps[1] else None,
            "wall_s": story["wall_s"]}
    failures = story_failures("ladder4", story, WORLD)
    if line["worlds"] != [WORLD, WORLD - 1, WORLD]:
        failures.append("ladder4: worlds {}".format(line["worlds"]))
    for i, life in enumerate(summary):
        if i and (life["restore_mismatches"] or not life["restore_tensors"]):
            failures.append("ladder4: life {}'s restore differs from its checkpoint in {}".format(
                i + 1, life["restore_mismatches"] or "every tensor (none restored)"))
        if i and life["resumed_from"][0] < (armed.get("step", 0) if i == 1 else summary[i - 1]["resumed_from"][0]):
            failures.append("ladder4: life {} resumed at {}".format(i + 1, life["resumed_from"]))
        if platform == "gpu" and len(set(life["cards"].values())) != len(life["cards"]):
            failures.append("ladder4: life {}'s ranks share cards {}".format(i + 1, life["cards"]))
        if platform == "gpu" and i and any(summary[0]["cards"][e] != card for e, card in life["cards"].items()):
            failures.append("ladder4: life {}'s cards {} moved from the first life's {}".format(
                i + 1, life["cards"], summary[0]["cards"]))
    if summary and summary[-1]["final_step"] is None:
        failures.append("ladder4: the last life did not finish")
    line["failures"] = failures
    emit(line)
    return failures


# -- an executor lost mid-feed, recovered through run_with_recovery(feed_fn) ------

#: the executor the recovery leg kills (not the chief's); how long its
#: ``feed_fn`` waits for a life's trainers to start (seconds)
RECOVER_VICTIM, RECOVER_START_S = 2, 300.0


def recover_leg_fun(args, ctx):
    """``mnist_spark.main_fun`` in one life of the recovery leg, recorded
    under ``args.recover_root``: the life's record (:func:`life_record`)
    with the checkpoint it restored (name, step and the sha256 of the
    restored parameters and optimizer state) and the first step's end; the
    sha256 of each checkpoint this rank saved (``saved_<step>.json``); each
    step's global step, rows trained in this life and wall time in
    ``progress_<executor>_<pid>.txt`` (one fixed-width line rewritten in
    place: a SIGKILL leaves the last step there); and once the example
    returns, the final step, the parameters' sha256 and whether every loss
    was finite."""
    import torch

    from tensorflowonspark_tpu_torch.examples.mnist import mnist_spark
    from tensorflowonspark_tpu_torch.train import checkpoint
    from tensorflowonspark_tpu_torch.train import strategy as strategy_mod

    root = args.recover_root
    record = life_record(root, ctx, ctx.device)
    progress = os.open(os.path.join(root, "progress_{}_{}.txt".format(ctx.executor_id, os.getpid())),
                       os.O_CREAT | os.O_WRONLY, 0o644)
    seen = {"rows": 0, "state": None}
    losses = []
    real = (checkpoint.restore_latest, checkpoint.save_checkpoint, strategy_mod.SyncDataParallel.compile_train_step)

    def restore_latest(model_dir, *a, **kw):
        state, path = real[0](model_dir, *a, **kw)
        if path:
            record(restored=os.path.basename(path), restored_step=state.step,
                   restored_sha256=_digest(_saved_tensors(state)))
        return state, path

    def save_checkpoint(path, state, *a, **kw):
        out = real[1](path, state, *a, **kw)
        with open(os.path.join(root, "saved_{}.json".format(state.step)), "w") as f:
            json.dump({"step": state.step, "executor_id": ctx.executor_id,
                       "sha256": _digest(_saved_tensors(state))}, f)
        return out

    def compile_train_step(self, *a, **kw):
        step = real[2](self, *a, **kw)

        def recorded(state, batch):
            state, metrics = step(state, batch)
            seen["state"] = state
            seen["rows"] += len(batch["label"])
            losses.append(metrics["loss"])
            if len(losses) == 1:
                float(metrics["loss"])  # waits for the device
                record(t_first_step=time.time(), first_step=state.step)
            os.pwrite(progress, "{:10d} {:10d} {:20.6f}\n".format(state.step, seen["rows"], time.time()).encode(),
                      0)
            return state, metrics

        return recorded

    checkpoint.restore_latest, checkpoint.save_checkpoint = restore_latest, save_checkpoint
    strategy_mod.SyncDataParallel.compile_train_step = compile_train_step
    try:
        mnist_spark.main_fun(args, ctx)
    finally:
        checkpoint.restore_latest, checkpoint.save_checkpoint = real[:2]
        strategy_mod.SyncDataParallel.compile_train_step = real[2]
        os.close(progress)
    state = seen["state"]
    record(final_step=state.step if state else None, rows_trained=seen["rows"],
           params_sha256=_digest(dict(state.params)) if state else None,
           losses_finite=bool(torch.isfinite(torch.stack(losses)).all()) if losses else None, t_end=time.time())


def _progress(root):
    """``{pid: (step, rows, wall time)}`` of every trainer's last step."""
    got = {}
    for path in glob.glob(os.path.join(root, "progress_*_*.txt")):
        with open(path) as f:
            fields = f.read().split()
        if fields:
            got[int(path.rsplit("_", 1)[1].split(".")[0])] = (int(fields[0]), int(fields[1]), float(fields[2]))
    return got


def mnist_recover_story(work, name, executors, rows, epochs, batch, every, platform, feed_timeout, victim):
    """The JAX package's ``test_spark_feed_killed_node_training_finishes_anyway``
    on ``mnist_spark.main_fun`` (through :func:`recover_leg_fun`):
    ``executors`` executors in one world in InputMode.SPARK, rank 0 saving
    every ``every`` steps into a shared model directory and training
    ``steps_per_worker``'s steps for ``epochs`` epochs of ``rows`` rows,
    fed by the reference's ``feed_fn``: once the attempt's trainers have
    started, waves of ``cluster.train(rdd, num_epochs=1,
    feed_timeout=feed_timeout)``, each one epoch in
    :func:`mnist_partitions`' pinned partitions, until every rank of the
    attempt reports done, ``cluster.check_errors()`` between waves,
    through ``TFCluster.run_with_recovery`` with two relaunches at most,
    under :func:`latched_kill` of executor ``victim`` at the first
    committed checkpoint. Returns :func:`latched_kill`'s moments and:
    ``relaunches``, ``attempts`` (each ``feed_fn`` call: start, end, the
    seconds it waited for its trainers, waves,
    the error it raised, when ``tf_status`` first held an error, the
    rows its waves fed (the executors' ``feed_rows_total`` from its start
    to its end), each finished wave's seconds), ``lives``
    (:func:`trainer_lives`), ``progress`` (:func:`_progress`), ``exits``,
    ``saved`` (the checkpoints' save-time sha256 by step), ``entries`` and
    ``unverified`` (the model directory's entries, and its published
    checkpoints that fail their manifest), ``kill_t`` (the latch's mtime),
    ``steps`` (``steps_per_worker``'s), ``parts``, ``pins``, ``hidden``
    and ``wall_s``."""
    from tensorflowonspark_tpu_torch import TFCluster, ckpt, resilience, util
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.examples.mnist import mnist_spark
    from tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup import synthetic_mnist, to_rows
    from tensorflowonspark_tpu_torch.train import steps_per_worker

    root = os.path.join(os.path.abspath(work), name)  # executors run in directories of their own
    shutil.rmtree(root, ignore_errors=True)
    model_dir = os.path.join(root, "model")
    os.makedirs(model_dir)
    args = mnist_spark.build_parser().parse_args([
        "--cluster_size", str(executors), "--epochs", str(epochs), "--num_examples", str(rows),
        "--batch_size", str(batch), "--log_steps", "1000", "--platform", platform, "--model_dir", model_dir,
        "--checkpoint_steps", str(every)])
    args.recover_root = root
    parts, pins = mnist_partitions(to_rows(*synthetic_mnist(rows)), 1, executors)
    attempts = []

    def fed_rows(cluster):
        """The executors' ``feed_rows_total`` (their channels outlive a
        trainer life: read as a difference), or None when a channel cannot
        be read: a reading, not a check."""
        try:
            return cluster.metrics(include_driver=False)["counters"].get("feed_rows_total", {}).get("value", 0)
        except Exception:
            return None

    def all_done(since):
        return len({r["executor_id"] for r in _life_records(root) if r.get("t_end", 0) >= since}) == executors

    def await_trainers(cluster, since):
        """Wait until every rank of this life has started (its life record
        is from after ``since``), ``cluster.check_errors()`` between polls:
        the feed timeout then bounds each wave's own work, not a trainer's
        start-up. Returns the seconds waited."""
        t = time.time()
        for _ in resilience.Backoff(base=0.05, factor=1.0, jitter=0.0).attempts(resilience.Deadline(RECOVER_START_S)):
            cluster.check_errors()
            if len({r["executor_id"] for r in _life_records(root) if r["t_start"] >= since}) == executors:
                return time.time() - t
        raise TimeoutError("{}: the trainers did not start within {} s".format(name, RECOVER_START_S))

    def feed_fn(cluster):
        since = attempts[-1]["t_end"] if attempts else 0.0  # life records of this attempt's trainers
        attempt = {"t_start": time.time(), "waves": 0, "wave_s": [], "error": None, "error_seen": None,
                   "rows_fed_before": fed_rows(cluster)}
        attempts.append(attempt)
        stop = threading.Event()

        def watch():  # the driver's first error on this attempt: the watchdog's or a node's
            while not stop.wait(0.05):
                if cluster.tf_status.get("error"):
                    attempt["error_seen"] = time.time()
                    return

        watcher = threading.Thread(target=watch, name="recover-watch", daemon=True)
        watcher.start()
        try:
            attempt["start_wait_s"] = await_trainers(cluster, since)
            while not all_done(attempt["t_start"]):
                cluster.check_errors()
                rdd = pinned_rdd(cluster.sc, parts, pins)
                attempt["waves"] += 1
                t_wave = time.time()
                cluster.train(rdd, num_epochs=1, feed_timeout=feed_timeout)
                attempt["wave_s"].append(time.time() - t_wave)
        except Exception as e:
            attempt["error"] = "{}: {}".format(type(e).__name__, (str(e).splitlines() or [""])[0])
            raise
        finally:
            attempt["t_end"] = time.time()
            stop.set()
            watcher.join(timeout=5)
            fed = fed_rows(cluster)
            attempt["rows_fed"] = fed - attempt["rows_fed_before"] if None not in (fed, attempt["rows_fed_before"]) \
                else None

    t0 = time.time()
    with latched_kill(root, victim, model_dir, every) as moments:
        sc = LocalSparkContext(num_executors=executors)
        try:
            relaunches = TFCluster.run_with_recovery(
                sc, recover_leg_fun, args, executors, max_relaunches=2, feed_fn=feed_fn,
                input_mode=TFCluster.InputMode.SPARK, master_node="chief", env={util.ENV_PLATFORM: platform},
                reservation_timeout=300, shutdown_timeout=300)
        finally:
            sc.stop()
    wall = time.time() - t0
    lives = trainer_lives(root)
    _, exits = trainer_exits(root, lives)
    saved = {}
    for path in glob.glob(os.path.join(root, "saved_*.json")):
        with open(path) as f:
            rec = json.load(f)
        saved[rec["step"]] = rec["sha256"]
    entries = sorted(os.listdir(model_dir))
    latch = os.path.join(root, KILL_LATCH)
    return dict(relaunches=relaunches, attempts=attempts, lives=lives, progress=_progress(root), exits=exits,
                saved=saved, entries=entries,
                unverified=[e for e in entries if e.startswith("ckpt_")
                            and not ckpt.verify(os.path.join(model_dir, e))[0]],
                kill_t=os.stat(latch).st_mtime if os.path.exists(latch) else None,
                steps=steps_per_worker(rows * epochs, batch, executors), parts=parts, pins=pins,
                hidden=args.hidden, wall_s=wall, **moments)


def recover_story_failures(name, story, executors, victim, every, platform):
    """The reference's assertions on :func:`mnist_recover_story` (one
    relaunch, ``feed_fn`` run twice, every rank at the step target) and the
    leg's own: two lives at the full world with executor e on ``cuda:e``;
    the kill landed while the victim still had steps to train; every rank
    of the second life restored the newest checkpoint committed when the
    abort started, of step ``every`` or later, bitwise the tensors rank 0
    saved, and every published checkpoint verifies; equal parameters and
    finite losses on every rank; no trainer left; each survivor's way out
    recorded."""
    lives, steps, progress = story["lives"], story["steps"], story["progress"]
    failures = []
    if story["relaunches"] != 1 or len(story["attempts"]) != 2:
        failures.append("{}: {} relaunches, feed_fn ran {} times (want 1, 2)".format(
            name, story["relaunches"], len(story["attempts"])))
    if len(lives) != 2 or any(sorted(r["executor_id"] for r in life) != list(range(executors))
                              or any(r["world"] != executors for r in life) for life in lives):
        failures.append("{}: lives {}".format(name, [[(r["executor_id"], r["world"]) for r in life]
                                                      for life in lives]))
        return failures
    if platform == "gpu" and any(r["card"] != r["executor_id"] or r["device"] != "cuda:{}".format(r["executor_id"])
                                 for life in lives for r in life):
        failures.append("{}: executors off their cards {}".format(
            name, [[(r["executor_id"], r["device"]) for r in life] for life in lives]))
    (victim_life1,) = [r for r in lives[0] if r["executor_id"] == victim]
    victim_step = progress.get(victim_life1["pid"], (0,))[0]
    if story["kill_t"] is None or not story["armed"] or not 0 < victim_step < steps:
        failures.append("{}: the kill (armed {}, at {}) did not land mid-feed: the victim's first life ended at "
                        "step {} of {}".format(name, story["armed"], story["kill_t"], victim_step, steps))
    second = lives[1]
    want = max(story["committed_at_abort"][0]) if story["committed_at_abort"] and \
        story["committed_at_abort"][0] else None
    restored = {(r.get("restored"), r.get("restored_step"), r.get("restored_sha256")) for r in second}
    if want is None or want < every or restored != {("ckpt_{}".format(want), want, story["saved"].get(want))}:
        failures.append("{}: the second life restored {} (want ckpt_{} of step >= {}, saved {})".format(
            name, sorted(restored, key=str), want, every, story["saved"].get(want)))
    if story["unverified"]:
        failures.append("{}: published checkpoints fail their manifest: {}".format(name, story["unverified"]))
    if any(r.get("final_step") != steps for r in second):
        failures.append("{}: final steps {} (want {})".format(name, [r.get("final_step") for r in second], steps))
    if len({r.get("params_sha256") for r in second}) != 1 or not all(r.get("losses_finite") for r in second):
        failures.append("{}: parameters {}, losses finite {}".format(
            name, [(r.get("params_sha256") or "")[:12] for r in second], [r.get("losses_finite") for r in second]))
    left = _still_running([r["pid"] for life in lives for r in life])
    if left:
        failures.append("{}: trainers {} still running".format(name, left))
    survivors = {e: how for e, how in (story["exits"][0] if story["exits"] else {}).items() if e != victim}
    if sorted(survivors) != sorted(set(range(executors)) - {victim}):
        failures.append("{}: survivors' exits {}".format(name, survivors))
    if story["arm_wedged"]:
        failures.append("{}: the ladder-arm watcher did not stop within {} s".format(name, ARM_JOIN_S))
    return failures


def cards_smi():
    """``nvidia-smi``'s name and power limit of each card, a line each."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()


def leg_mnist_spark_recover(work, platform, size):
    s = SIZES[size]
    name, rows, batch, every = "mnist_spark_recover4", s["recover_rows"], s["mnist_batch"], s["recover_every"]
    story = mnist_recover_story(work, name, WORLD, rows, MNIST_EPOCHS, batch, every, platform,
                                s["recover_feed_timeout"], RECOVER_VICTIM)
    failures = recover_story_failures(name, story, WORLD, RECOVER_VICTIM, every, platform)
    lives, progress, attempts, kill_t = story["lives"], story["progress"], story["attempts"], story["kill_t"]
    aborts, classified = story["aborts"], story["classified"]

    def since(t, t0):
        return t - t0 if t is not None and t0 is not None else None

    second = lives[1] if len(lives) > 1 else []
    first_steps = [r["t_first_step"] for r in second if "t_first_step" in r]
    last_steps = [progress[r["pid"]][2] for r in second if r["pid"] in progress]
    # the driver's first word of the loss: tf_status (the watchdog or a
    # node's error), the feed's own error, or the ladder's classification
    driver_errors = [t for t, _ in classified[:1]]
    if attempts:
        driver_errors += [t for t in (attempts[0]["error_seen"], attempts[0]["error"] and attempts[0]["t_end"])
                          if t]
    life2_rate = []
    for r in second:
        if r["pid"] in progress and "t_first_step" in r and progress[r["pid"]][2] > r["t_first_step"]:
            life2_rate.append((r["rows_trained"] - batch) / (progress[r["pid"]][2] - r["t_first_step"]))
    emit({"leg": name, "platform": platform, "size": size, "world": WORLD, "cards_smi": cards_smi()
          if platform == "gpu" else None, "model": "mnist_mlp", "width": [784, story["hidden"], 10],
          "dtype": "float32", "batch_per_rank": batch, "rows": rows, "epochs": MNIST_EPOCHS,
          "partitions": [len(p) for p in story["parts"]], "pins": story["pins"], "steps_per_rank": story["steps"],
          "checkpoint_every": every, "feed_timeout_s": s["recover_feed_timeout"], "victim": RECOVER_VICTIM,
          "relaunches": story["relaunches"], "feed_fn_calls": len(attempts),
          "attempts": [{k: a.get(k) for k in ("start_wait_s", "waves", "wave_s", "error", "rows_fed")}
                       for a in attempts],
          "lives": [{"world": life[0]["world"], "cards": {r["executor_id"]: r["device"] for r in life},
                     "restored": sorted({str(r.get("restored")) for r in life}),
                     "restored_step": sorted({r.get("restored_step") or 0 for r in life}),
                     "steps_reached": {r["executor_id"]: progress.get(r["pid"], (None,))[0] for r in life},
                     "rows_trained": {r["executor_id"]: progress.get(r["pid"], (0, None))[1] for r in life},
                     "final_step": [r.get("final_step") for r in life]} for life in lives],
          "kill_armed_at_checkpoint": story["armed"].get("step"),
          "committed_at_abort": story["committed_at_abort"][:1], "saved_steps": sorted(story["saved"]),
          "entries": story["entries"],
          "params_equal_on_every_rank": len({r.get("params_sha256") for r in second}) == 1 if second else None,
          "survivor_exits": {e: how for e, how in (story["exits"][0] if story["exits"] else {}).items()
                             if e != RECOVER_VICTIM},
          "classified": [kind for _, kind in classified],
          "kill_to_driver_first_error_s": since(min(driver_errors) if driver_errors else None, kill_t),
          "kill_to_feed_fn_first_return_s": since(attempts[0]["t_end"] if attempts else None, kill_t),
          "abort_s": [b - a for a, b in aborts],
          "abort_end_to_second_life_start_s": since(min(r["t_start"] for r in second) if second else None,
                                                    aborts[0][1] if aborts else None),
          "abort_end_to_first_step_s": since(min(first_steps) if first_steps else None,
                                             aborts[0][1] if aborts else None),
          "kill_to_last_step_s": since(max(last_steps) if last_steps else None, kill_t),
          "second_life_rows_per_sec_per_card": life2_rate, "wall_s": story["wall_s"], "failures": failures})
    return failures


# -- the reference test's own shape: two independent workers, one card -------

#: ``spark_feed_story``'s run (the reference test's): the step target, the
#: checkpoint cadence, the victim's kill step (after the step-4 checkpoint)
#: and the victim; the MLP's width
SPARK_FEED_TARGET, SPARK_FEED_EVERY, SPARK_FEED_KILL_AT, SPARK_FEED_VICTIM = 8, 2, 5, 1
SPARK_FEED_MLP = dict(hidden=16, dropout_rate=0.0)


def spark_feed_resume_or_die(args, ctx):
    """The JAX package's ``fn_spark_feed_resume_or_die`` on the port's own
    MLP init (``SPARK_FEED_MLP``, seed 0, SGD 0.1): trains one step a fed
    batch of 16 to ``SPARK_FEED_TARGET`` steps across lives, checkpointing
    every ``SPARK_FEED_EVERY`` into its executor's own directory; the victim
    SIGKILLs itself at ``SPARK_FEED_KILL_AT``, once (a marker file makes the
    second life survive). Writes ``done.json`` with the final step and the
    device."""
    import signal

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, checkpoint, optim

    model_dir = os.path.join(args["model_dir"], "worker_{}".format(ctx.executor_id))
    os.makedirs(model_dir, exist_ok=True)
    strategy = SyncDataParallel(ctx.device)
    optimizer = optim.sgd(0.1)
    model = mnist.create_model("mlp", **SPARK_FEED_MLP)
    state = strategy.create_state(mnist.make_init_fn(model), optimizer, torch.Generator().manual_seed(0))
    step = strategy.compile_train_step(mnist.make_loss_fn(model), optimizer, has_aux=True)
    latest = checkpoint.latest_checkpoint(model_dir)
    if latest:
        checkpoint.restore_checkpoint(latest, target=state)
    global_step = state.step
    marker = os.path.join(args["model_dir"], "killed.marker")
    feed = ctx.get_data_feed(train_mode=True)
    while not feed.should_stop() and global_step < SPARK_FEED_TARGET:
        rows = feed.next_batch(16)
        if not rows:
            continue
        images = np.asarray([r[0] for r in rows], np.float32).reshape(-1, 28, 28)
        labels = np.asarray([r[1] for r in rows])
        state, metrics = step(state, strategy.shard_batch({"image": images, "label": labels}))
        float(metrics["loss"])
        global_step += 1
        if global_step % SPARK_FEED_EVERY == 0:
            checkpoint.save_checkpoint(os.path.join(model_dir, "ckpt_{}".format(global_step)), state)
        if ctx.executor_id == SPARK_FEED_VICTIM and global_step == SPARK_FEED_KILL_AT and not os.path.exists(marker):
            with open(marker, "w") as f:
                f.write("first life died here")
            os.kill(os.getpid(), signal.SIGKILL)  # no traceback, no cleanup
    feed.terminate()  # drain the rest of the feed so feeders can finish
    with open(os.path.join(model_dir, "done.json"), "w") as f:
        json.dump({"final_step": global_step, "device": str(ctx.device)}, f)


def spark_feed_story(work, platform, feed_timeout):
    """The JAX package's ``test_spark_feed_killed_node_training_finishes_anyway``
    on :func:`spark_feed_resume_or_die`: two independent workers
    (``jax_distributed=False``: NCCL takes no two ranks on one card) fed
    128 rows in waves of ``cluster.train(rdd, num_epochs=1,
    feed_timeout=feed_timeout)`` until both report done, through
    ``TFCluster.run_with_recovery`` with two relaunches at most. Returns
    ``relaunches``, ``feeds`` (``feed_fn``'s calls), ``marker`` (the kill
    happened), ``done`` (each worker's final step and device),
    ``victim_ckpts`` and ``wall_s``."""
    import numpy as np

    from tensorflowonspark_tpu_torch import TFCluster, util
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext

    model_dir = os.path.join(os.path.abspath(work), "spark_feed")  # executors run in directories of their own
    shutil.rmtree(model_dir, ignore_errors=True)
    os.makedirs(model_dir)
    rng = np.random.default_rng(3)
    rows = [(rng.standard_normal(784).astype(np.float32).tolist(), int(i % 10)) for i in range(128)]
    feeds = []

    def done_path(eid):
        return os.path.join(model_dir, "worker_{}".format(eid), "done.json")

    def feed_fn(cluster):
        feeds.append(time.time())
        while not all(os.path.exists(done_path(e)) for e in (0, 1)):
            cluster.check_errors()
            cluster.train(cluster.sc.parallelize(rows, 4), num_epochs=1, feed_timeout=feed_timeout)

    t0 = time.time()
    saved_env = os.environ.get("TOS_MONITOR_INTERVAL")
    os.environ["TOS_MONITOR_INTERVAL"] = "1"
    sc = LocalSparkContext(num_executors=2, task_timeout=900)
    try:
        relaunches = TFCluster.run_with_recovery(
            sc, spark_feed_resume_or_die, {"model_dir": model_dir}, num_executors=2,
            input_mode=TFCluster.InputMode.SPARK, master_node=None, env={util.ENV_PLATFORM: platform},
            jax_distributed=False, reservation_timeout=180, max_relaunches=2, shutdown_timeout=240, feed_fn=feed_fn)
    finally:
        sc.stop()
        if saved_env is None:
            os.environ.pop("TOS_MONITOR_INTERVAL", None)
        else:
            os.environ["TOS_MONITOR_INTERVAL"] = saved_env
    done = {}
    for eid in (0, 1):
        if os.path.exists(done_path(eid)):
            with open(done_path(eid)) as f:
                done[eid] = json.load(f)
    victim_dir = os.path.join(model_dir, "worker_{}".format(SPARK_FEED_VICTIM))
    return dict(relaunches=relaunches, feeds=len(feeds), marker=os.path.exists(os.path.join(model_dir, "killed.marker")),
                done=done, victim_ckpts=sorted(d for d in os.listdir(victim_dir) if d.startswith("ckpt_")),
                wall_s=time.time() - t0)


def spark_feed_failures(name, story):
    """The reference test's assertions on :func:`spark_feed_story`."""
    failures = []
    if story["relaunches"] != 1 or story["feeds"] != 2 or not story["marker"]:
        failures.append("{}: {} relaunches, feed_fn ran {} times, killed {} (want 1, 2, True)".format(
            name, story["relaunches"], story["feeds"], story["marker"]))
    if sorted(story["done"]) != [0, 1] or any(d["final_step"] != SPARK_FEED_TARGET for d in story["done"].values()):
        failures.append("{}: final steps {} (want {} on both)".format(name, story["done"], SPARK_FEED_TARGET))
    want = ["ckpt_{}".format(i) for i in range(SPARK_FEED_EVERY, SPARK_FEED_TARGET + 1, SPARK_FEED_EVERY)]
    if story["victim_ckpts"] != sorted(want):
        failures.append("{}: the victim's checkpoints {} (want {})".format(name, story["victim_ckpts"], sorted(want)))
    return failures


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    parser.add_argument("--size", choices=sorted(SIZES), default="full")
    parser.add_argument("--legs", default=",".join(LEGS), help="comma-separated, of " + ", ".join(LEGS))
    parser.add_argument("--work_dir", default=os.path.join("build", "cluster_check"))
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    legs = [leg for leg in args.legs.split(",") if leg]
    unknown = set(legs) - set(LEGS)
    if unknown:
        raise SystemExit("unknown legs {}".format(sorted(unknown)))
    import torch

    if args.platform == "gpu" and torch.cuda.device_count() < WORLD:
        raise RuntimeError("cluster_check --platform gpu needs {} cards; torch {} sees {}".format(
            WORLD, torch.__version__, torch.cuda.device_count()))
    from tensorflowonspark_tpu_torch.examples.transformer import transformer_spark

    work = os.path.abspath(args.work_dir)
    os.makedirs(work, exist_ok=True)
    data_dir = os.path.join(work, "lm_corpus")
    transformer_spark.make_text_corpus(data_dir, num_shards=WORLD)
    failures = []
    for leg in legs:
        if leg == "resnet_dp4":
            failures += leg_resnet(work, args.platform, args.size)
        elif leg == "ladder4":
            failures += leg_ladder(work, args.platform, args.size)
        elif leg == "mnist_spark_dp4":
            failures += leg_mnist_spark(work, args.platform, args.size)
        elif leg == "mnist_spark_recover4":
            failures += leg_mnist_spark_recover(work, args.platform, args.size)
        else:
            failures += leg_lm(work, args.platform, args.size, data_dir,
                               {"lm_dp4": "dp=4", "lm_dp2_tp2": "dp=2,tp=2"}[leg])
    emit({"ok": not failures, "failures": failures})
    return failures


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import util

    util.setup_logging()
    sys.exit(1 if main() else 0)
