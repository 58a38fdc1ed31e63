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

``--platform gpu`` (the default) raises unless torch sees 4 cards; ``--platform
cpu --size small`` rehearses every leg on 4 gloo executors at narrow widths.
Exits non-zero if any leg's check fails. On four cards::

    python -m tensorflowonspark_tpu_torch.examples.cluster_check
"""

import argparse
import glob
import hashlib
import json
import os
import sys
import threading
import time

WORLD = 4
LEGS = ("resnet_dp4", "lm_dp4", "lm_dp2_tp2", "ladder4")
LM_FULL = dict(vocab_size=32000, d_model=512, n_layers=6, n_heads=8, d_ff=2048)
LM_SMALL = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128)
SIZES = {
    "full": dict(resnet=["--dataset", "imagenet", "--batch_size", "64"], resnet_steps=60,
                 lm=LM_FULL, seq=2048, lm_steps=40, ladder_rows=12, ladder_every=50, ladder_kill=50,
                 ladder_tail=50, regrow_s=45.0),
    "small": dict(resnet=["--dataset", "cifar", "--image_size", "8", "--batch_size", "4"], resnet_steps=10,
                  lm=LM_SMALL, seq=64, lm_steps=10, ladder_rows=12, ladder_every=4, ladder_kill=4,
                  ladder_tail=4, regrow_s=12.0),
}
#: the LM legs' global batch (rows), split over each leg's data axes
LM_ROWS = 8
STEPS_PER_LOOP = 5
HEARTBEAT_S = 0.25


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


# -- the recovery ladder across executors -------------------------------------

#: the ladder's files under its root: the latch that holds the kill back, the
#: marker the arm thread leaves once it released it, and the trainers' flight
#: shards
KILL_LATCH, KILL_FIRED, TRACE = "kill.latch", "kill.fired", "trace"
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
        with open(path, "w") as f:
            json.dump(life, f)

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
    while not full:
        time.sleep(1)  # the drain ends this life


def run_ladder_story(map_fun, args, root, executors, victim, arm_dir, kill_step, platform, jax_distributed,
                     master_node, regrow_s, task_timeout=None):
    """The story of the JAX package's ``test_preempt_drain_regrow_full_size_resume``
    through ``elastic.run_ladder`` on ``executors`` executors of the local
    backend: a latched ``node.kill`` of executor ``victim``, armed (the
    latch ``root/kill.latch`` removed, ``root/kill.fired`` left) once a
    checkpoint of step ``kill_step`` or later is committed in ``arm_dir``;
    ``blacklist_after=1``, so the ladder shrinks by one; the mid-run regrow
    probe (every ``regrow_s``) forgives the victim, the scaler votes to grow
    and the driver's preemption warning drains the shrunk world; the
    relaunch runs at full size. ``map_fun`` records each life with
    :func:`life_record` under ``root``; the trainers trace into
    ``root/trace``.

    Returns a dict: ``result`` (the ladder's), ``lives`` (the life records
    grouped by life, oldest first: a life's trainers share its coordinator,
    a fresh port each life), ``armed`` (the checkpoint step and the time the
    kill was armed), ``aborts`` (start and end of each driver abort),
    ``preempts`` (each preemption warning), ``classified`` (time and kind of
    each classified failure), ``counters`` (:data:`LADDER_COUNTERS`' deltas),
    ``exits`` (of each life but the last, each trainer's way out: the
    reason of its last flight dump, ``aborted`` for the abort's SIGTERM
    drain, or ``sigkill`` when it left none, which is the abort's SIGKILL
    after its grace), ``shards`` (the trainers' flight shards as ``(start
    wall time, records)``, oldest first) and ``wall_s``."""
    from tensorflowonspark_tpu_torch import TFCluster, chaos, control, elastic, obs, util
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.obs import flight

    latch, fired = os.path.join(root, KILL_LATCH), os.path.join(root, KILL_FIRED)
    with open(latch, "w"):
        pass  # holds the kill back until a checkpoint is committed
    armed, done = {}, threading.Event()

    def arm():
        while not done.wait(0.02):
            steps = _committed_steps(arm_dir)
            if steps and max(steps) >= kill_step:
                armed.update(step=max(steps), t=time.time())
                with open(fired, "w"):
                    pass  # the lives after this one are not the first
                os.remove(latch)
                return

    moments = {"aborts": [], "preempts": [], "classified": []}
    real = (TFCluster.TFCluster.abort, TFCluster.TFCluster.preempt, elastic.classify_failure)

    def abort(self, *a, **kw):
        t0 = time.time()
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

    before = {name: obs.counter(name).value for name in LADDER_COUNTERS}
    env = {"TOS_HEARTBEAT_INTERVAL": str(HEARTBEAT_S), "TOS_MONITOR_INTERVAL": "1",
           flight.TRACE_DIR_ENV: os.path.join(root, TRACE)}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    chaos.install(chaos.ChaosPlan(seed=0).site("node.kill", probability=1.0, max_count=1, victim=victim,
                                               once_path=latch))
    TFCluster.TFCluster.abort, TFCluster.TFCluster.preempt, elastic.classify_failure = abort, preempt, classify
    watcher = threading.Thread(target=arm, name="ladder-arm", daemon=True)
    t0 = time.time()
    sc = LocalSparkContext(num_executors=executors, **({"task_timeout": task_timeout} if task_timeout else {}))
    watcher.start()
    try:
        result = elastic.run_ladder(
            sc, map_fun, args, num_executors=executors, max_relaunches=1, min_workers=1, blacklist_after=1,
            regrow=True, regrow_check_secs=regrow_s,
            scaler=control.ClusterScaler(executors, min_size=1, grow_patience=1),
            input_mode=TFCluster.InputMode.TENSORFLOW, master_node=master_node, env={util.ENV_PLATFORM: platform},
            jax_distributed=jax_distributed, reservation_timeout=300, shutdown_timeout=300)
    finally:
        done.set()
        watcher.join()
        sc.stop()
        chaos.uninstall()
        TFCluster.TFCluster.abort, TFCluster.TFCluster.preempt, elastic.classify_failure = real
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.time() - t0
    records = []
    for path in glob.glob(os.path.join(root, "life_*.json")):
        with open(path) as f:
            records.append(json.load(f))
    groups = {}
    for rec in records:
        groups.setdefault(rec["coordinator"], []).append(rec)
    lives = [sorted(life, key=lambda r: r["executor_id"])
             for life in sorted(groups.values(), key=lambda life: min(r["t_start"] for r in life))]
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
    exits = [{r["executor_id"]: last_dump.get(r["pid"], "sigkill") for r in life} for life in lives[:-1]]
    return dict(result=result, lives=lives, armed=armed, counters={
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
    import shutil

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
        else:
            failures += leg_lm(work, args.platform, args.size, data_dir,
                               {"lm_dp4": "dp=4", "lm_dp2_tp2": "dp=2,tp=2"}[leg])
    emit({"ok": not failures, "failures": failures})
    return failures


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import util

    util.setup_logging()
    sys.exit(1 if main() else 0)
