"""The LM on its model axes, checked against its plain runs through
``TFCluster.run``: tensor parallelism, sequence parallelism, an 8-expert
mixture over ``ep``, and rematerialization.

The trainer (:func:`main_fun`, one executor, a world of one rank) runs
three legs on the LM, from seed-0 weights and the example's packed text:

* **tp**: ``SyncDataParallel(ctx.mesh({"dp": 1, "tp": -1}),
  tp=transformer.param_specs)`` with the model built on that mesh, beside
  the data-parallel ``SyncDataParallel(ctx.mesh({"dp": -1}))``, as
  ``fsdp_check.py`` runs its two sides: ``--eager_steps`` eager steps, two
  calls of the captured loop (K = ``--steps_per_loop``; call 2 traced with
  ``torch.profiler``), then ``--pairs`` turns timing an eager step and a
  loop call on each side. At one rank every region collective moves the
  bytes as they are, so the two must agree **bitwise** after the eager
  steps and after the loop; then the tp state is saved, restored onto a
  fresh data-parallel state with ``ckpt.reshard_restore`` and both take
  one more step: bitwise again.
* **sp**: ``SyncDataParallel(ctx.mesh({"dp": 1, "sp": -1}))`` with the
  model built on that mesh, each batch cut to this rank's block of the
  sequence (``sharding.sequence_chunk``), as a third side of the same
  turns. A ring of one member is the flash call, so it must agree with dp
  **bitwise** after the eager steps, after the loop, and after its
  checkpoint is resharded onto a fresh data-parallel state and both take a
  step.
* **moe**: the LM with 8 experts at the JAX package's defaults (capacity
  1.25, groups of 256, balancing weight 0.01) on ``{"dp": 1, "ep": -1}``:
  ``--moe_steps`` eager steps, and from the same weights the same batches
  through the captured loop; parameters and losses bitwise equal, the loss
  finite and lower at the end, ``moe_aux`` at least 0.99 at every step.
  Then one float32 step (TF32 off) of the same model at depth 2 on
  ``COMPARE_ROWS`` rows, on the card against the same on the CPU: the
  loss and every gradient within ``REL_TOL`` (``||card - cpu|| /
  ||cpu||``), and a 1% fault in the largest gradient read beyond it.
* **remat**: one eager step with ``remat=True`` against one without, on
  the same weights and batch: loss, gradients and parameters bitwise
  equal, with each step's peak memory; and the ``remat`` model's captured
  loop against its eager steps, bitwise.

The flash wrappers' launches are kept for each leg (reset before it).

Usage (one H100, the LM at ``TransformerConfig``'s full width: vocab 32000,
d_model 512, 6 layers, 8 heads, d_ff 2048, seq 2048, batch 8, bf16; f32 on
the CPU)::

    python -m tensorflowonspark_tpu_torch.examples.transformer.axes_check

and a rehearsal on the CPU at a small size::

    python -m tensorflowonspark_tpu_torch.examples.transformer.axes_check \\
        --platform cpu --size small

The trainer writes its readings as JSON to ``<work_dir>/axes_check.json``;
:func:`main` returns them (the command line prints them) and exits non-zero
on any disagreement.
"""

import argparse
import json
import os
import statistics
import tempfile
import time

from tensorflowonspark_tpu_torch.examples.transformer.fsdp_check import FULL, SMALL, _call, _eager, _mismatches, \
    _snapshot

#: card against CPU, float32, TF32 off: the loss and each gradient
REL_TOL = 1e-4
#: rows of the card-against-CPU step (the CPU runs the whole 2048-token rows)
COMPARE_ROWS = 2
#: the mixture: the JAX package's defaults
EXPERTS = 8


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _peak(torch, device, fn):
    """``fn()``'s result and the device memory it took at its peak above
    what was allocated before it (GB; None on the CPU)."""
    if device.type != "cuda":
        return fn(), None
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    return out, (torch.cuda.max_memory_allocated(device) - base) / 1e9


def main_fun(args, ctx):
    import torch

    from tensorflowonspark_tpu_torch import ckpt
    from tensorflowonspark_tpu_torch import tfrecord as tfr
    from tensorflowonspark_tpu_torch.data import TextPipeline, Tokenizer
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.ops import flash_attention
    from tensorflowonspark_tpu_torch.ops.kernel_trace import KernelTrace
    from tensorflowonspark_tpu_torch.parallel import sharding
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, checkpoint, optim

    size = FULL if args.size == "full" else SMALL
    dtype = "bfloat16" if args.platform == "gpu" else "float32"
    cfg = {k: v for k, v in size.items() if k not in ("seq_len", "batch")}
    e, k = args.eager_steps, args.steps_per_loop
    stream = iter(TextPipeline(tfr.list_shards(args.data_dir), Tokenizer(kind="byte"),
                               seq_len=size["seq_len"] + 1, batch_size=size["batch"], seed=0,
                               epochs=None, pack_workers=0))
    host = [next(stream) for _ in range(max(e + 2 * k + args.pairs * (1 + k) + 1, args.moe_steps))]
    stream.close()
    if ctx.num_processes != 1:
        raise ValueError("axes_check runs on one rank (the bitwise comparisons need a world of one)")
    device = ctx.device
    cuda = device.type == "cuda"
    tokens = size["batch"] * size["seq_len"]

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def build(strategy, seed, **over):
        # the model is built on a mesh with a model axis or sp
        mesh = (strategy.mesh if strategy.param_spec_fn is not None
                or "sp" in getattr(strategy.mesh, "mesh_dim_names", ()) else None)
        model = transformer.create_model(mesh=mesh, **dict(dict(cfg, dtype=dtype, max_seq_len=size["seq_len"]),
                                                           **over))
        optimizer = optim.adamw(3e-4)
        state = strategy.create_state(transformer.make_init_fn(model), optimizer,
                                      torch.Generator().manual_seed(seed))
        loss_fn = transformer.make_loss_fn(model)
        return state, strategy.compile_train_step(loss_fn, optimizer, has_aux=True), \
            strategy.compile_train_loop(loss_fn, optimizer, k, has_aux=True)

    out = {"size": args.size, "config": size, "dtype": dtype, "eager_steps": e, "steps_per_loop": k,
           "timed_pairs": args.pairs, "device": str(device)}

    # -- tp: dp x tp at one rank against dp, bitwise -----------------------
    sides = {"tp": SyncDataParallel(ctx.mesh({"dp": 1, "tp": -1}), tp=transformer.param_specs),
             "sp": SyncDataParallel(ctx.mesh({"dp": 1, "sp": -1})),
             "dp": SyncDataParallel(ctx.mesh({"dp": -1}))}
    runs = {}
    for name, strategy in sides.items():
        if cuda:
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        flash_attention.reset_launch_counts()
        state, step, loop = build(strategy, 0)
        block = (sharding.sequence_shard(strategy.mesh, ctx.process_id) if strategy.mesh is not None
                 else (0, 1))
        run = {"state": state, "step": step, "loop": loop, "losses": [], "eager_ms": [], "call_ms": [],
               "batches": iter([strategy.shard_batch(sharding.sequence_chunk(b, *block)) for b in host])}
        for _ in range(e):
            _eager(run, sync)
        run["after_eager"] = _snapshot(run["state"])
        _call(run, k, sync)  # the loop's warm-up steps and capture
        with KernelTrace() as traced:
            _call(run, k, sync)
        out[name] = {
            "launches": flash_attention.launch_counts(),
            "device_launches_traced_call": traced.readings["launches"],
            "graph_launches_traced_call": traced.readings["graph_launches"],
            "idle_share_traced_call": traced.readings["idle_share"],
            "params_split": len(state.blocks.specs) if state.blocks is not None else 0,
            "params": len(state.params),
        }
        if cuda:
            out[name]["peak_memory_gb"] = (torch.cuda.max_memory_allocated(device) - base) / 1e9
        run["eager_ms"], run["call_ms"] = run["eager_ms"][1:], []  # the first step built the kernels
        runs[name] = run
        del state, step, loop
    for _ in range(args.pairs):  # timed in turns: an eager step and a loop call a side
        for run in runs.values():
            _eager(run, sync)
            _call(run, k, sync)
    for name, run in runs.items():
        captured = [ms / k for ms in run["call_ms"]] or [float("nan")]
        out[name].update(
            losses=[float(v) for v in run["losses"]],
            eager_step_ms={"median": statistics.median(run["eager_ms"]), "min": min(run["eager_ms"]),
                           "max": max(run["eager_ms"])},
            captured_step_ms={"median": statistics.median(captured), "min": min(captured), "max": max(captured)},
            tokens_per_sec_captured=tokens / (statistics.median(captured) / 1e3))
    dp = runs.pop("dp")
    last = sides["dp"].shard_batch(host[-1])
    for name, run in runs.items():  # tp, sp: against dp, bitwise
        out[name + "_eager_mismatches"] = _mismatches(run["after_eager"], dp["after_eager"])
        out[name + "_loop_mismatches"] = _mismatches(_snapshot(run["state"]), _snapshot(dp["state"]))
        out[name + "_losses_bitwise"] = bool(torch.equal(torch.stack(run["losses"]), torch.stack(dp["losses"])))
        path = os.path.join(args.work_dir, "ckpt_{}_{}".format(name, run["state"].step))
        checkpoint.save_checkpoint(path, run["state"])
        fresh, dp_step, _ = build(sides["dp"], 1)
        restored = ckpt.reshard_restore(path, strategy=sides["dp"], target=fresh)
        out[name + "_restored_mismatches"] = _mismatches(_snapshot(restored), _snapshot(run["state"]))
        state, metrics = run["step"](run["state"], last)
        restored, restored_metrics = dp_step(restored, last)
        out[name + "_resumed_mismatches"] = _mismatches(_snapshot(restored), _snapshot(state))
        out[name + "_resumed_loss_bitwise"] = bool(torch.equal(metrics["loss"], restored_metrics["loss"]))
        del state, restored, fresh, dp_step
    del runs, dp, sides

    # -- moe: 8 experts over ep, eager against captured ----------------------
    if cuda:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    flash_attention.reset_launch_counts()
    ep = SyncDataParallel(ctx.mesh({"dp": 1, "ep": -1}), param_spec_fn=transformer.param_specs)
    moe_batches = [ep.shard_batch(b) for b in host[:args.moe_steps]]
    state, step, _ = build(ep, 0, moe_experts=EXPERTS)
    losses, aux, ms = [], [], []
    for b in moe_batches:
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].clone())
        aux.append(float(metrics["moe_aux"]))
    eager = _snapshot(state)
    expert_params = sum(p.numel() for n, p in state.params.items() if n.endswith(("moe.wi", "moe.wo")))
    del state, step
    state, _, loop = build(ep, 0, moe_experts=EXPERTS)
    loop_losses, call_ms = [], []
    for i in range(0, args.moe_steps, k):
        sync()
        t0 = time.perf_counter()
        state, metrics = loop(state, moe_batches[i:i + k])
        sync()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        loop_losses.append(metrics["loss"].clone())
    out["moe"] = {
        "experts": EXPERTS, "capacity_factor": state.module.cfg.moe_capacity_factor,
        "group_size": state.module.cfg.moe_group_size, "aux_weight": state.module.cfg.moe_aux_weight,
        "steps": args.moe_steps, "expert_params": expert_params,
        "losses": [float(v) for v in losses], "moe_aux": aux,
        "launches": flash_attention.launch_counts(),
        "eager_step_ms": {"median": statistics.median(ms[1:]), "min": min(ms[1:]), "max": max(ms[1:])},
        "captured_step_ms_call2": call_ms[-1] / k, "tokens_per_sec_captured": tokens / (call_ms[-1] / k / 1e3),
        "loop_mismatches": _mismatches(_snapshot(state), eager),
        "loop_losses_bitwise": bool(torch.equal(torch.stack(loop_losses), torch.stack(losses[k - 1::k])))}
    if cuda:
        out["moe"]["peak_memory_gb"] = (torch.cuda.max_memory_allocated(device) - base) / 1e9
    del state, loop, eager, moe_batches
    out["moe_compare"] = _card_vs_cpu(torch, transformer, cfg, size, host[0], ep, COMPARE_ROWS) if cuda else None

    # -- remat: bitwise the plain step, in its captured loop too -------------
    if cuda:
        torch.cuda.empty_cache()
    flash_attention.reset_launch_counts()
    plain = SyncDataParallel(device)
    batches = [plain.shard_batch(b) for b in host[:k]]
    results = {}
    for remat in (False, True):
        state, step, _ = build(plain, 0, remat=remat)
        (state, metrics), peak = _peak(torch, device, lambda: step(state, batches[0]))
        results[remat] = {"loss": metrics["loss"].clone(), "peak_memory_gb": peak,
                          "grads": {n: p.grad.clone() for n, p in state.module.named_parameters()},
                          "params": _snapshot(state)}
        if remat:
            for b in batches[1:]:
                state, metrics = step(state, b)
            eager = _snapshot(state)
        del state, step
    state, _, loop = build(plain, 0, remat=True)
    state, loop_metrics = loop(state, batches)
    a, b = results[True], results[False]
    out["remat"] = {
        "loss_bitwise": bool(torch.equal(a["loss"], b["loss"])),
        "grad_mismatches": _mismatches(a["grads"], b["grads"]),
        "param_mismatches": _mismatches(a["params"], b["params"]),
        "loop_mismatches": _mismatches(_snapshot(state), eager),
        "loop_loss_bitwise": bool(torch.equal(loop_metrics["loss"], metrics["loss"])),
        "peak_memory_gb": {"remat": a["peak_memory_gb"], "plain": b["peak_memory_gb"]},
        "launches": flash_attention.launch_counts()}
    with open(os.path.join(args.work_dir, "axes_check.json"), "w") as f:
        json.dump(out, f)


def _card_vs_cpu(torch, transformer, cfg, size, host_batch, ep, rows):
    """One float32 forward and backward of the 8-expert LM at depth 2 on
    ``rows`` rows, on the card (on the ``ep`` mesh, the flash kernels) and
    on the CPU (plain attention) from the same weights: the loss's and each
    gradient's relative difference, and a 1% fault in the card's largest
    gradient, which must read beyond ``REL_TOL``."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        small = dict(cfg, n_layers=2, dtype="float32", max_seq_len=size["seq_len"], moe_experts=EXPERTS)
        batch = {k: torch.as_tensor(v[:rows]) for k, v in host_batch.items()}
        got = {}
        for where in ("card", "cpu"):
            model = transformer.create_model(mesh=ep.mesh if where == "card" else None, **small,
                                             generator=torch.Generator().manual_seed(0))
            device = ep.device if where == "card" else torch.device("cpu")
            model = model.to(device)
            loss, metrics = transformer.make_loss_fn(model)(model, {k: v.to(device) for k, v in batch.items()})
            loss.backward()
            got[where] = {"loss": loss.detach().cpu(), "moe_aux": float(metrics["moe_aux"]),
                          "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()}}
            del model, loss
        card, cpu = got["card"], got["cpu"]
        grad_rel = {n: _rel(card["grads"][n], g) for n, g in cpu["grads"].items()}
        fault = max(cpu["grads"], key=lambda n: cpu["grads"][n].norm())
        return {"n_layers": 2, "rows": rows, "dtype": "float32", "tf32": False, "tolerance": REL_TOL,
                "loss_card": float(card["loss"]), "loss_cpu": float(cpu["loss"]),
                "loss_rel": _rel(card["loss"], cpu["loss"]), "moe_aux_card": card["moe_aux"],
                "moe_aux_cpu": cpu["moe_aux"], "grad_rel_max": max(grad_rel.values()),
                "grad_rel_worst": max(grad_rel, key=grad_rel.get), "fault": "{} gradient x 1.01".format(fault),
                "fault_grad_rel": _rel(card["grads"][fault] * 1.01, cpu["grads"][fault])}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def failures(out):
    """What in the trainer's readings breaks the contract (empty: none)."""
    bad = [side + key for side in ("tp", "sp") for key in ("_eager_mismatches", "_loop_mismatches",
                                                          "_restored_mismatches", "_resumed_mismatches")
           if out[side + key]]
    bad += [side + key for side in ("tp", "sp") for key in ("_losses_bitwise", "_resumed_loss_bitwise")
            if not out[side + key]]
    if out["tp"]["params_split"] == 0:
        bad.append("no parameter split over tp")
    moe = out["moe"]
    if moe["loop_mismatches"] or not moe["loop_losses_bitwise"]:
        bad.append("moe: captured loop differs from eager steps {}".format(moe["loop_mismatches"]))
    import math

    if not all(math.isfinite(v) for v in moe["losses"]) or not moe["losses"][-1] < moe["losses"][0]:
        bad.append("moe: losses not finite and falling {}".format(moe["losses"]))
    if min(moe["moe_aux"]) < 0.99:
        bad.append("moe: balancing loss below 0.99 {}".format(moe["moe_aux"]))
    cmp = out["moe_compare"]
    if cmp is not None:
        if max(cmp["loss_rel"], cmp["grad_rel_max"]) > cmp["tolerance"]:
            bad.append("moe: card against CPU beyond {}: loss {} grad {} ({})".format(
                cmp["tolerance"], cmp["loss_rel"], cmp["grad_rel_max"], cmp["grad_rel_worst"]))
        if cmp["fault_grad_rel"] <= cmp["tolerance"]:
            bad.append("moe: a 1% fault read {} within {}".format(cmp["fault_grad_rel"], cmp["tolerance"]))
    remat = out["remat"]
    if not remat["loss_bitwise"] or remat["grad_mismatches"] or remat["param_mismatches"]:
        bad.append("remat differs from the plain step: {} {}".format(remat["grad_mismatches"][:3],
                                                                     remat["param_mismatches"][:3]))
    if remat["loop_mismatches"] or not remat["loop_loss_bitwise"]:
        bad.append("remat: captured loop differs from eager steps {}".format(remat["loop_mismatches"][:3]))
    return bad


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    parser.add_argument("--size", choices=["full", "small"], default="full")
    parser.add_argument("--eager_steps", type=int, default=3)
    parser.add_argument("--steps_per_loop", type=int, default=5)
    parser.add_argument("--pairs", type=int, default=3,
                        help="timed turns of the tp leg: an eager step and a loop call on each side")
    parser.add_argument("--moe_steps", type=int, default=10,
                        help="steps of the mixture, eager and through the loop (a multiple of "
                             "--steps_per_loop)")
    parser.add_argument("--data_dir", default=None, help="TFRecord text shards; default: the LM example's "
                                                          "synthetic corpus")
    parser.add_argument("--work_dir", default=None, help="checkpoint and readings; default: a temporary dir")
    return parser


def main(argv=None, sc=None):
    """Run the check on one executor; returns the trainer's readings and
    raises ``SystemExit`` when they break the contract."""
    from tensorflowonspark_tpu_torch import TFCluster, util
    from tensorflowonspark_tpu_torch.backends import get_spark_context
    from tensorflowonspark_tpu_torch.examples.transformer import transformer_spark

    args = build_parser().parse_args(argv)
    if args.moe_steps % args.steps_per_loop:
        raise SystemExit("axes_check: --moe_steps must be a multiple of --steps_per_loop")
    if not args.data_dir:
        args.data_dir = os.path.join(tempfile.gettempdir(), "tos_transformer_corpus")
        transformer_spark.make_text_corpus(args.data_dir)
    with tempfile.TemporaryDirectory() as tmp:
        args.work_dir = args.work_dir or tmp
        os.makedirs(args.work_dir, exist_ok=True)
        sc, _, owned = get_spark_context("axes_check", 1, sc=sc, local_default=1)
        try:
            cluster = TFCluster.run(sc, main_fun, args, 1, input_mode=TFCluster.InputMode.TENSORFLOW,
                                    master_node="chief", env={util.ENV_PLATFORM: args.platform})
            cluster.shutdown()
        finally:
            if owned:
                sc.stop()
        with open(os.path.join(args.work_dir, "axes_check.json")) as f:
            out = json.load(f)
    bad = failures(out)
    if bad:
        raise SystemExit("axes_check: the model axes disagree with their plain runs: {}".format(bad))
    return out


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import util

    util.setup_logging()
    print(json.dumps(main()), flush=True)
