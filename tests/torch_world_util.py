"""Gloo worlds of the port on the CPU for the mesh, FSDP and reshard tests.

:func:`run_world` starts ``world`` processes, each joining the world through
the port's ``testing.join_cpu_world`` and running the jobs of one spec (a
dict ``{name: (job, kwargs)}``) in order; every rank's ``{name: result}``
comes back. The jobs below use the port only (the JAX references stay in the
test process): :func:`job_collectives`, :func:`job_train` and the reshard
jobs."""

import os
import socket
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))

_MAIN = r"""
import sys
sys.path.insert(0, sys.argv[6])
import torch_world_util
torch_world_util.rank_main(*sys.argv[1:6])
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(tmp_path, spec, world=4, timeout=240):
    """Run ``spec``'s jobs on every rank of a ``world``-rank gloo world;
    returns each rank's ``{name: result}``."""
    job = str(tmp_path / "job.pt")
    torch.save(spec, job)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    outs = [str(tmp_path / "rank{}.pt".format(r)) for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", _MAIN, str(r), str(world), str(port), job, outs[r], HERE],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(o, weights_only=False) for o in outs]


def rank_main(rank, world, port, job, out):
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch import testing

    ctx = testing.join_cpu_world(int(rank), int(world), int(port))
    spec = torch.load(job, weights_only=False)
    results = {name: globals()[kind](ctx, **kw) for name, (kind, kw) in spec.items()}
    torch.save(results, out)
    dist.barrier()
    dist.destroy_process_group()


def _block(x, n, i):
    x = torch.as_tensor(x)
    return x.chunk(n, 0)[i].contiguous()


def job_collectives(ctx, x):
    """Every collective of ``parallel.collectives`` on this rank's block of
    the global ``x`` ([4·m, ...]) over a ``{"dp": 4}`` mesh, and the data
    group's sum over a ``{"dp": 2, "fsdp": 2}`` mesh."""
    from tensorflowonspark_tpu_torch.parallel import collectives as c

    mesh = ctx.mesh({"dp": 4})
    mine = _block(x, 4, ctx.process_id)
    out = {
        "psum": c.psum(mine, "dp", mesh), "pmean": c.pmean(mine, "dp", mesh),
        "all_gather": c.all_gather(mine, "dp", mesh), "all_gather_1": c.all_gather(mine, "dp", mesh, axis=1),
        "all_gather_stack": c.all_gather(mine, "dp", mesh, tiled=False),
        "reduce_scatter": c.reduce_scatter(mine, "dp", mesh),
        "reduce_scatter_1": c.reduce_scatter(mine, "dp", mesh, scatter_dimension=1),
        "ring_shift": c.ring_shift(mine, "dp", mesh), "ring_shift_back": c.ring_shift(mine, "dp", mesh, shift=-1),
        "all_to_all": c.all_to_all(mine, "dp", mesh, split_axis=1, concat_axis=0),
        "axis_index": c.axis_index("dp", mesh), "axis_size": c.axis_size("dp", mesh),
    }
    hybrid = ctx.mesh({"dp": 2, "fsdp": 2})
    out["psum_data"] = c.psum(mine, ("dp", "fsdp"), hybrid)
    out["psum_fsdp"] = c.psum(mine, "fsdp", hybrid)
    out["input_intact"] = torch.equal(mine, _block(x, 4, ctx.process_id))
    return out


class Mlp(torch.nn.Module):
    """The MLP of the JAX package's multichip tests: ``w1`` [64, 64],
    ``w2`` [64, 8] in the flax layout, ``tanh(x @ w1) @ w2``."""

    def __init__(self, w1, w2):
        super().__init__()
        self.w1 = torch.nn.Parameter(torch.as_tensor(w1).clone())
        self.w2 = torch.nn.Parameter(torch.as_tensor(w2).clone())

    def forward(self, x):
        return torch.tanh(x @ self.w1) @ self.w2


def mlp_loss(module, batch):
    return ((module(batch["x"]) - batch["y"]) ** 2).mean()


def _model(kind, variables, cfg):
    """``(init_fn, loss_fn, train kwargs)`` of a model kind from the JAX
    model's variables (converted)."""
    from tensorflowonspark_tpu_torch import convert

    if kind == "mlp":
        return (lambda: Mlp(variables["w1"], variables["w2"])), mlp_loss, {}
    if kind == "transformer":
        from tensorflowonspark_tpu_torch.models import transformer

        module = transformer.create_model(**cfg)
        return (lambda: convert.load_variables(module, {"params": variables})), \
            transformer.make_loss_fn(module), {"has_aux": True}
    from tensorflowonspark_tpu_torch.models import resnet

    module = resnet.ResNet(**cfg)
    return (lambda: convert.load_variables(module, variables)), \
        resnet.make_loss_fn(weight_decay=1e-4), {"mutable": True}


def _optimizer(spec):
    from tensorflowonspark_tpu_torch.train import optim

    name, kw = spec
    return getattr(optim, name)(**kw)


def job_train(ctx, kind, variables, cfg, optimizer, batches, axes, fsdp, min_weight_size):
    """Train ``kind`` (converted from the JAX model's ``variables``) on
    ``ctx.mesh(axes)``, each rank on its rows of the global ``batches``:
    the losses, the full (gathered) parameters and buffers, the sharded
    dims and the ``fsdp_params_sharded`` gauge."""
    from tensorflowonspark_tpu_torch import obs
    from tensorflowonspark_tpu_torch.train import SyncDataParallel

    mesh = ctx.mesh(axes)
    strategy = SyncDataParallel(mesh, fsdp=fsdp, min_weight_size=min_weight_size)
    init_fn, loss_fn, kw = _model(kind, variables, cfg)
    opt = _optimizer(optimizer)
    state = strategy.create_state(init_fn, opt)
    mine = [strategy.shard_batch({k: _block(v, mesh.size(), ctx.process_id) for k, v in b.items()})
            for b in batches]
    step = strategy.compile_train_step(loss_fn, opt, **kw)
    losses = []
    for b in mine:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    opt = state.opt_state
    return {"losses": losses, "params": {k: v.detach().clone() for k, v in state.params.items()},
            "buffers": {k: v.clone() for k, v in state.model_state.items()},
            "dims": dict(state.sharded.dims) if state.sharded is not None else {},
            "gauge": obs.gauge("fsdp_params_sharded").value if fsdp else None,
            "adam_elems": sum(t.numel() for t in opt["mu"].values()) if "mu" in opt else None}


def _mnist_state(strategy, seed):
    """The reshard tests' state: the port's MNIST MLP (hidden 8), SGD 0.1,
    one step on a seeded batch split over the data axes."""
    import numpy as np

    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.train import optim

    model = mnist.create_model("mlp", hidden=8)
    optimizer = optim.sgd(0.1, momentum=0.9)
    state = strategy.create_state(lambda: mnist.make_init_fn(model)(torch.Generator().manual_seed(seed)),
                                  optimizer)
    step = strategy.compile_train_step(mnist.make_loss_fn(model), optimizer, has_aux=True)
    rng = np.random.default_rng(7)
    batch = {"image": rng.standard_normal((8, 28, 28)).astype(np.float32), "label": rng.integers(0, 10, 8)}
    n = strategy.mesh.size()
    state, _ = step(state, strategy.shard_batch({k: _block(v, n, torch.distributed.get_rank())
                                                 for k, v in batch.items()}))
    return state


def _host(state):
    """A TrainState's checkpointed tree, full tensors on the host."""
    from tensorflowonspark_tpu_torch.train import checkpoint

    tree = checkpoint._to_saveable(state)
    return {k: ({n: v.detach().clone() for n, v in t.items()} if k == "params" else t)
            for k, t in tree.items()}


def _local(state):
    return {"opt_state": state.opt_state, "shards": dict(state.sharded.shards) if state.sharded else {},
            "dims": dict(state.sharded.dims) if state.sharded else {}}


def job_save(ctx, root, axes, fsdp, step_no, engine=True):
    """A state trained one step on ``ctx.mesh(axes)``, saved as
    ``ckpt_<step_no>`` under ``root`` (through the async engine, or the
    blocking save); returns its full host tree."""
    from tensorflowonspark_tpu_torch import ckpt
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, checkpoint

    strategy = SyncDataParallel(ctx.mesh(axes), fsdp=fsdp, min_weight_size=1)
    state = _mnist_state(strategy, seed=0)
    host = _host(state)
    if engine:
        if fsdp or ctx.process_id == 0:  # a sharded state: every rank joins the gathers
            with ckpt.AsyncCheckpointEngine(root) as eng:
                eng.save(state, step_no)
                assert eng.drain(timeout=120)
        torch.distributed.barrier()
    else:
        checkpoint.save_checkpoint(os.path.join(root, "ckpt_{}".format(step_no)), state)
    return {"host": host, "verified": ckpt.verify(os.path.join(root, "ckpt_{}".format(step_no)))}


def job_restore(ctx, path, axes, fsdp, save_to=None):
    """A fresh state on ``ctx.mesh(axes)`` (other seed), the checkpoint at
    ``path`` resharded into it; its full host tree, its local shards and,
    with ``save_to``, the restored state saved again (blocking) there."""
    from tensorflowonspark_tpu_torch import ckpt
    from tensorflowonspark_tpu_torch.ckpt.reshard import state_shardings
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, checkpoint

    strategy = SyncDataParallel(ctx.mesh(axes), fsdp=fsdp, min_weight_size=1)
    fresh = _mnist_state(strategy, seed=9)
    derived = state_shardings(strategy, fresh)
    restored = ckpt.reshard_restore(path, strategy=strategy, target=fresh)
    out = {"host": _host(restored), "local": _local(restored), "step": restored.step,
           "derived": {"params": {n: s.spec for n, s in derived["params"].items()},
                       "trace": {n: s.spec for n, s in derived["opt_state"]["trace"].items()}},
           "mesh": dict(zip(strategy.mesh.mesh_dim_names, strategy.mesh.mesh.shape))}
    if save_to:
        checkpoint.save_checkpoint(save_to, restored)
    return out


def job_bare(ctx, root):
    """The bare-pytree cases: a dict saved by the engine on rank 0, placed
    with explicit shardings and by a strategy (replicated)."""
    from tensorflowonspark_tpu_torch import ckpt
    from tensorflowonspark_tpu_torch.parallel import sharding
    from tensorflowonspark_tpu_torch.train import SyncDataParallel

    tree = {"step": 4, "w": torch.arange(32, dtype=torch.float32)}
    if ctx.process_id == 0:
        with ckpt.AsyncCheckpointEngine(root) as eng:
            eng.save(tree, 4)
            assert eng.drain(timeout=120)
    torch.distributed.barrier()
    path = os.path.join(root, "ckpt_4")
    mesh = ctx.mesh({"dp": -1})
    explicit = ckpt.reshard_restore(path, shardings={"step": sharding.replicated(mesh),
                                                     "w": sharding.Sharding(mesh, ("dp",))})
    strategy = SyncDataParallel(ctx.mesh({"dp": 2, "fsdp": 2}))
    by_strategy = ckpt.reshard_restore(path, strategy=strategy)
    blocks = sharding.shard_params({"w": tree["w"].view(4, 8)}, strategy.mesh, {"w": (None, "fsdp")})
    return {"explicit": explicit, "by_strategy": by_strategy, "shard_params": blocks["w"]}


# -- model axes (tp, ep): the transformer built on a mesh ----------------------


def _axes_strategy(mesh, axes, fsdp=False):
    """The strategy for a mesh with model axes: the transformer's rules as
    ``tp=`` when the mesh has ``tp``, as ``param_spec_fn=`` for ``ep``."""
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.train import SyncDataParallel

    kw = {}
    if "tp" in axes:
        kw["tp"] = transformer.param_specs
    elif "ep" in axes:
        kw["param_spec_fn"] = transformer.param_specs
    return SyncDataParallel(mesh, fsdp=fsdp, min_weight_size=1, **kw)


def _data_rows(mesh, x):
    """This rank's rows of the global ``x``: split over the mesh's data
    axes only (the ranks of a model axis hold the same rows)."""
    from tensorflowonspark_tpu_torch.parallel import collectives, sharding

    axes = sharding.data_axes(mesh)
    if not axes:
        return _block(x, 1, 0)
    return _block(x, collectives.axis_size(axes, mesh), collectives.axis_index(axes, mesh))


def _lm_rows(mesh, batch):
    """This rank's part of a global LM batch: its data rows and, along
    ``sp``, its block of the sequence (``sharding.sequence_chunk``)."""
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.parallel import sharding

    rows = {k: _data_rows(mesh, v).numpy() for k, v in batch.items()}
    return sharding.sequence_chunk(rows, *sharding.sequence_shard(mesh, dist.get_rank()))


def _lm_state(ctx, variables, cfg, axes, fsdp=False, lr=1e-3):
    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.train import optim

    mesh = ctx.mesh(axes)
    strategy = _axes_strategy(mesh, axes, fsdp)
    model = transformer.create_model(mesh=mesh, **cfg)
    opt = optim.adamw(lr)
    state = strategy.create_state(lambda: convert.load_variables(model, {"params": variables}), opt)
    return mesh, strategy, model, opt, state


def _full_params(state):
    params = {k: v.detach().clone() for k, v in state.params.items()}
    return state.blocks.full_tree(params) if state.blocks is not None else params


def job_axes_logits(ctx, variables, cfg, batch, axes, fsdp=False):
    """The packed batch's logits from the transformer (converted from the
    JAX model's ``variables``) built on ``ctx.mesh(axes)``, every rank on
    the whole batch; the specs, the module's blocks and the
    ``tp_params_sharded`` gauge."""
    from tensorflowonspark_tpu_torch import obs

    _, strategy, _, _, state = _lm_state(ctx, variables, cfg, axes, fsdp)
    with torch.no_grad():
        logits = state.module(torch.as_tensor(batch["tokens"]), positions=torch.as_tensor(batch["positions"]),
                              segment_ids=torch.as_tensor(batch["segment_ids"]))
    return {"logits": logits, "specs": {n: s.spec for n, s in strategy.param_shardings(state.module).items()},
            "model_specs": dict(state.module.model_specs),
            "local_shapes": {n: tuple(p.shape) for n, p in state.module.named_parameters()},
            "fsdp_dims": dict(state.sharded.dims) if state.sharded is not None else {},
            "gauge": obs.gauge("tp_params_sharded").value if "tp" in axes else None}


def job_axes_step(ctx, variables, cfg, batches, axes, fsdp=False):
    """``len(batches)`` AdamW steps of the transformer on
    ``ctx.mesh(axes)``, each rank on its data rows: the losses and last
    metrics, the full (gathered) parameters and last gradients (averaged
    over the data axes), the gradients of the parameters no model axis
    splits, and the Adam state's elements."""
    from tensorflowonspark_tpu_torch.models import transformer

    mesh, strategy, model, opt, state = _lm_state(ctx, variables, cfg, axes, fsdp)
    step = strategy.compile_train_step(transformer.make_loss_fn(model), opt, has_aux=True)
    losses, metrics = [], {}
    for b in batches:
        state, metrics = step(state, strategy.shard_batch(_lm_rows(mesh, b)))
        losses.append(float(metrics["loss"]))
    cut = set(state.blocks.specs) if state.blocks is not None else set()
    grads = {n: p.grad.clone() for n, p in state.module.named_parameters()}
    return {"losses": losses, "metrics": {k: float(v) for k, v in metrics.items() if k != "step"},
            "params": _full_params(state),
            "grads": state.blocks.full_tree(grads) if state.blocks is not None else grads,
            "replicated_grads": {n: p.grad.clone() for n, p in state.module.named_parameters() if n not in cut},
            "adam_elems": sum(t.numel() for t in state.opt_state["mu"].values())}


def job_axes_save(ctx, root, variables, cfg, batch, axes, step_no, fsdp=False):
    """One step on ``ctx.mesh(axes)``, saved as ``ckpt_<step_no>`` under
    ``root`` by the blocking save (every rank of a sharded state calls it,
    rank 0 writes; otherwise rank 0 alone); its full host tree."""
    from tensorflowonspark_tpu_torch import ckpt
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.train import checkpoint

    mesh, strategy, model, opt, state = _lm_state(ctx, variables, cfg, axes, fsdp)
    step = strategy.compile_train_step(transformer.make_loss_fn(model), opt, has_aux=True)
    state, _ = step(state, strategy.shard_batch(_lm_rows(mesh, batch)))
    path = os.path.join(root, "ckpt_{}".format(step_no))
    if checkpoint.save_is_collective(state) or ctx.process_id == 0:
        checkpoint.save_checkpoint(path, state)
    torch.distributed.barrier()
    return {"tree": checkpoint.restore_checkpoint(path), "verified": ckpt.verify(path),
            "gathers": checkpoint.save_is_collective(state)}


def job_axes_restore(ctx, path, variables, cfg, axes, fsdp=False):
    """A fresh state on ``ctx.mesh(axes)`` (the JAX model's weights), the
    checkpoint at ``path`` resharded into it: its full parameters and
    optimizer state (gathered), its step, and its own blocks."""
    from tensorflowonspark_tpu_torch import ckpt
    from tensorflowonspark_tpu_torch.train import checkpoint

    _, strategy, _, _, state = _lm_state(ctx, variables, cfg, axes, fsdp)
    restored = ckpt.reshard_restore(path, strategy=strategy, target=state)
    tree = checkpoint._to_saveable(restored)  # collective gathers
    return {"params": {k: v.detach().clone() for k, v in tree["params"].items()},
            "opt_state": tree["opt_state"], "step": restored.step,
            "local": {k: v.detach().clone() for k, v in restored.params.items()}}


def job_regions(ctx, x, w):
    """Each gradient-carrying collective over the 4-rank ``tp`` group, with
    this rank's block ``x[r]`` (``x[0]`` on every rank for
    ``copy_to_region``, whose input is replicated) and weights ``w``: the
    value and the gradient of this rank's input."""
    from tensorflowonspark_tpu_torch.parallel import collectives as c

    mesh = ctx.mesh({"dp": 1, "tp": 4})
    group = c.axes_group(mesh, "tp")
    r = c.axis_index("tp", mesh)
    w = torch.as_tensor(w)
    out = {}
    for name in ("copy", "reduce", "gather", "global_sum"):
        xr = torch.as_tensor(x[0 if name == "copy" else r]).clone().requires_grad_(True)
        if name == "copy":
            y = c.copy_to_region(xr, group) * w[r]
        elif name == "reduce":
            y = c.reduce_from_region(xr, group) * w[0]
        elif name == "gather":
            y = c.gather_from_region(xr, group, dim=1) * torch.cat(list(w), dim=1)
        else:
            y = torch.tanh(c.global_sum(xr, group)) * w[0]
        y.sum().backward()
        out[name] = {"value": y.detach().clone(), "grad": xr.grad.clone()}
    return out


# -- sequence parallelism: ring attention over sp -------------------------------


def job_ring(ctx, cases):
    """``ring_attention_sharded`` on each case ``{name: (axes, q, k, v,
    segment_ids, causal, g)}`` (whole ``[B, H, L, D]`` inputs on every rank):
    the output, the gradients of ``sum(out · g)`` and, for a ring of the
    whole world, the one-process seam (``ring_attention_local``) on the
    same inputs."""
    from tensorflowonspark_tpu_torch.parallel import ring_attention as ra

    out = {}
    for name, (axes, q, k, v, seg, causal, g) in cases.items():
        mesh = ctx.mesh(axes)
        leaves = [torch.as_tensor(t).clone().requires_grad_(True) for t in (q, k, v)]
        ids = None if seg is None else torch.as_tensor(seg)
        o = ra.ring_attention_sharded(*leaves, mesh, causal=causal, segment_ids=ids)
        grads = torch.autograd.grad((o * torch.as_tensor(g)).sum(), leaves)
        res = {"out": o.detach(), "grads": [t.detach() for t in grads]}
        n = axes.get("sp", 1)
        if n == torch.distributed.get_world_size() and q.shape[2] % n == 0:
            res["local"] = ra.ring_attention_local(*(torch.as_tensor(t) for t in (q, k, v)), n, causal=causal,
                                                   segment_ids=ids).detach()
        out[name] = res
    return out


def job_sp_logits(ctx, variables, cfg, batch, axes):
    """The transformer (the JAX model's weights) on ``ctx.mesh(axes)``, every
    rank on all rows and its block of the sequence (L divisible by sp):
    its block of the logits and its sp index."""
    from tensorflowonspark_tpu_torch.parallel import collectives

    mesh, _, _, _, state = _lm_state(ctx, variables, cfg, axes)
    n, i = collectives.axis_size("sp", mesh), collectives.axis_index("sp", mesh)
    mine = {k: torch.as_tensor(v).chunk(n, 1)[i].contiguous() for k, v in batch.items()}
    with torch.no_grad():
        logits = state.module(mine["tokens"], positions=mine.get("positions"), segment_ids=mine.get("segment_ids"))
    return {"logits": logits, "sp_index": i, "sp": n}


def tanh_stage(params, x):
    """The JAX package's pipeline tests' stage: ``tanh(x @ w)``."""
    return torch.tanh(x @ params["w"])


def job_pipeline(ctx, cases):
    """``pipeline_apply`` of :func:`tanh_stage` on each case's mesh
    (``{name: (axes, batch_axis, stacked w [P, d, d], microbatches [M, b,
    d])}``), every rank on the whole inputs: the output, this rank's stage
    and the gradient of ``sum(out²)`` for its row (the other rows'
    gradients must be zero on it)."""
    from tensorflowonspark_tpu_torch.parallel import collectives, pipeline_apply

    out = {}
    for name, (axes, batch_axis, w, x) in cases.items():
        mesh = ctx.mesh(axes)
        stacked = {"w": torch.as_tensor(w).clone().requires_grad_()}
        y = pipeline_apply(tanh_stage, stacked, torch.as_tensor(x), mesh, batch_axis=batch_axis)
        (g,) = torch.autograd.grad((y ** 2).sum(), [stacked["w"]])
        stage = collectives.axis_index("pp", mesh)
        others = torch.cat([g[:stage], g[stage + 1:]])
        out[name] = {"y": y.detach(), "stage": stage, "grad_row": g[stage],
                     "other_rows_zero": bool((others == 0).all())}
    return out


def job_hostgroup(ctx):
    """``HostAllReduceGroup`` bootstrapped through the world (no
    ``root_address``): over the whole world, and one group a ``tp``
    position over the ``dp`` ranks of a ``{"dp": 2, "tp": 2}`` mesh; each on
    distinct per-rank payloads."""
    import numpy as np
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.parallel import HostAllReduceGroup, collectives

    rank, world = ctx.process_id, dist.get_world_size()
    with HostAllReduceGroup(rank, world) as group:
        whole = group.allreduce_mean(np.arange(8, dtype=np.float32) + 10.0 * rank)
    mesh = ctx.mesh({"dp": 2, "tp": 2})
    dp = mesh.get_group("dp")
    with HostAllReduceGroup(dist.get_rank(dp), dist.get_world_size(dp), process_group=dp) as group:
        per_tp = group.allreduce_mean(np.arange(4, dtype=np.float32) * (rank + 1))
    return {"world": whole, "dp": per_tp, "tp_index": collectives.axis_index("tp", mesh),
            "fsdp_refusal": _fsdp_refusal(ctx)}


def _fsdp_refusal(ctx):
    from tensorflowonspark_tpu_torch.train import BucketedOverlap, SyncDataParallel, optim

    strategy = SyncDataParallel(ctx.mesh({"dp": 2, "fsdp": 2}), fsdp=True)
    try:
        BucketedOverlap(strategy, mlp_loss, optim.adam(1e-2))
    except ValueError as e:
        return str(e)
    return None


def job_overlap_mlp(ctx, w1, w2, batches, steps):
    """The JAX package's 2-rank overlap world: an exact mean of distinct
    per-rank payloads through a ``HostAllReduceGroup`` bootstrapped over the
    world, then ``BucketedOverlap`` of the MLP on this rank's microbatches
    (``batches[rank]``), ``steps`` Adam steps with overlap on and off."""
    import numpy as np
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.parallel import HostAllReduceGroup
    from tensorflowonspark_tpu_torch.train import BucketedOverlap, SyncDataParallel, optim

    rank, world = ctx.process_id, dist.get_world_size()
    out = {}
    with HostAllReduceGroup(rank, world) as group:
        reduced = group.allreduce_mean(np.arange(8, dtype=np.float32) + 10.0 * rank)
        expect = np.mean([np.arange(8, dtype=np.float32) + 10.0 * r for r in range(world)], axis=0)
        out["reduce_exact"] = bool(np.array_equal(reduced, expect))
        strategy = SyncDataParallel("cpu")
        for overlap in (True, False):
            opt = optim.adam(1e-2)
            state = strategy.create_state(lambda: Mlp(w1, w2), opt)
            sched = BucketedOverlap(strategy, mlp_loss, opt, group=group, bucket_bytes=1 << 14,
                                    overlap=overlap)
            mbs = [strategy.shard_batch(b) for b in batches[rank]]
            losses = []
            for _ in range(steps):
                state, metrics = sched.step(state, mbs)
                losses.append(float(metrics["loss"]))
            sched.close()
            out["losses_on" if overlap else "losses_off"] = losses
    return out


def job_overlap_tp(ctx, variables, cfg, batches, steps, lr):
    """``BucketedOverlap`` of the transformer on a ``{"dp": 2, "tp": 2}``
    mesh (built from this rank's tp blocks of the JAX model's ``variables``),
    one host group a tp position over the dp ranks, each rank on its data
    rows of the microbatches ``batches``: the losses, the full (gathered)
    parameters after ``steps`` SGD steps, and the module's blocks before and
    after."""
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.parallel import HostAllReduceGroup
    from tensorflowonspark_tpu_torch.train import BucketedOverlap, optim

    axes = {"dp": 2, "tp": 2}
    mesh = ctx.mesh(axes)
    strategy = _axes_strategy(mesh, axes)
    model = transformer.create_model(mesh=mesh, **cfg)
    opt = optim.sgd(lr)
    state = strategy.create_state(lambda: convert.load_variables(model, {"params": variables}), opt)
    shapes = {n: tuple(p.shape) for n, p in state.module.named_parameters()}
    loss_fn = transformer.make_loss_fn(model)
    mbs = [strategy.shard_batch(_lm_rows(mesh, b)) for b in batches]
    dp = mesh.get_group("dp")
    losses = []
    with HostAllReduceGroup(dist.get_rank(dp), dist.get_world_size(dp), process_group=dp) as group:
        sched = BucketedOverlap(strategy, loss_fn, opt, group=group, has_aux=True)
        for _ in range(steps):
            state, metrics = sched.step(state, mbs)
            losses.append(float(metrics["loss"]))
        sched.close()
    return {"losses": losses, "params": _full_params(state), "model_specs": dict(state.module.model_specs),
            "shapes_kept": shapes == {n: tuple(p.shape) for n, p in state.module.named_parameters()}}
