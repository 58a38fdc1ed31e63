"""Synchronous data parallelism with global BatchNorm statistics and global
metrics: the port's two-rank gloo world against the JAX package's
``SyncDataParallel`` on a two-device CPU mesh, on the CPU.

The JAX package's SPMD step sees the whole batch sharded over ``dp``, so
its BatchNorm statistics (both ``bn_impl``s; the Pallas kernels run in
interpret mode) and its loss are over the global batch. The port runs one
process a rank, each holding one half of the same global batch (numpy,
seeded): the statistics and their gradient are reduced across the ranks,
and the loss and aux metrics are averaged with the gradients.

Held within ``test_fused_bn.py``'s 1e-4 (float32, the two sides sum in
other orders): a BN layer's batch mean and variance, output and input
gradient; then a small ResNet's loss at each of 2 SGD steps, its parameters
after them and its running statistics, on converted weights. Both ranks
hold equal running statistics and report the same loss.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from jax.sharding import NamedSharding, PartitionSpec

from tensorflowonspark_tpu import parallel
from tensorflowonspark_tpu.models import resnet as jax_resnet
from tensorflowonspark_tpu.ops import fused_bn as jax_fused_bn
from tensorflowonspark_tpu.train import SyncDataParallel as JaxSyncDataParallel
from tensorflowonspark_tpu_torch import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TOL = 1e-4
CFG = dict(stage_sizes=(1, 1), filters=(8, 16), bottleneck=False, stem="cifar", num_classes=10)

#: one rank of the port's world: ``python -c WORKER rank world port job out``
WORKER = r"""
import sys

import numpy as np
import torch
import torch.distributed as dist

rank, world, port, job, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port, rank=rank, world_size=world)
spec = torch.load(job, weights_only=False)


def half(a):
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


result = {}
if spec["kind"] == "bn":
    from tensorflowonspark_tpu_torch.ops import fused_bn

    cls = fused_bn.FusedBatchNorm if spec["bn_impl"] == "pallas" else fused_bn.BatchNorm
    bn = cls(spec["gamma"].shape[0]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(spec["gamma"]))
        bn.bias.copy_(torch.from_numpy(spec["beta"]))
    x = torch.from_numpy(half(spec["x"])).requires_grad_()
    y, mean, var = bn._train_forward(x)
    (y * torch.from_numpy(half(spec["dy"]))).sum().backward()
    grads = torch.stack([bn.weight.grad, bn.bias.grad])
    dist.all_reduce(grads)  # the strategy's average of the ranks' gradients
    grads /= world
    result = {"mean": mean, "var": var, "y": y.detach(), "dx": x.grad,
              "dgamma": grads[0], "dbeta": grads[1]}
else:
    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.models import resnet
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

    strategy = SyncDataParallel("cpu")
    optimizer = optim.sgd(0.1, momentum=0.9)
    state = strategy.create_state(
        lambda: convert.load_variables(resnet.ResNet(bn_impl=spec["bn_impl"], **spec["cfg"]),
                                       spec["variables"]), optimizer)
    step = strategy.compile_train_step(resnet.make_loss_fn(weight_decay=1e-4), optimizer, mutable=True)
    losses, accuracy = [], []
    for batch in spec["batches"]:
        state, metrics = step(state, strategy.shard_batch({k: half(v) for k, v in batch.items()}))
        losses.append(float(metrics["loss"]))
        accuracy.append(float(metrics["accuracy"]))
    result = {"losses": losses, "accuracy": accuracy,
              "params": {k: v.detach() for k, v in state.params.items()},
              "buffers": {k: v.clone() for k, v in state.model_state.items()}}
torch.save(result, out)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(tmp_path, spec, world=WORLD):
    """Run ``WORKER`` on ``spec`` in a ``world``-rank gloo world of
    processes; returns each rank's result."""
    job = str(tmp_path / "job.pt")
    torch.save(spec, job)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = [str(tmp_path / "rank{}.pt".format(r)) for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(port), job, outs[r]],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(o, weights_only=False) for o in outs]


def _mesh():
    return parallel.build_mesh({"dp": WORLD}, devices=jax.devices()[:WORLD])


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("bn_impl", ["flax", "pallas"])
def test_batch_statistics_and_their_gradient_are_global(tmp_path, bn_impl):
    """A BN layer on a [8, 4, 4, 16] batch whose second half is shifted by
    3, so the halves' means differ from the global one by 1.5: each rank's
    mean and var are the global batch's, its output and input gradient
    match the reference's rows, and the ranks' averaged dgamma/dbeta are
    the reference's (the ranks' objectives, summed, are the reference's
    global sum, which the strategy's average divides by the world)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 4, 4, 16)).astype(np.float32) * 1.5
    x[4:] += 3.0
    dy = rng.standard_normal(x.shape).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(16)).astype(np.float32)

    mesh = _mesh()
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, PartitionSpec("dp")))
    if bn_impl == "pallas":
        def forward(x, g, b):
            return jax_fused_bn.fused_batch_norm(x, g, b, interpret=True)
    else:
        module = nn.BatchNorm(use_running_average=False, momentum=0.0, epsilon=1e-5)

        def forward(x, g, b):
            y, upd = module.apply({"params": {"scale": g, "bias": b},
                                   "batch_stats": {"mean": jnp.zeros(16), "var": jnp.ones(16)}},
                                  x, mutable=["batch_stats"])
            return y, upd["batch_stats"]["mean"], upd["batch_stats"]["var"]  # momentum 0: the batch's

    @jax.jit
    def reference(x, g, b):
        (y, mean, var), vjp = jax.vjp(forward, x, g, b)
        dx, dg, db = vjp((jnp.asarray(dy), jnp.zeros_like(mean), jnp.zeros_like(var)))
        return y, mean, var, dx, dg, db

    want = _np(reference(xs, jnp.asarray(gamma), jnp.asarray(beta)))
    assert abs(want[1].mean() - float(x.mean())) < 1e-5  # global, not a shard's
    ranks = run_world(tmp_path, {"kind": "bn", "bn_impl": bn_impl, "x": x, "dy": dy,
                                 "gamma": gamma, "beta": beta})
    rows = x.shape[0] // WORLD
    for r, got in enumerate(ranks):
        sl = slice(r * rows, (r + 1) * rows)
        np.testing.assert_allclose(got["mean"].numpy(), want[1], atol=TOL)
        np.testing.assert_allclose(got["var"].numpy(), want[2], atol=TOL)
        np.testing.assert_allclose(got["y"].numpy(), want[0][sl], atol=TOL)
        np.testing.assert_allclose(got["dx"].numpy(), want[3][sl], atol=TOL)
        np.testing.assert_allclose(got["dgamma"].numpy(), want[4] / WORLD, atol=TOL)
        np.testing.assert_allclose(got["dbeta"].numpy(), want[5] / WORLD, atol=TOL)
    for name in ("mean", "var", "dgamma", "dbeta"):
        assert torch.equal(ranks[0][name], ranks[1][name]), name


@pytest.mark.parametrize("bn_impl", ["flax", "pallas"])
def test_two_rank_world_matches_the_reference_two_device_mesh(tmp_path, bn_impl):
    """Two SGD steps (momentum 0.9, L2 in the loss) of the small CIFAR
    ResNet from the same converted weights on the same global batches of
    8: every step's loss and accuracy (both ranks, the global batch's),
    the parameters after the steps and the running statistics, within
    1e-4 of the reference; the ranks' running statistics equal."""
    rng = np.random.default_rng(5)
    batches = [{"image": rng.standard_normal((8, 8, 8, 3)).astype(np.float32),
                "label": rng.integers(0, 10, 8)} for _ in range(2)]
    for b in batches:
        b["image"][4:] += 1.0  # the halves' statistics differ from the global batch's
    jmodel = jax_resnet.ResNet(bn_impl=bn_impl, **CFG)
    variables = _np(jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False))(
        jnp.asarray(batches[0]["image"])))

    strategy = JaxSyncDataParallel(_mesh())
    tx = optax.sgd(0.1, momentum=0.9)
    state = strategy.create_state(lambda: variables, tx)
    step = strategy.compile_train_step(jax_resnet.make_loss_fn(jmodel, weight_decay=1e-4), tx,
                                       mutable=True, donate=False)
    want_losses, want_accuracy = [], []
    for b in batches:
        state, metrics = step(state, strategy.shard_batch(b))
        want_losses.append(float(metrics["loss"]))
        want_accuracy.append(float(metrics["accuracy"]))
    want = convert.convert_variables({"params": _np(state.params),
                                      "batch_stats": _np(state.model_state["batch_stats"])})

    ranks = run_world(tmp_path, {"kind": "resnet", "bn_impl": bn_impl, "cfg": CFG,
                                 "variables": variables, "batches": batches})
    for got in ranks:
        np.testing.assert_allclose(got["losses"], want_losses, atol=TOL)
        np.testing.assert_allclose(got["accuracy"], want_accuracy, atol=1e-6)
        state_dict = dict(got["params"], **got["buffers"])
        for name, value in want.items():
            np.testing.assert_allclose(state_dict[name].numpy(), value.numpy(), atol=TOL, err_msg=name)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for name, value in ranks[0]["buffers"].items():
        assert torch.equal(value, ranks[1]["buffers"][name]), name
