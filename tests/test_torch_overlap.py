"""The host all-reduce group and bucketed overlap on the port, held against
the JAX package's ``parallel/hostreduce.py`` and ``train.BucketedOverlap``.

The cases of the JAX package's ``tests/test_multichip.py`` (193-330 and its
gloo worlds):

* single process: overlap on and off bitwise equal with the loss descending
  and the measured overlap fraction > 0 on, exactly 0 off; 2 buckets at
  4,096 bytes; the empty-microbatch error; the loss trajectory within 1e-5
  of the JAX package's ``BucketedOverlap`` on the same MLP (weights drawn by
  the JAX package's init) and microbatches;
* ``HostAllReduceGroup`` members on loopback threads: the exact mean,
  bitwise equal on every member; the error without a world or an address;
* a 4-rank gloo world (``tests/torch_world_util.py``): the group
  bootstrapped through the world (``broadcast_object_list``), over the
  world and one group a ``tp`` position over the ``dp`` ranks; the fsdp
  refusal's text; ``BucketedOverlap`` of the transformer on ``{"dp": 2,
  "tp": 2}`` (blocks stay the rank's) against the JAX package's replicated
  model trained by the same SGD on the same microbatches, within 1e-5;
* (slow, as in the JAX package) a 2-rank world: exact mean, ranks equal,
  overlap on/off bitwise.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu import parallel as jparallel
from tensorflowonspark_tpu.models import transformer as jtransformer
from tensorflowonspark_tpu.train import BucketedOverlap as JBucketedOverlap
from tensorflowonspark_tpu.train import SyncDataParallel as JSyncDataParallel
from tensorflowonspark_tpu_torch import obs
from tensorflowonspark_tpu_torch.parallel import HostAllReduceGroup
from tensorflowonspark_tpu_torch.train import BucketedOverlap, SyncDataParallel, optim

from torch_world_util import Mlp, mlp_loss, run_world

TRAJECTORY_TOL = 1e-5
LM_CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64, dtype="float32", attention="plain")


def _mlp_weights():
    """The JAX package's MLP init (``tests/test_multichip.py::_mlp_setup``)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return (np.array(jax.random.normal(k1, (64, 64)) * 0.1),
            np.array(jax.random.normal(k2, (64, 8)) * 0.1))


def _host_microbatches(seed, n, rows=8):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(rows, 64)).astype(np.float32),
             "y": rng.normal(size=(rows, 8)).astype(np.float32)} for _ in range(n)]


def _port_losses(overlap, steps=4, bucket_bytes=4096, n=3):
    w1, w2 = _mlp_weights()
    strategy = SyncDataParallel("cpu")
    opt = optim.adam(1e-2)
    state = strategy.create_state(lambda: Mlp(w1, w2), opt)
    sched = BucketedOverlap(strategy, mlp_loss, opt, bucket_bytes=bucket_bytes, overlap=overlap)
    mbs = [strategy.shard_batch(b) for b in _host_microbatches(11, n)]
    losses = []
    try:
        for _ in range(steps):
            state, metrics = sched.step(state, mbs)
            losses.append(float(metrics["loss"]))
    finally:
        sched.close()
    return losses, dict(sched.last_stats), sched


def test_on_off_bit_identical_and_training_progresses():
    on, stats_on, _ = _port_losses(True)
    off, stats_off, _ = _port_losses(False)
    assert on == off, (on, off)  # bitwise: same work, same order
    assert on[-1] < on[0]
    # overlap=False joins the comm thread before the next dispatch, so by
    # construction no comm second coincides with later device work
    assert stats_off["overlap_fraction"] == 0.0
    assert stats_on["overlap_fraction"] > 0.0, stats_on
    assert obs.gauge("comm_overlap_fraction").value == stats_off["overlap_fraction"]


def test_trajectory_matches_the_jax_package():
    def init_fn(rng):
        k1, k2 = jax.random.split(rng)
        return {"w1": jax.random.normal(k1, (64, 64)) * 0.1, "w2": jax.random.normal(k2, (64, 8)) * 0.1}

    def loss_fn(params, batch):
        h = jnp.tanh(batch["x"] @ params["w1"])
        return jnp.mean((h @ params["w2"] - batch["y"]) ** 2)

    strategy = JSyncDataParallel(jparallel.local_mesh({"dp": -1}))
    opt = optax.adam(1e-2)
    state = strategy.create_state(init_fn, opt, jax.random.PRNGKey(0))
    sched = JBucketedOverlap(strategy, loss_fn, opt, bucket_bytes=4096)
    mbs = [strategy.shard_batch(b) for b in _host_microbatches(11, 3)]
    want = []
    try:
        for _ in range(4):
            state, metrics = sched.step(state, mbs)
            want.append(float(metrics["loss"]))
    finally:
        sched.close()
    got, _, _ = _port_losses(True)
    np.testing.assert_allclose(got, want, atol=TRAJECTORY_TOL, rtol=0)


def test_multiple_buckets_partition():
    _, stats, sched = _port_losses(True, steps=1, n=1)
    # w1 (16 KiB) exceeds the 4 KiB bound -> its own bucket; w2 fits
    assert len(sched._buckets) == 2 == stats["buckets"], sched._buckets


def test_empty_microbatches_raise():
    strategy = SyncDataParallel("cpu")
    opt = optim.adam(1e-2)
    state = strategy.create_state(lambda: Mlp(*_mlp_weights()), opt)
    sched = BucketedOverlap(strategy, mlp_loss, opt)
    with pytest.raises(ValueError, match="at least one microbatch"):
        sched.step(state, [])
    sched.close()


def _free_address():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return "127.0.0.1:{}".format(s.getsockname()[1])


def test_host_group_members_reduce_exactly_on_loopback_threads():
    """Three members on threads of this process: the rank-order mean of
    distinct payloads, bitwise equal on every member, call after call."""
    address, world, out = _free_address(), 3, {}

    def member(rank):
        with HostAllReduceGroup(rank, world, root_address=address, timeout=30) as group:
            out[rank] = [group.allreduce_mean(np.arange(6, dtype=np.float32) * 0.1 + i + rank)
                         for i in range(3)]

    threads = [threading.Thread(target=member, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for i in range(3):
        acc = np.arange(6, dtype=np.float32) * 0.1 + i + 0
        for r in range(1, world):
            acc = acc + (np.arange(6, dtype=np.float32) * 0.1 + i + r)
        want = acc / world
        for r in range(world):
            assert out[r][i].tobytes() == want.tobytes()
    assert obs.gauge("comm_bucket_bytes").value == 24


def test_host_group_of_one_and_the_bootstrap_error():
    with HostAllReduceGroup(0, 1) as group:
        buf = np.arange(4, dtype=np.float32)
        got = group.allreduce_mean(buf)
        assert got is not buf and np.array_equal(got, buf)
    with pytest.raises(RuntimeError, match="needs root_address when torch.distributed is not initialized"):
        HostAllReduceGroup(1, 2)


def _jax_lm_params():
    model = jtransformer.create_model(**LM_CFG)
    params = jax.jit(jtransformer.make_init_fn(model, sample_len=16))(jax.random.PRNGKey(0))["params"]
    return model, jax.tree.map(lambda a: np.array(a), params)


def _lm_microbatches():
    rng = np.random.default_rng(7)
    return [{"tokens": rng.integers(0, 64, (4, 16)).astype(np.int32)} for _ in range(2)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    _, params = _jax_lm_params()
    spec = {
        "group": ("job_hostgroup", {}),
        "overlap_tp": ("job_overlap_tp", dict(variables=params, cfg=LM_CFG, batches=_lm_microbatches(),
                                              steps=2, lr=0.1)),
    }
    return run_world(tmp_path_factory.mktemp("overlap"), spec)


def test_host_group_bootstraps_through_the_world(world):
    want = np.mean([np.arange(8, dtype=np.float32) + 10.0 * r for r in range(4)], axis=0)
    for rank, result in enumerate(world):
        got = result["group"]
        assert got["world"].tobytes() == want.tobytes()
        # {"dp": 2, "tp": 2}: rank = 2 dp + tp, the dp ranks of position tp
        # are tp and tp + 2
        tp = got["tp_index"]
        assert tp == rank % 2
        dp_want = (np.arange(4, dtype=np.float32) * (tp + 1) + np.arange(4, dtype=np.float32) * (tp + 3)) / 2
        assert got["dp"].tobytes() == dp_want.tobytes()


def test_rejects_fsdp_strategy_naming_axes(world):
    text = world[0]["group"]["fsdp_refusal"]
    assert text is not None and "axes ('fsdp',)" in text and "dp x tp" in text


def test_dp_tp_overlap_matches_the_replicated_jax_model(world):
    """dp×tp: each tp position's host group averages over the dp ranks, the
    blocks stay the rank's, and the SGD trajectory equals the JAX package's
    unsharded model's (grad accumulation over the same microbatches)."""
    model, params = _jax_lm_params()
    loss = jtransformer.make_loss_fn(model)
    grad = jax.jit(jax.value_and_grad(lambda p, b: loss(p, b)[0]))
    tx = optax.sgd(0.1)
    opt_state = tx.init(params)
    mbs = [{k: jnp.asarray(v) for k, v in b.items()} for b in _lm_microbatches()]
    want = []
    for _ in range(2):
        out = [grad(params, b) for b in mbs]
        want.append(float(np.mean([float(v) for v, _ in out])))
        grads = jax.tree.map(lambda *g: sum(g) / len(g), *[g for _, g in out])
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    from tensorflowonspark_tpu_torch import convert

    full = convert.convert_variables({"params": jax.tree.map(np.asarray, params)})
    for result in world:
        got = result["overlap_tp"]
        np.testing.assert_allclose(got["losses"], want, atol=TRAJECTORY_TOL, rtol=0)
        assert got["shapes_kept"] and got["model_specs"]
        for name, tensor in got["params"].items():
            torch.testing.assert_close(tensor, full[name], atol=TRAJECTORY_TOL, rtol=0, msg=name)
    assert all(r["overlap_tp"]["losses"] == world[0]["overlap_tp"]["losses"] for r in world)


@pytest.mark.slow
def test_two_rank_determinism_and_overlap(tmp_path):
    """2-rank gloo world: the host all-reduce is exact and rank-order
    deterministic, every rank sees the same loss trajectory (it is a global
    mean), and the trajectory is bitwise equal with overlap on or off."""
    w1, w2 = _mlp_weights()
    batches = [_host_microbatches(100 + r, 2) for r in range(2)]
    results = run_world(tmp_path, {"mlp": ("job_overlap_mlp", dict(w1=w1, w2=w2, batches=batches, steps=4))},
                        world=2)
    results = [r["mlp"] for r in results]
    assert all(r["reduce_exact"] for r in results), results
    assert results[0]["losses_on"] == results[1]["losses_on"]
    assert results[0]["losses_on"] == results[0]["losses_off"]
    assert results[0]["losses_off"] == results[1]["losses_off"]
    assert results[0]["losses_on"][-1] < results[0]["losses_on"][0]
