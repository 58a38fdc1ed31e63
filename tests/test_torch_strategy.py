"""The port's SyncDataParallel train step and SGD against jax.value_and_grad
plus optax.sgd, on the CPU.

A small ResNet with bn_impl='pallas' (the port's plain versions of the
kernels here, the JAX package's Pallas kernels in interpret mode) takes three
steps of make_loss_fn(weight_decay=1e-4) and SGD momentum 0.9 from the same
converted weights on the same batches, with a constant learning rate and with
the ImageNet example's warmup schedule (which starts at lr 0). Params,
momentum traces and BN statistics agree within 1e-4 and the loss of every
step within 1e-4: float32 throughout, the two sides differ only in summation
order.
"""

import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu.models import resnet as jax_resnet
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.examples.resnet import profile_step, resnet_spark
from tensorflowonspark_tpu_torch.models import resnet
from tensorflowonspark_tpu_torch.ops import kernel_trace
from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim
from tensorflowonspark_tpu_torch.train import strategy as strategy_mod

CFG = dict(stage_sizes=(1, 1), filters=(8, 16), num_classes=10, bottleneck=True, stem="imagenet")
STEPS = 3


def _reference_lr_schedule(args):
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "resnet", "resnet_spark.py")
    spec = importlib.util.spec_from_file_location("reference_resnet_spark", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lr_schedule(args)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("schedule", ["constant", "imagenet_warmup"])
def test_three_sgd_steps_match_optax(schedule):
    rng = np.random.default_rng(11)
    batches = [
        {"image": rng.standard_normal((4, 16, 16, 3)).astype(np.float32),
         "label": rng.integers(0, 10, 4)}
        for _ in range(STEPS)
    ]
    if schedule == "constant":
        jax_lr, port_lr = 0.1, 0.1
    else:
        # steps_per_epoch=1: warmup over 5 steps from 0, so the steps take
        # lr 0, base/5, 2·base/5
        args = types.SimpleNamespace(dataset="imagenet", batch_size=256, steps_per_epoch=1)
        jax_lr, port_lr = _reference_lr_schedule(args), resnet_spark.lr_schedule(args)

    jmodel = jax_resnet.ResNet(bn_impl="pallas", **CFG)
    variables = _np_tree(jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False))(
        jnp.asarray(batches[0]["image"])))
    tx = optax.sgd(jax_lr, momentum=0.9)
    jloss_fn = jax_resnet.make_loss_fn(jmodel, weight_decay=1e-4)

    @jax.jit
    def jax_step(params, opt_state, model_state, batch):
        (loss, (model_state, _)), grads = jax.value_and_grad(jloss_fn, has_aux=True)(
            params, model_state, batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, model_state, loss

    params, model_state = variables["params"], {"batch_stats": variables["batch_stats"]}
    opt_state = tx.init(params)

    strategy = SyncDataParallel("cpu")
    optimizer = optim.sgd(port_lr, momentum=0.9)
    state = strategy.create_state(
        lambda: convert.load_variables(resnet.ResNet(bn_impl="pallas", **CFG), variables), optimizer
    )
    step = strategy.compile_train_step(resnet.make_loss_fn(weight_decay=1e-4), optimizer, mutable=True)

    for i, batch in enumerate(batches):
        params, opt_state, model_state, jloss = jax_step(
            params, opt_state, model_state, {k: jnp.asarray(v) for k, v in batch.items()})
        state, metrics = step(state, strategy.shard_batch(batch))
        np.testing.assert_allclose(float(metrics["loss"]), float(jloss), atol=1e-4, err_msg="step %d" % i)
        assert metrics["step"] == i + 1 and "accuracy" in metrics

    want = convert.convert_variables({"params": _np_tree(params), "batch_stats": _np_tree(model_state["batch_stats"])})
    got = dict(state.params, **state.model_state)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(), atol=1e-4, err_msg=name)
    trace = convert.convert_variables({"params": _np_tree(opt_state[0].trace)})
    for name, value in trace.items():
        np.testing.assert_allclose(state.opt_state["trace"][name].numpy(), value.numpy(), atol=1e-4, err_msg=name)
    assert state.opt_state["count"] == STEPS


@pytest.mark.parametrize("count", [0, 1, 4, 5, 6, 90, 91, 136, 137])
def test_schedules_match_optax(count):
    pairs = [
        (optim.linear_schedule(0.0, 0.25, 5), optax.linear_schedule(0.0, 0.25, 5)),
        (optim.linear_schedule(1.0, 0.5, 0), optax.linear_schedule(1.0, 0.5, 0)),
        (optim.piecewise_constant_schedule(0.1, {91: 0.1, 136: 0.1}),
         optax.piecewise_constant_schedule(0.1, {91: 0.1, 136: 0.1})),
    ]
    for port, ref in pairs:
        np.testing.assert_allclose(port(count), float(ref(count)), rtol=1e-6)


def test_unported_strategy_modes_raise():
    with pytest.raises(NotImplementedError):
        SyncDataParallel("cpu", fsdp=True)
    with pytest.raises(NotImplementedError):
        SyncDataParallel("cpu", tp=True)


def test_default_device_is_the_card(monkeypatch):
    """With no device, the strategy takes the card and raises without one;
    it never settles on the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyncDataParallel()
    asked = []
    monkeypatch.setattr(strategy_mod.util, "select_device",
                        lambda platform: asked.append(platform) or torch.device("cpu"))
    assert SyncDataParallel().device == torch.device("cpu") and asked == ["gpu"]
    assert SyncDataParallel("cpu").device == torch.device("cpu") and asked == ["gpu"]


def test_step_phases_read_from_a_trace():
    """The step's forward/backward/optimizer profiler ranges, as the step
    profiler reads them from one trace (on the CPU no kernel runs on a
    device, so the device is idle for the whole window)."""
    strategy = SyncDataParallel("cpu")
    optimizer = optim.sgd(0.1, momentum=0.9)
    state = strategy.create_state(lambda: resnet.ResNet(bn_impl="pallas", **CFG), optimizer)
    step = strategy.compile_train_step(resnet.make_loss_fn(weight_decay=1e-4), optimizer, mutable=True)
    rng = np.random.default_rng(0)
    batch = strategy.shard_batch({"image": rng.standard_normal((2, 16, 16, 3)).astype(np.float32),
                                  "label": rng.integers(0, 10, 2)})
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("profile_window"):
            for _ in range(2):
                state, _ = step(state, batch)
    out = profile_step.read_trace(prof.events(), 2)
    assert set(out["phase_host_ms"]) == set(profile_step.PHASES)
    assert all(ms > 0 for ms in out["phase_host_ms"].values())
    assert sum(out["phase_host_ms"].values()) <= out["window_ms_per_step"]
    assert out["device_kernels_per_step"] == 0 and out["device_idle_share"] == 1.0


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0), ([(0, 2), (1, 3)], 3.0), ([(5, 6), (0, 2)], 3.0), ([(0, 10), (2, 3), (4, 12)], 12.0),
])
def test_union_of_kernel_intervals(intervals, want):
    assert kernel_trace.union_us(intervals) == want


def test_step_keyword_and_plain_loss_contract():
    """A non-mutable loss with has_aux, and a loss that declares ``step``,
    as in the JAX version's contract."""
    strategy = SyncDataParallel("cpu")
    optimizer = optim.sgd(0.1)
    state = strategy.create_state(lambda: torch.nn.Linear(2, 1, bias=False), optimizer)
    seen = []

    def loss_fn(module, batch, step):
        seen.append(step)
        loss = module(batch["x"]).square().mean()
        return loss, {"out": loss.detach()}

    step = strategy.compile_train_step(loss_fn, optimizer, has_aux=True)
    batch = strategy.shard_batch({"x": np.ones((3, 2), np.float32)})
    w0 = state.module.weight.detach().clone()
    for _ in range(2):
        state, metrics = step(state, batch)
    assert seen == [0, 1] and metrics["step"] == 2 and "out" in metrics
    assert not torch.equal(w0, state.module.weight)
