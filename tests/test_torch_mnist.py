"""The port's MNIST models, ``optim.adam`` and ``train/metrics.py`` against
the JAX package, on the CPU.

Inputs come from numpy with a seed and the JAX package's weights are
converted by ``convert.load_variables``:

* logits of ``MnistMLP`` and ``MnistCNN`` (at ``train=False``) within 2e-5;
* five ``adam`` steps of the MLP at ``dropout_rate=0``, the JAX package's
  ``SyncDataParallel`` on one CPU device against the port's: parameters
  within 1e-5, losses within 1e-6 relative;
* the CNN's gradients of the eval-mode loss within 1e-5 (the JAX CNN's
  dropout rate is fixed at 0.5, and jax's masks cannot be drawn in torch,
  so no train step can be matched);
* the port's dropout: a mask that is a function of ``(dropout_seed, step)``
  alone, a kept share within a binomial bound of ``1 - rate`` and flax's
  ``1/(1-rate)`` scaling;
* ``optim.adam`` against ``optax.adam`` for five steps, and
  ``convert.convert_train_state`` of an ``optax.adam`` state;
* ``TimeHistory`` / ``build_stats`` on the cases of
  ``tests/test_train_metrics.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tensorflowonspark_tpu import parallel
from tensorflowonspark_tpu.models import mnist as jmnist
from tensorflowonspark_tpu.train import SyncDataParallel as JaxSyncDataParallel
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup import synthetic_mnist
from tensorflowonspark_tpu_torch.models import get_model, mnist
from tensorflowonspark_tpu_torch.train import SyncDataParallel, TimeHistory, build_stats, optim

LOGIT_TOL = 2e-5
PARAM_TOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _batch(seed, n=16):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((n, 28, 28), dtype=np.float32), "label": rng.integers(0, 10, n)}


def _models(kind, **cfg):
    """(JAX module, its host variables, the port's module loaded with them)."""
    jmodel = jmnist.create_model(kind, **cfg)
    variables = _np(jmnist.make_init_fn(jmodel)(jax.random.PRNGKey(0)))
    port = convert.load_variables(mnist.create_model(kind, **cfg), variables)
    return jmodel, variables, port


@pytest.mark.parametrize("kind,cfg", [("mlp", {}), ("mlp", {"hidden": 64}), ("cnn", {})],
                         ids=["mlp", "mlp-hidden64", "cnn"])
def test_logits_match_the_jax_module(kind, cfg):
    """Same weights (converted strictly: every key and shape matched), same
    inputs: the flatten order, SAME convs and VALID pools agree."""
    jmodel, variables, port = _models(kind, **cfg)
    x = _batch(1)["image"]
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    got = port(torch.from_numpy(x), train=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == (16, 10)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=LOGIT_TOL)
    # the CNN also takes NHWC input with a channel axis
    if kind == "cnn":
        np.testing.assert_allclose(port(torch.from_numpy(x[..., None])).detach().numpy(), want, atol=LOGIT_TOL)


def test_jax_variables_load_strictly():
    """``convert_variables`` maps Dense and Conv with no special case, and a
    mismatched width is refused."""
    for kind in ("mlp", "cnn"):
        _, variables, port = _models(kind)
        names = set(convert.convert_variables(variables, port))
        assert names == set(port.state_dict())
    _, variables, _ = _models("mlp", hidden=64)
    with pytest.raises(ValueError, match="shape"):
        convert.load_variables(mnist.MnistMLP(hidden=32), variables)


def _train_batches(n=64, steps=5):
    """``n * steps`` rows from the MNIST examples' data generator
    (``synthetic_mnist``, its default seed), in the examples' batches of 64."""
    images, labels = synthetic_mnist(n * steps)
    return [{"image": images[i * n:(i + 1) * n], "label": labels[i * n:(i + 1) * n]} for i in range(steps)]


def test_mlp_adam_steps_match_the_jax_strategy():
    """Five ``adam`` steps of the MLP at ``dropout_rate=0`` through both
    packages' ``SyncDataParallel`` (the JAX one on one CPU device), on the
    examples' data and batch size. (Adam's update ``g/(|g| + 1e-8)``
    turns f32 rounding noise in a gradient that cancels to ~1e-8 into a
    ~1% difference of one step: at 16-row batches one weight in 4e5 can end
    1.2e-5 to 3.9e-5 apart, depending on the rows.)"""
    jmodel, variables, port = _models("mlp", dropout_rate=0.0)
    jstrategy = JaxSyncDataParallel(parallel.build_mesh({"dp": 1}, devices=jax.devices()[:1]))
    tx = optax.adam(1e-3)
    jstate = jstrategy.create_state(lambda: variables, tx)
    jstep = jstrategy.compile_train_step(jmnist.make_loss_fn(jmodel), tx, has_aux=True, donate=False)
    strategy = SyncDataParallel("cpu")
    optimizer = optim.adam(1e-3)
    state = strategy.create_state(lambda: port, optimizer)
    step = strategy.compile_train_step(mnist.make_loss_fn(port), optimizer, has_aux=True)
    for batch in _train_batches():
        jstate, jmetrics = jstep(jstate, jstrategy.shard_batch(batch))
        state, metrics = step(state, strategy.shard_batch(batch))
        np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=LOSS_RTOL)
        assert float(metrics["accuracy"]) == pytest.approx(float(jmetrics["accuracy"]))
    want = convert.convert_variables({"params": _np(jstate.params)}, port)
    for name, value in state.params.items():
        np.testing.assert_allclose(value.detach().numpy(), want[name].numpy(), atol=PARAM_TOL, err_msg=name)
    assert state.step == 5 and int(state.opt_state["count"]) == 5


def test_cnn_gradients_of_the_eval_loss_match_jax_grad():
    jmodel, variables, port = _models("cnn")
    batch = _batch(2, n=8)

    def jloss(params):
        logits = jmodel.apply({"params": params}, jnp.asarray(batch["image"]), train=False)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(batch["label"])).mean()

    jloss_value, jgrads = jax.value_and_grad(jloss)(variables["params"])
    loss = F.cross_entropy(port(torch.from_numpy(batch["image"]), train=False),
                           torch.from_numpy(batch["label"]))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss_value), rtol=LOSS_RTOL)
    want = convert.convert_variables({"params": _np(jgrads)}, port)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_dropout_mask_is_a_function_of_seed_and_step(rate):
    x = torch.ones(256, 512)

    def masked(seed, step):
        return mnist.dropout(x, rate, mnist.dropout_generator(seed, step, x.device))

    a = masked(0, 3)
    assert torch.equal(a, masked(0, 3))  # equal for equal (seed, step)
    assert not torch.equal(a, masked(0, 4))  # fresh every step
    assert not torch.equal(a, masked(1, 3))  # and every seed
    kept = (a != 0).float()
    n, share = kept.numel(), float(kept.mean())
    # within 5 standard deviations of a Binomial(n, 1 - rate) share
    assert abs(share - (1 - rate)) <= 5 * np.sqrt(rate * (1 - rate) / n)
    np.testing.assert_allclose(a[a != 0].numpy(), 1.0 / (1.0 - rate), rtol=1e-6)
    assert torch.equal(mnist.dropout(x, 0.0), x)


def test_loss_fn_draws_its_mask_from_the_step():
    """Training-mode logits differ across steps and repeat for a step; eval
    mode has no dropout."""
    model = mnist.MnistMLP(hidden=64, generator=torch.Generator().manual_seed(0))
    loss_fn = mnist.make_loss_fn(model, dropout_seed=7)
    batch = {k: torch.as_tensor(v) for k, v in _batch(3).items()}
    losses = [float(loss_fn(model, batch, step=s)[0]) for s in (0, 0, 1)]
    assert losses[0] == losses[1] and losses[0] != losses[2]
    x = batch["image"]
    assert torch.equal(model(x), model(x))
    pred = mnist.make_predict_fn(model)(model, batch)
    assert torch.equal(pred, model(x).argmax(-1))


def test_registry_and_init():
    mlp = get_model("mnist_mlp", hidden=32)
    cnn = get_model("mnist_cnn")
    assert isinstance(mlp, mnist.MnistMLP) and isinstance(cnn, mnist.MnistCNN)
    init = mnist.make_init_fn(mlp)
    a = {k: v.clone() for k, v in init(torch.Generator().manual_seed(0)).state_dict().items()}
    b = init(torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # flax's lecun-normal: std sqrt(1/fan_in), truncated at two std; zero biases
    w = mnist.MnistMLP(generator=torch.Generator().manual_seed(1)).Dense_0.weight
    assert float(w.std()) == pytest.approx(np.sqrt(1 / 784), rel=0.05)
    assert float(w.abs().max()) <= 2 * np.sqrt(1 / 784) / 0.87962566103423978 + 1e-6
    assert not mlp.Dense_0.bias.any()


def test_bf16_compute_keeps_f32_params_and_logits():
    model = mnist.MnistCNN(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    out = model(torch.from_numpy(_batch(4, n=4)["image"]))
    assert out.dtype == torch.float32 and all(p.dtype == torch.float32 for p in model.parameters())


def _optax_run(tx, params, grads):
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return params, state


@pytest.mark.parametrize("kwargs", [{}, {"b1": 0.8, "b2": 0.99, "eps": 1e-6, "eps_root": 1e-8}],
                         ids=["defaults", "custom"])
def test_adam_matches_optax_adam(kwargs):
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()} for _ in range(5)]
    want, _ = _optax_run(optax.adam(1e-2, **kwargs), {k: jnp.asarray(v) for k, v in params.items()},
                         [{k: jnp.asarray(v) for k, v in g.items()} for g in grads])
    opt = optim.adam(1e-2, **kwargs)
    p = {k: torch.tensor(v) for k, v in params.items()}
    state = opt.init(p)
    for g in grads:
        opt.update(p, {k: torch.tensor(v) for k, v in g.items()}, state)
    for k in params:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)
    assert int(state["count"]) == 5


def test_convert_train_state_takes_an_optax_adam_state():
    """A JAX-package ``TrainState`` trained with ``optax.adam`` carries onto
    the port's state (``mu``/``nu`` leaf for leaf, the count from Adam's
    state), and both continue equal."""
    jmodel, variables, port = _models("mlp", hidden=32, dropout_rate=0.0)
    jstrategy = JaxSyncDataParallel(parallel.build_mesh({"dp": 1}, devices=jax.devices()[:1]))
    tx = optax.adam(1e-3)
    jstate = jstrategy.create_state(lambda: variables, tx)
    jstep = jstrategy.compile_train_step(jmnist.make_loss_fn(jmodel), tx, has_aux=True, donate=False)
    for i in range(3):
        jstate, _ = jstep(jstate, jstrategy.shard_batch(_batch(20 + i)))
    strategy = SyncDataParallel("cpu")
    optimizer = optim.adam(1e-3)
    state = strategy.create_state(lambda: mnist.MnistMLP(hidden=32, dropout_rate=0.0), optimizer)
    convert.convert_train_state(_np(jstate), state)
    assert state.step == 3 and int(state.opt_state["count"]) == 3
    want_mu = convert.convert_variables({"params": _np(jstate.opt_state[0].mu)}, state.module)
    for name, value in state.opt_state["mu"].items():
        np.testing.assert_array_equal(value.numpy(), want_mu[name].numpy())
    step = strategy.compile_train_step(mnist.make_loss_fn(state.module), optimizer, has_aux=True)
    for i in range(2):
        jstate, _ = jstep(jstate, jstrategy.shard_batch(_batch(30 + i)))
        state, _ = step(state, strategy.shard_batch(_batch(30 + i)))
    want = convert.convert_variables({"params": _np(jstate.params)}, state.module)
    for name, value in state.params.items():
        np.testing.assert_allclose(value.detach().numpy(), want[name].numpy(), atol=PARAM_TOL, err_msg=name)


# -- train/metrics.py: the cases of tests/test_train_metrics.py ----------------


def test_time_history_intervals_and_rate(monkeypatch):
    clock = {"t": 100.0}
    monkeypatch.setattr("time.time", lambda: clock["t"])

    th = TimeHistory(batch_size=32, log_steps=4)
    for _ in range(12):  # 3 complete intervals
        th.batch_end()
        clock["t"] += 0.5
    assert th.global_steps == 12
    assert len(th.timestamps) == 3
    # interval ends at t=101.5, 103.5, 105.5 -> 32*4*2/4 = 64
    assert abs(th.avg_examples_per_second - 64.0) < 1e-6


def test_time_history_too_short_run():
    th = TimeHistory(batch_size=8, log_steps=100)
    th.batch_end()
    assert th.avg_examples_per_second == 0.0
    assert th.timestamps == []


def test_build_stats_shapes():
    th = TimeHistory(batch_size=8, log_steps=1)
    th.batch_end()
    th.batch_end()
    stats = build_stats(
        loss=torch.tensor(1.5),
        metrics={"accuracy": np.float32(0.9), "step": 10},
        time_history=th,
        eval_results={"accuracy": 0.8},
    )
    assert stats["loss"] == 1.5
    assert stats["accuracy"] == np.float32(0.9)
    assert stats["eval_accuracy"] == 0.8
    assert len(stats["step_timestamp_log"]) == 2
    assert stats["train_finish_time"] is not None
    assert stats["avg_exp_per_second"] > 0


def test_build_stats_minimal():
    assert build_stats(None) == {}
    assert build_stats(2.0) == {"loss": 2.0}
