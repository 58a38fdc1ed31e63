"""``PackedLoopCache`` on the port, held against the JAX package's
``train.PackedLoopCache`` (``tests/test_autotune.py::TestPackedLoopCache``).

* One loop a window size, built on first use, ``feed_recompiles_total``
  counting the builds and ``compiled_sizes`` the buckets.
* The linear model of the JAX package's test trained through
  ``autotuned_prefetch`` windows (buckets 1, 2, 4) of 11 batches: every
  batch trains exactly one step, and the last loss and the parameters
  equal, within 1e-6, the JAX package's cache run on the same batches from
  the same (converted) weights.
* On the card every bucket's loop replays one captured step: with a
  strategy whose loops are ``_CapturedLoop``\\ s, the cache builds one and
  derives the others from it (same step object: one warm-up, graph and
  pool), still counting a build a bucket. Nothing here touches CUDA.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu import obs as jobs
from tensorflowonspark_tpu import parallel as jparallel
from tensorflowonspark_tpu.data import autotuned_prefetch as jautotuned_prefetch
from tensorflowonspark_tpu.train import PackedLoopCache as JPackedLoopCache
from tensorflowonspark_tpu.train import SyncDataParallel as JSyncDataParallel
from tensorflowonspark_tpu_torch import obs
from tensorflowonspark_tpu_torch.data import autotuned_prefetch
from tensorflowonspark_tpu_torch.train import PackedLoopCache, SyncDataParallel, optim
from tensorflowonspark_tpu_torch.train.strategy import _CapturedLoop

TOL = 1e-6


class Linear(torch.nn.Module):
    """The JAX test's ``x @ w + b`` (``w`` [2, 1])."""

    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(w))
        self.b = torch.nn.Parameter(torch.tensor(b))

    def forward(self, x):
        return x @ self.w + self.b


def _loss(module, batch):
    return ((module(batch["x"]) - batch["y"]) ** 2).mean()


def _jax_init(rng):
    k1, _ = jax.random.split(rng)
    return {"w": jax.random.normal(k1, (2, 1)) * 0.01, "b": np.zeros((1,), np.float32)}


def _jax_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return ((pred - batch["y"]) ** 2).mean()


def _xy_batches(n, rows=8):
    rng = np.random.default_rng(0)
    return [{"x": rng.standard_normal((rows, 2)).astype(np.float32),
             "y": rng.standard_normal((rows, 1)).astype(np.float32)} for _ in range(n)]


def _recompiles():
    return obs.snapshot()["counters"].get("feed_recompiles_total", {"value": 0})["value"]


def test_compiles_at_most_once_per_bucket_and_counts():
    cache = PackedLoopCache(SyncDataParallel("cpu"), _loss, optim.sgd(0.05))
    before = _recompiles()
    l2 = cache.loop_for(2)
    assert cache.loop_for(2) is l2
    cache.loop_for(4)
    assert cache.compiled_sizes == [2, 4]
    assert _recompiles() - before == 2


def test_run_trains_through_autotuned_windows_as_the_jax_package():
    n = 11
    jstrategy = JSyncDataParallel(jparallel.build_mesh({"dp": 8}))
    jopt = optax.sgd(0.05)
    jstate = jstrategy.create_state(_jax_init, jopt, jax.random.PRNGKey(0))
    w0 = {k: np.array(v) for k, v in jax.device_get(jstate.params).items()}
    jcache = JPackedLoopCache(jstrategy, _jax_loss, jopt)
    for w in jautotuned_prefetch(iter(_xy_batches(n)), jstrategy, buckets=(1, 2, 4)):
        jstate, jmetrics = jcache.run(jstate, w)
    assert int(jax.device_get(jstate.step)) == n
    jparams = jax.device_get(jstate.params)

    strategy = SyncDataParallel("cpu")
    opt = optim.sgd(0.05)
    state = strategy.create_state(lambda: Linear(w0["w"], w0["b"]), opt)
    cache = PackedLoopCache(strategy, _loss, opt)
    ks = []
    for w in autotuned_prefetch(iter(_xy_batches(n)), strategy, buckets=(1, 2, 4)):
        ks.append(w.k)
        state, metrics = cache.run(state, w)
    # every batch trained exactly one step, whatever the windowing
    assert state.step == n == sum(ks)
    assert cache.compiled_sizes == sorted(set(ks))
    assert np.isfinite(float(metrics["loss"]))
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= TOL
    for name in ("w", "b"):
        np.testing.assert_allclose(state.params[name].detach().numpy(), np.asarray(jparams[name]), atol=TOL)
    assert jobs.snapshot()["counters"]["feed_recompiles_total"]["value"] >= 1


class _CapturingStrategy:
    """A strategy whose loops are the card's ``_CapturedLoop``\\ s (built
    without touching CUDA); counts its builds."""

    def __init__(self):
        self.builds = []

    def compile_train_loop(self, loss_fn, optimizer, num_steps, **kw):
        self.builds.append((num_steps, kw))
        return _CapturedLoop(lambda state, batch, kw: {}, False, num_steps, kw["packed"], "cuda")


def test_buckets_on_the_card_share_one_captured_step():
    strategy = _CapturingStrategy()
    cache = PackedLoopCache(strategy, _loss, optim.sgd(0.05), mutable=True)
    before = _recompiles()
    loops = [cache.loop_for(k) for k in (1, 2, 4, 2)]
    assert [b[0] for b in strategy.builds] == [1]  # one capture for the cache
    assert strategy.builds[0][1] == dict(has_aux=False, mutable=True, donate="state", packed=True)
    assert [loop.num_steps for loop in loops] == [1, 2, 4, 2]
    assert loops[1] is loops[3]
    assert all(loop.step is loops[0].step for loop in loops)
    assert all(loop.packed for loop in loops)
    assert _recompiles() - before == 3  # a build a bucket, as the JAX package counts
    assert cache.compiled_sizes == [1, 2, 4]


def test_a_loop_checks_its_window_size():
    loop = _CapturedLoop(lambda state, batch, kw: {}, False, 2, True, "cuda").with_steps(4)
    with pytest.raises(ValueError, match="loop compiled for 4"):
        loop(None, {"x": torch.zeros(2, 3)})
