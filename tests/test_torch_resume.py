"""Resume on the port, against the JAX package, on the CPU.

* A resume continues the reference's trajectory: the JAX package and the
  port start from the same seeded weights (converted), each trains K
  steps, saves, restores into a fresh state and trains to 2K on the same
  numpy batches. The port's parameters, optimizer state and BN statistics
  at 2K are held to the JAX package's within 1e-5 (``test_torch_sync_dp.py``'s
  limit; measured on the CPU: 1.2e-7 for the ResNet with SGD, 3.0e-8 for
  the transformer with AdamW), and the port's resumed run equals its
  uninterrupted run bitwise.
* A JAX orbax checkpoint, written and restored by the JAX package, goes
  through ``convert.convert_train_state``; the port continues K steps and
  matches the JAX package continuing the same K steps, within 1e-5.

Both for SGD with momentum (a small ResNet with BN statistics and a
learning-rate schedule, whose count lives in the schedule's state) and for
AdamW (a small transformer). Then the cluster path: ``run_with_recovery``
on two executors whose victim's trainer child the ``node.kill`` chaos site
SIGKILLs mid-run: one relaunch, the victim resumes from its checkpoint, and
its final checkpoint equals, bitwise, the one of the executor that was
never interrupted.
"""

import functools
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu import parallel
from tensorflowonspark_tpu.models import resnet as jax_resnet
from tensorflowonspark_tpu.models import transformer as jtransformer
from tensorflowonspark_tpu.train import SyncDataParallel as JaxSyncDataParallel
from tensorflowonspark_tpu.train import checkpoint as jax_checkpoint
from tensorflowonspark_tpu_torch import chaos, convert, util
from tensorflowonspark_tpu_torch.models import resnet, transformer
from tensorflowonspark_tpu_torch.train import SyncDataParallel, checkpoint, optim

K = 2
TOL = 1e-5
RESNET = dict(stage_sizes=(1, 1), filters=(8, 16), num_classes=10, bottleneck=False, stem="cifar")
LM = dict(vocab_size=300, d_model=32, n_layers=1, n_heads=2, d_ff=64, max_seq_len=64)
CPU_ENV = {util.ENV_PLATFORM: "cpu"}


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _image_batch(i):
    rng = np.random.default_rng(100 + i)
    return {"image": rng.standard_normal((4, 8, 8, 3)).astype(np.float32),
            "label": rng.integers(0, 10, 4)}


def _lm_batch(i):
    rng = np.random.default_rng(200 + i)
    tokens = rng.integers(1, LM["vocab_size"], (2, 33)).astype(np.int32)
    seg = np.ones_like(tokens)
    seg[:, 20:] = 2
    pos = np.concatenate([np.arange(20), np.arange(13)])[None].repeat(2, 0).astype(np.int32)
    return {"tokens": tokens, "segment_ids": seg, "positions": pos}


class _Case:
    """One model and optimizer on both sides: ``jax_state(seed)``,
    ``jax_step``, ``port_state(variables_seed)``, ``port_step``, batches."""

    def __init__(self, name):
        self.name = name
        self._variables = {}
        self.jstrategy = JaxSyncDataParallel(parallel.build_mesh({"dp": 1}, devices=jax.devices()[:1]))
        self.strategy = SyncDataParallel("cpu")
        if name == "resnet_sgd":
            self.jmodel = jax_resnet.ResNet(bn_impl="flax", **RESNET)
            self.tx = optax.sgd(optax.linear_schedule(0.05, 0.1, 10), momentum=0.9)
            self.optimizer = optim.sgd(optim.linear_schedule(0.05, 0.1, 10), momentum=0.9)
            self.batch = _image_batch
            self.jstep = self.jstrategy.compile_train_step(
                jax_resnet.make_loss_fn(self.jmodel, weight_decay=1e-4), self.tx, mutable=True, donate=False)
        else:
            self.jmodel = jtransformer.create_model(dtype="float32", attention="plain", **LM)
            self.tx = optax.adamw(3e-4)
            self.optimizer = optim.adamw(3e-4)
            self.batch = _lm_batch
            self.jstep = self.jstrategy.compile_train_step(
                jtransformer.make_loss_fn(self.jmodel), self.tx, has_aux=True, donate=False)

    def variables(self, seed):
        """The JAX model's variables from ``seed``, a fresh numpy copy each
        call (the init is compiled once a case, its result kept a seed)."""
        if seed not in self._variables:
            if self.name == "resnet_sgd":
                init = jax.jit(lambda key, x: self.jmodel.init(key, x, train=False))
                self._variables[seed] = _np(init(jax.random.PRNGKey(seed), jnp.asarray(_image_batch(0)["image"])))
            else:
                init = jax.jit(jtransformer.make_init_fn(self.jmodel, sample_len=8))
                self._variables[seed] = {"params": _np(init(jax.random.PRNGKey(seed))["params"])}
        return jax.tree.map(np.array, self._variables[seed])

    def jax_state(self, variables):
        return self.jstrategy.create_state(lambda: variables, self.tx)

    def port_state(self, variables):
        if self.name == "resnet_sgd":
            module = resnet.ResNet(bn_impl="flax", **RESNET)
        else:
            module = transformer.create_model(dtype="float32", attention="plain", **LM)
        return self.strategy.create_state(lambda: convert.load_variables(module, variables), self.optimizer)

    def port_step(self, state):
        if self.name == "resnet_sgd":
            return self.strategy.compile_train_step(resnet.make_loss_fn(weight_decay=1e-4), self.optimizer,
                                                    mutable=True)
        return self.strategy.compile_train_step(transformer.make_loss_fn(state.module), self.optimizer,
                                                has_aux=True)

    def jax_train(self, jstate, steps):
        for i in steps:
            jstate, _ = self.jstep(jstate, self.jstrategy.shard_batch(self.batch(i)))
        return jstate

    def port_train(self, state, steps):
        step = self.port_step(state)
        for i in steps:
            state, _ = step(state, self.strategy.shard_batch(self.batch(i)))
        return state


def _port_tensors(state):
    """Every tensor of a port state by name, the step beside them."""
    out = {"module/" + k: v.detach() for k, v in dict(state.params, **state.model_state).items()}
    for key, value in state.opt_state.items():
        if isinstance(value, dict):
            out.update(("{}/{}".format(key, k), v) for k, v in value.items())
        elif value is not None:
            out[key] = value
    return out, state.step


def _assert_matches_reference(case, state, jstate):
    """The port's state against the JAX package's, converted into a port
    state of the same architecture: every tensor within TOL; count and step
    equal. Returns the largest gap."""
    want = convert.convert_train_state(_np(jstate), case.port_state(case.variables(9)))
    got, step = _port_tensors(state)
    ref, ref_step = _port_tensors(want)
    assert step == ref_step and got.keys() == ref.keys()
    gap = 0.0
    for name, value in got.items():
        if name == "count":
            assert int(value) == int(ref[name])
            continue
        np.testing.assert_allclose(value.numpy(), ref[name].numpy(), atol=TOL, err_msg=name)
        gap = max(gap, float((value - ref[name]).abs().max()))
    return gap


@functools.lru_cache(maxsize=None)
def _case(name):
    """One ``_Case`` a model for the file: the JAX step compiles once."""
    return _Case(name)


@pytest.mark.parametrize("name", ["resnet_sgd", "transformer_adamw"])
def test_resume_continues_the_reference_trajectory(name, tmp_path):
    case = _case(name)
    variables = case.variables(0)
    # the JAX package: K steps, an orbax save, a restore into a fresh state, K more
    jstate = case.jax_train(case.jax_state(variables), range(K))
    jpath = jax_checkpoint.save_checkpoint(str(tmp_path / "jax" / "ckpt_{}".format(K)), jax.device_get(jstate))
    jfresh = jax.device_get(case.jax_state(case.variables(1)))
    jstate = case.jax_train(jax_checkpoint.restore_checkpoint(jpath, target=jfresh), range(K, 2 * K))

    # the port: the same, restoring in place into a state of other weights
    state = case.port_train(case.port_state(variables), range(K))
    path = checkpoint.save_checkpoint(str(tmp_path / "port" / "ckpt_{}".format(K)), state)
    fresh = case.port_state(case.variables(1))
    first = next(fresh.module.parameters())
    restored, latest = checkpoint.restore_latest(str(tmp_path / "port"), target=fresh)
    assert restored is fresh and latest == path and fresh.step == K
    assert next(fresh.module.parameters()) is first  # in place
    resumed = case.port_train(fresh, range(K, 2 * K))

    straight = case.port_train(case.port_state(variables), range(2 * K))
    got, step = _port_tensors(resumed)
    want, want_step = _port_tensors(straight)
    assert step == want_step == 2 * K
    for key, value in got.items():
        assert torch.equal(value, want[key]), key  # resumed == uninterrupted, bitwise
    assert _assert_matches_reference(case, resumed, jstate) <= TOL


@pytest.mark.parametrize("name", ["resnet_sgd", "transformer_adamw"])
def test_a_converted_orbax_checkpoint_continues_in_the_port(name, tmp_path):
    case = _case(name)
    jstate = case.jax_train(case.jax_state(case.variables(0)), range(K))
    jpath = jax_checkpoint.save_checkpoint(str(tmp_path / "ckpt_{}".format(K)), jax.device_get(jstate))
    jrestored = jax_checkpoint.restore_checkpoint(jpath, target=jax.device_get(case.jax_state(case.variables(1))))

    state = convert.convert_train_state(_np(jrestored), case.port_state(case.variables(1)))
    assert state.step == K and int(state.opt_state["count"]) == K
    state = case.port_train(state, range(K, 2 * K))
    jstate = case.jax_train(jrestored, range(K, 2 * K))
    assert _assert_matches_reference(case, state, jstate) <= TOL


def test_convert_train_state_raises_on_an_unmatched_leaf():
    case = _case("resnet_sgd")
    jstate = _np(case.jax_state(case.variables(0)))
    port = case.port_state(case.variables(0))
    before = {k: v.clone() for k, v in _port_tensors(port)[0].items()}
    bad = jstate.replace(opt_state=(jstate.opt_state[0]._replace(
        trace=dict(jstate.opt_state[0].trace, extra={"kernel": np.zeros((1, 1), np.float32)})),
        jstate.opt_state[1]))
    with pytest.raises(KeyError, match="trace"):
        convert.convert_train_state(bad, port)
    with pytest.raises(KeyError, match="optax state"):  # AdamW's state onto an SGD state
        convert.convert_train_state(jstate.replace(opt_state=optax.adamw(1e-3).init(jstate.params)), port)
    for key, value in _port_tensors(port)[0].items():
        assert torch.equal(value, before[key]), key  # nothing copied


# -- the cluster path: a trainer child killed, relaunched, resumed -------------


def fn_train_resume_or_die(args, ctx):
    """Trains a small ResNet to ``target_steps`` from the newest checkpoint
    of this executor's dir, checkpointing every ``checkpoint_steps``, on the
    batch of each global step (the same in every life and on every
    executor). The victim's first life stops at ``kill_after``, waits for
    the other executor to finish, and then arms the ``node.kill`` chaos
    site: it removes the site's ``once_path`` latch, which the test created
    to hold the kill back, so the next heartbeat SIGKILLs it (and re-creates
    the latch, which spares the second life)."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.models import resnet
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, checkpoint, optim

    model_dir = os.path.join(args["model_dir"], "worker_{}".format(ctx.executor_id))
    os.makedirs(model_dir, exist_ok=True)
    strategy = SyncDataParallel(ctx.device)
    optimizer = optim.sgd(optim.linear_schedule(0.05, 0.1, 10), momentum=0.9)
    state = strategy.create_state(
        lambda: resnet.ResNet(bn_impl="flax", generator=torch.Generator().manual_seed(0), **args["resnet"]),
        optimizer)
    checkpoint.restore_latest(model_dir, target=state)
    resumed_from = state.step
    step = strategy.compile_train_step(resnet.make_loss_fn(weight_decay=1e-4), optimizer, mutable=True)
    first_life_victim = ctx.executor_id == args["victim"] and resumed_from == 0
    while state.step < args["target_steps"]:
        rng = np.random.default_rng(state.step)
        batch = strategy.shard_batch({"image": rng.standard_normal((4, 8, 8, 3)).astype(np.float32),
                                      "label": rng.integers(0, 10, 4)})
        state, _ = step(state, batch)
        if state.step % args["checkpoint_steps"] == 0:
            checkpoint.save_checkpoint(os.path.join(model_dir, "ckpt_{}".format(state.step)), state)
        if first_life_victim and state.step == args["kill_after"]:
            healthy = os.path.join(args["model_dir"], "worker_0", "done_0.json")
            while not os.path.exists(healthy):
                time.sleep(0.05)
            os.remove(args["latch"])  # arms the kill
            while True:
                time.sleep(0.05)  # until the chaos site's SIGKILL lands
    with open(os.path.join(model_dir, "done_{}.json".format(resumed_from)), "w") as f:
        json.dump({"resumed_from": resumed_from, "final_step": state.step}, f)


def test_a_killed_trainer_resumes_through_run_with_recovery_bitwise(tmp_path, monkeypatch):
    """Executor 1's trainer is SIGKILLed by the ``node.kill`` chaos site
    after its step-4 checkpoint (and after executor 0 finished, never
    interrupted); ``run_with_recovery`` relaunches once, the victim resumes
    at step 4, and its final checkpoint equals executor 0's bitwise."""
    from tensorflowonspark_tpu_torch import TFCluster
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext

    monkeypatch.setenv("TOS_MONITOR_INTERVAL", "1")
    monkeypatch.setenv("TOS_HEARTBEAT_INTERVAL", "0.2")
    chaos_log = str(tmp_path / "chaos.log")
    monkeypatch.setenv(chaos.LOG_ENV_VAR, chaos_log)
    model_dir = str(tmp_path / "model")
    latch = str(tmp_path / "killed.latch")
    with open(latch, "w") as f:
        f.write("held until the victim arms it")
    args = {"model_dir": model_dir, "target_steps": 8, "checkpoint_steps": 2, "kill_after": 5,
            "victim": 1, "latch": latch, "resnet": RESNET}
    chaos.install(chaos.ChaosPlan(seed=0).site(
        "node.kill", probability=1.0, max_count=1, victim=1, after_beats=1, once_path=latch))
    sc = LocalSparkContext(num_executors=2, task_timeout=300)
    try:
        relaunches = TFCluster.run_with_recovery(
            sc, fn_train_resume_or_die, args, num_executors=2,
            input_mode=TFCluster.InputMode.TENSORFLOW, master_node=None, env=CPU_ENV,
            jax_distributed=False, reservation_timeout=180, max_relaunches=2, shutdown_timeout=120,
        )
    finally:
        sc.stop()
        chaos.uninstall()
    assert relaunches == 1, "exactly one relaunch should recover this run"
    with open(chaos_log) as f:
        assert [line.strip() for line in f] == ["node.kill"]
    victim, healthy = (os.path.join(model_dir, "worker_{}".format(e)) for e in (1, 0))
    with open(os.path.join(victim, "done_4.json")) as f:  # resumed at its step-4 checkpoint
        assert json.load(f) == {"resumed_from": 4, "final_step": 8}
    with open(os.path.join(healthy, "done_0.json")) as f:  # never interrupted
        assert json.load(f) == {"resumed_from": 0, "final_step": 8}
    assert sorted(d for d in os.listdir(victim) if d.startswith("ckpt_")) == [
        "ckpt_2", "ckpt_4", "ckpt_6", "ckpt_8"]
    got = checkpoint.restore_checkpoint(os.path.join(victim, "ckpt_8"))
    want = checkpoint.restore_checkpoint(os.path.join(healthy, "ckpt_8"))
    assert got["step"] == want["step"] == 8
    for part in ("params", "model_state"):
        for key, value in want[part].items():
            assert torch.equal(got[part][key], value), (part, key)
    assert torch.equal(got["opt_state"]["count"], want["opt_state"]["count"])
    for key, value in want["opt_state"]["trace"].items():
        assert torch.equal(got["opt_state"]["trace"][key], value), key
