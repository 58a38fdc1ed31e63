"""Fully sharded data parallelism (ZeRO-3): the port's
``SyncDataParallel(mesh, fsdp=True)`` against the JAX package's on the CPU.

The JAX package runs its SPMD step on a ``{"dp": 2, "fsdp": 2}`` mesh of 4
virtual CPU devices; the port runs a 4-rank gloo world
(``testing.join_cpu_world``) on ``ctx.mesh({"dp": 2, "fsdp": 2})``, each
rank fed its quarter of the same global batches (numpy, seeded), from the
same weights (converted). Held, with the limits of
``test_torch_sync_dp.py``'s family: the losses of every step and the
gathered parameters after the steps within 1e-5 (the multichip MLP, Adam
1e-2, 3 steps; a small transformer, AdamW, 2 layers, d_model 64, 2 steps,
on the LM example's own packed text) and 1e-4 (a small ResNet with global
BatchNorm statistics, SGD with momentum, 2 steps); every rank's gathered
parameters bitwise equal; the sharded dimension of each array and the
``fsdp_params_sharded`` gauge equal to the JAX package's; the Adam state of
the sharded arrays half their size on each rank.

Then the slice's own checks at a small size on the CPU: the LM fully sharded
on a world of one, bitwise equal to data parallelism, eager, looped and
through checkpoint → ``reshard_restore`` (``examples/transformer/
fsdp_check.py`` through ``TFCluster.run``), and the 4-rank rehearsal of
``examples/sync_dp_check.py --fsdp``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tensorflowonspark_tpu import obs as jobs
from tensorflowonspark_tpu import parallel as jparallel
from tensorflowonspark_tpu.models import resnet as jresnet
from tensorflowonspark_tpu.models import transformer as jtransformer
from tensorflowonspark_tpu.train import SyncDataParallel as JaxSyncDataParallel
from tensorflowonspark_tpu_torch import convert

from torch_world_util import REPO, run_world

MESH = {"dp": 2, "fsdp": 2}
LM = dict(vocab_size=300, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=64)
RESNET = dict(stage_sizes=(1, 1), filters=(8, 16), bottleneck=False, stem="cifar", num_classes=10)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), jax.device_get(tree))


def _lm_batches(tmp_path, n=2, rows=8, seq=32):
    """``n`` global batches of the LM example's own corpus, byte tokens
    FFD-packed into ``[rows, seq + 1]``."""
    from tensorflowonspark_tpu_torch import tfrecord
    from tensorflowonspark_tpu_torch.data import TextPipeline, Tokenizer
    from tensorflowonspark_tpu_torch.examples.transformer import transformer_spark

    data_dir = str(tmp_path / "corpus")
    transformer_spark.make_text_corpus(data_dir, num_shards=2, records_per_shard=40)
    stream = iter(TextPipeline(tfrecord.list_shards(data_dir), Tokenizer(kind="byte"), seq_len=seq + 1,
                               batch_size=rows, seed=0, epochs=None, pack_workers=0))
    batches = [{k: np.asarray(v) for k, v in next(stream).items()} for _ in range(n)]
    stream.close()
    return batches


def _cases(tmp_path):
    """``{name: (JAX init -> params/variables, JAX loss, optax, port job kwargs,
    mutable, tolerance)}``."""
    rng = np.random.default_rng(11)
    mlp = {"w1": (rng.standard_normal((64, 64)) * 0.1).astype(np.float32),
           "w2": (rng.standard_normal((64, 8)) * 0.1).astype(np.float32)}
    mlp_batches = [{"x": rng.normal(size=(8, 64)).astype(np.float32),
                    "y": rng.normal(size=(8, 8)).astype(np.float32)} for _ in range(3)]

    def mlp_loss(params, batch):
        return jnp.mean((jnp.tanh(batch["x"] @ params["w1"]) @ params["w2"] - batch["y"]) ** 2)

    jlm = jtransformer.create_model(dtype="float32", attention="plain", **LM)
    lm = _np(jax.jit(jtransformer.make_init_fn(jlm, sample_len=8))(jax.random.PRNGKey(0))["params"])
    jres = jresnet.ResNet(bn_impl="pallas", **RESNET)
    images = rng.standard_normal((2, 8, 8, 8, 3)).astype(np.float32)
    images[:, 4:] += 1.0  # the quarters' statistics differ from the global batch's
    res_batches = [{"image": images[i], "label": rng.integers(0, 10, 8)} for i in range(2)]
    res = _np(jax.jit(lambda x: jres.init(jax.random.PRNGKey(0), x, train=False))(jnp.asarray(images[0])))
    return {
        "mlp": (mlp, mlp_loss, optax.adam(1e-2), dict(
            kind="mlp", variables=mlp, cfg={}, optimizer=("adam", {"learning_rate": 1e-2}),
            batches=mlp_batches, min_weight_size=256), False, 1e-5),
        "transformer": (lm, jtransformer.make_loss_fn(jlm), optax.adamw(1e-3), dict(
            kind="transformer", variables=lm, cfg=dict(LM, dtype="float32", attention="plain"),
            optimizer=("adamw", {"learning_rate": 1e-3}), batches=_lm_batches(tmp_path),
            min_weight_size=1024), False, 1e-5),
        "resnet": (res, jresnet.make_loss_fn(jres, weight_decay=1e-4), optax.sgd(0.1, momentum=0.9), dict(
            kind="resnet", variables=res, cfg=dict(RESNET, bn_impl="pallas"),
            optimizer=("sgd", {"learning_rate": 0.1, "momentum": 0.9}), batches=res_batches,
            min_weight_size=256), True, 1e-4),
    }


def _jax_run(init, loss_fn, tx, kw, mutable):
    """The JAX package's ZeRO-3 run on the 2x2 mesh: losses, the params
    (and batch_stats) converted to the port's names, the sharded flax dims
    and the gauge."""
    mesh = jparallel.build_mesh(MESH, devices=jax.devices()[:4])
    strategy = JaxSyncDataParallel(mesh, fsdp=True, min_weight_size=kw["min_weight_size"])
    state = strategy.create_state(lambda: init, tx)
    gauge = jobs.gauge("fsdp_params_sharded").value
    step = strategy.compile_train_step(loss_fn, tx, has_aux=kw["kind"] == "transformer", mutable=mutable,
                                       donate=False)
    losses = []
    for b in kw["batches"]:
        state, metrics = step(state, strategy.shard_batch(b))
        jax.block_until_ready(state)
        losses.append(float(metrics["loss"]))
    dims = {"/".join(str(getattr(k, "key", k)) for k in path): next(
        (i for i, e in enumerate(tuple(a.sharding.spec)) if e == "fsdp"), None)
        for path, a in jax.tree_util.tree_flatten_with_path(state.params)[0]}
    if kw["kind"] == "mlp":
        params = {k: _t(v) for k, v in _np(state.params).items()}
    else:
        variables = {"params": _np(state.params)}
        if mutable:
            variables["batch_stats"] = _np(state.model_state["batch_stats"])
        params = convert.convert_variables(variables)
    return losses, params, dims, gauge


def _t(a):
    import torch

    return torch.as_tensor(a)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    cases = _cases(tmp)
    spec = {name: ("job_train", dict(kw, axes=MESH, fsdp=True)) for name, (_, _, _, kw, _, _) in cases.items()}
    ranks = run_world(tmp, spec)
    return {name: (_jax_run(init, loss_fn, tx, kw, mutable), [r[name] for r in ranks], tol, init)
            for name, (init, loss_fn, tx, kw, mutable, tol) in cases.items()}


@pytest.mark.parametrize("name", ["mlp", "transformer", "resnet"])
def test_losses_and_gathered_params_match_the_jax_package(trained, name):
    (losses, params, _, _), ranks, tol, _ = trained[name]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["losses"], losses, atol=tol, rtol=0, err_msg="rank %d" % r)
        state = dict(got["params"], **got["buffers"])
        for key, want in params.items():
            np.testing.assert_allclose(state[key].numpy(), want.numpy(), atol=tol, rtol=0,
                                       err_msg="rank %d %s" % (r, key))


@pytest.mark.parametrize("name", ["mlp", "transformer", "resnet"])
def test_every_rank_holds_equal_gathered_params(trained, name):
    import torch

    _, ranks, _, _ = trained[name]
    for got in ranks[1:]:
        assert got["losses"] == ranks[0]["losses"]
        for key, value in ranks[0]["params"].items():
            assert torch.equal(value, got["params"][key]), key
        for key, value in ranks[0]["buffers"].items():
            assert torch.equal(value, got["buffers"][key]), key


@pytest.mark.parametrize("name", ["mlp", "transformer", "resnet"])
def test_sharded_dims_and_gauge_match_the_jax_package(trained, name):
    """Each sharded array is split on the port dimension holding the flax
    dimension the JAX package splits; the gauge counts as many."""
    from tensorflowonspark_tpu_torch.models import resnet, transformer
    from torch_world_util import Mlp

    (_, _, jdims, jgauge), ranks, _, init = trained[name]
    if name == "mlp":
        layouts = convert.flax_layouts(Mlp(init["w1"], init["w2"]))
        port_name = {k: k for k in jdims}
    else:
        module = transformer.create_model(**LM) if name == "transformer" else resnet.ResNet(**RESNET)
        layouts = convert.flax_layouts(module)
        leaf = {"kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight"}
        port_name = {k: ".".join(k.split("/")[:-1] + [leaf[k.split("/")[-1]]]) for k in jdims}
    want = {port_name[k]: layouts[port_name[k]][1][d] for k, d in jdims.items() if d is not None}
    assert want, "the JAX package sharded nothing"
    for got in ranks:
        assert got["dims"] == want
        assert got["gauge"] == jgauge == len(want)


def test_optimizer_state_of_the_sharded_arrays_is_split(trained):
    """Adam's mu on each rank holds half of each sharded array (fsdp = 2)
    and all of each replicated one."""
    (_, params, _, _), ranks, _, _ = trained["transformer"]
    got = ranks[0]
    want = sum(v.numel() // (2 if k in got["dims"] else 1) for k, v in params.items())
    assert got["adam_elems"] == want < sum(v.numel() for v in params.values())


def test_world_of_one_is_bitwise_data_parallelism(tmp_path):
    """The slice's check at a small size on the CPU: one executor, the LM
    fully sharded on ``{"dp": 1, "fsdp": -1}`` against ``{"dp": -1}``,
    eager steps, the loop, then checkpoint → reshard_restore → a step."""
    from tensorflowonspark_tpu_torch.examples.transformer import fsdp_check, transformer_spark

    data_dir = str(tmp_path / "corpus")
    transformer_spark.make_text_corpus(data_dir, num_shards=2, records_per_shard=40)
    out = fsdp_check.main(["--platform", "cpu", "--size", "small", "--eager_steps", "2", "--steps_per_loop",
                           "2", "--pairs", "1", "--data_dir", data_dir, "--work_dir", str(tmp_path / "work")])
    assert fsdp_check.failures(out) == []
    assert out["fsdp"]["params_sharded"] == 2 and out["dp"]["params_sharded"] == 0
    # 2 eager steps, 2 loop calls, a timed turn (a step and a call), then a step after the restore
    assert out["fsdp"]["losses"] == out["dp"]["losses"] and len(out["fsdp"]["losses"]) == 2 + 2 + 2
    assert out["restored_step"] == 2 + 2 * 2 + (1 + 2) and out["resumed_step"] == out["restored_step"] + 1


def test_sync_dp_check_fsdp_rehearsal():
    """``sync_dp_check --fsdp`` on 4 CPU ranks at the small size: the
    ZeRO-3 legs agree with the data-parallel leg within 1e-5 (f32), every
    rank's gathered parameters equal, the loop bitwise the eager steps."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "tensorflowonspark_tpu_torch.examples.sync_dp_check", "--platform", "cpu",
         "--world", "4", "--size", "small", "--steps", "2", "--pairs", "0", "--fsdp"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    import json

    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    assert [(x["model"], x["leg"]) for x in lines] == [
        (m, leg) for m in ("resnet50", "transformer") for leg in ("dp", "dp2_fsdp2", "fsdp4")]
    for x in lines:
        assert x["tensors_off_rank0"] == 0 and not x["loop_vs_eager_mismatches"]
        if x["leg"] != "dp":
            assert x["params_sharded"] > 0 and x["loss_rel_gap_to_dp"] <= 1e-5
