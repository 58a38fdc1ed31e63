"""The port's image real-data plane against the JAX package's: the same
shards (written with the JAX package's encoders from a numpy seed) and the
same seed through both ``ImagePipeline``s give byte-identical batches — the
tolerance of the reference's own stream-invariance tests — in every decode
mode of the port (PIL threads, native threads, the forked decode plane, the
slab cache cold and warm), for ImageNet and CIFAR, train and eval. Then the
slice as a whole: the port's ``resnet_spark`` on ``--data_dir`` /
``--eval_dir`` through ``TFCluster.run`` held to the JAX package's loss,
gradients, BN statistics and eval on the same weights."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_plane_util import stream, write_cifar_shards, write_imagenet_shards

from tensorflowonspark_tpu.data import ImagePipeline as JImagePipeline
from tensorflowonspark_tpu.data import cifar as jax_cifar
from tensorflowonspark_tpu.data import imagenet as jax_imagenet
from tensorflowonspark_tpu.models import resnet as jax_resnet
from tensorflowonspark_tpu_torch import TFCluster, convert, native_io, obs, util
from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
from tensorflowonspark_tpu_torch.data import ImagePipeline, cifar, imagenet
from tensorflowonspark_tpu_torch.examples.resnet import resnet_spark
from tensorflowonspark_tpu_torch.models import resnet
from tensorflowonspark_tpu_torch.train import checkpoint

PIPE = dict(batch_size=4, seed=3, readahead=2, chunk_records=8)


def _counter(name):
    return obs.snapshot()["counters"].get(name, {}).get("value", 0)


def _parse_fns(dataset, training):
    """(port parse, JAX parse) of one dataset and split, the examples'
    settings (ImageNet ships uint8)."""
    if dataset == "cifar":
        return cifar.make_parse_fn(training, seed=5), jax_cifar.make_parse_fn(training, seed=5)
    kw = dict(image_size=24, seed=5, raw_uint8=True)
    return imagenet.make_parse_fn(training, **kw), jax_imagenet.make_parse_fn(training, **kw)


def _shards(tmp_path, dataset):
    if dataset == "cifar":
        return write_cifar_shards(tmp_path, n=30)
    return write_imagenet_shards(tmp_path, n=30)


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.delenv(native_io.DECODE_ENV_VAR, raising=False)
    monkeypatch.delenv("TOS_DECODE_WORKERS", raising=False)
    monkeypatch.delenv("TOS_SLAB_CACHE_DIR", raising=False)
    return monkeypatch


@pytest.mark.parametrize("dataset", ["imagenet", "cifar"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_batches_are_byte_identical_in_every_decode_mode(tmp_path, no_native, dataset, training):
    """The JAX package's PIL thread pool is the reference; the port's PIL
    threads, native threads, two decode workers and the slab cache (cold,
    then warm) all deliver its bytes. Eval keeps the short last batch."""
    files = _shards(tmp_path, dataset)
    parse, jparse = _parse_fns(dataset, training)
    kw = dict(PIPE, shuffle=training, epochs=1, drop_remainder=training)
    no_native.setenv(native_io.DECODE_ENV_VAR, "0")
    want = stream(JImagePipeline(files, jparse, decode_workers=0, **kw))
    assert len(want) == (7 if training else 8)
    assert stream(ImagePipeline(files, parse, decode_workers=0, **kw)) == want  # PIL threads
    no_native.delenv(native_io.DECODE_ENV_VAR)
    native0 = _counter("decode_native_total")
    assert stream(ImagePipeline(files, parse, decode_workers=0, **kw)) == want  # native threads
    if dataset == "imagenet":  # all but the bootstrap record, parsed whole to learn the geometry
        assert _counter("decode_native_total") - native0 == 29
    assert stream(ImagePipeline(files, parse, decode_workers=2, **kw)) == want
    cache = str(tmp_path / "slab-cache")
    assert stream(ImagePipeline(files, parse, slab_cache_dir=cache, **kw)) == want  # cold
    hits = _counter("decode_cache_hits_total")
    assert stream(ImagePipeline(files, parse, slab_cache_dir=cache, **kw)) == want  # warm
    # ImageNet's parse keys the cache (CIFAR's has no cache_key: no cache);
    # every record but the bootstrap one is a hit
    assert _counter("decode_cache_hits_total") - hits == (29 if dataset == "imagenet" else 0)


def test_endless_stream_across_epochs_with_the_plane_and_cache_matches(tmp_path, no_native):
    """The trainer's setting — ``epochs=None`` on one worker's
    ``shard_files`` share — across two epoch boundaries."""
    from tensorflowonspark_tpu_torch.data import shard_files

    files = shard_files(write_imagenet_shards(tmp_path, n=36, shards=4), 2, 1)
    parse, jparse = _parse_fns("imagenet", True)
    kw = dict(PIPE, epochs=None)
    want = stream(JImagePipeline(files, jparse, decode_workers=0, **kw), n_batches=12)
    got = stream(ImagePipeline(files, parse, decode_workers=2, slab_cache_dir=str(tmp_path / "c"), **kw),
                 n_batches=12)
    assert got == want


def test_parse_fns_match_the_jax_package(tmp_path):
    """Record for record: train and eval, float32 (mean-subtracted) and
    uint8, ImageNet and CIFAR, and the record encoders."""
    img = np.random.default_rng(1).integers(0, 256, (45, 61, 3), dtype=np.uint8)
    assert imagenet.encode_example(img, 9) == jax_imagenet.encode_example(img, 9)
    assert cifar.encode_example(img[:32, :32], 4) == jax_cifar.encode_example(img[:32, :32], 4)
    rec = jax_imagenet.encode_example(img, 9)
    for training in (True, False):
        for raw in (True, False):
            got = imagenet.make_parse_fn(training, image_size=32, seed=2, raw_uint8=raw)(rec)
            want = jax_imagenet.make_parse_fn(training, image_size=32, seed=2, raw_uint8=raw)(rec)
            assert got[1] == want[1] and got[0].dtype == want[0].dtype
            assert np.array_equal(got[0], want[0])
        crec = jax_cifar.encode_example(img[:32, :32], 4)
        got, want = cifar.make_parse_fn(training, seed=2)(crec), jax_cifar.make_parse_fn(training, seed=2)(crec)
        assert got[1] == want[1] and np.array_equal(got[0], want[0])


def test_device_normalize_is_the_host_mean_subtraction():
    img = np.random.default_rng(2).integers(0, 256, (2, 4, 4, 3), dtype=np.uint8)
    got = imagenet.device_normalize(torch.as_tensor(img))
    assert np.array_equal(got.numpy(), img.astype(np.float32) - jax_imagenet.CHANNEL_MEANS)


def test_decode_plane_forks_at_iter_and_goes_down_with_an_unstarted_stream(tmp_path, no_native):
    """The plane's workers exist once ``iter()`` returns (a trainer takes
    its iterator before CUDA), and a stream dropped before its first
    ``next()`` takes them down."""
    import gc

    files = write_imagenet_shards(tmp_path, n=8, shards=1)
    parse, _ = _parse_fns("imagenet", True)
    it = iter(ImagePipeline(files, parse, 4, decode_workers=2, epochs=1))
    assert obs.snapshot()["gauges"]["decode_workers"]["value"] == 2
    del it
    gc.collect()
    assert obs.snapshot()["gauges"]["decode_workers"]["value"] == 0


# -- the slice as a whole ---------------------------------------------------

SLICE = ["--platform", "cpu", "--dataset", "cifar", "--batch_size", "4", "--train_steps", "2",
         "--log_steps", "1", "--bn_impl", "pallas", "--data_threads", "2", "--dtype", "fp32"]


def _to_flax(module, jvars):
    """The port's module → flax variables of the JAX model's tree (the
    inverse of ``convert.convert_variables``, leaf by leaf)."""
    sd = module.state_dict()

    def tree(collection, sub, path=()):
        out = {}
        for key, value in sub.items():
            if isinstance(value, dict) or hasattr(value, "items"):
                out[key] = tree(collection, value, path + (key,))
                continue
            name, _ = convert._convert_leaf(collection, path + (key,), value)
            arr = sd[name].detach().float().numpy().copy()  # jax may alias numpy memory
            if key == "kernel":
                arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            assert arr.shape == np.shape(value), name
            out[key] = jnp.asarray(arr)
        return out

    return {c: tree(c, jvars[c]) for c in ("params", "batch_stats")}


def test_resnet_spark_trains_and_evaluates_from_shards_like_the_jax_package(tmp_path, no_native):
    """``resnet_spark`` (ResNet-56, 32 px, ``bn_impl="pallas"``) trains 2
    SGD steps from ``--data_dir`` through ``TFCluster.run`` and scores
    ``--eval_dir``. Held to the JAX package on converted weights: the first
    step's loss (1e-4), gradients (2e-3) and BN statistics (1e-4) on the
    batch both pipelines deliver, both steps' losses, the final BN
    statistics, and the eval's correct count equal to the JAX example's
    eval over the same shards with the trained parameters."""
    train = write_cifar_shards(tmp_path, n=24, shards=2, name="train")
    evals = write_cifar_shards(tmp_path, n=10, shards=1, seed=1, name="eval")
    model_dir = str(tmp_path / "model")
    args = resnet_spark.build_parser().parse_args(SLICE + [
        "--data_dir", os.path.dirname(train[0]), "--eval_dir", os.path.dirname(evals[0]),
        "--model_dir", model_dir])
    sc = LocalSparkContext(num_executors=1, task_timeout=180)
    try:
        cluster = TFCluster.run(sc, resnet_spark.main_fun, args, 1, input_mode=TFCluster.InputMode.TENSORFLOW,
                                master_node="chief", env={util.ENV_PLATFORM: "cpu"})
        assert cluster.wait_for_completion(timeout=180)
        events = cluster.metrics(include_driver=False)["events"]
        cluster.shutdown()
    finally:
        sc.stop()
    losses = [e["loss"] for e in sorted(events, key=lambda e: e.get("step", 0)) if e.get("span") == "train_step"]
    (ev,) = [e for e in events if e.get("span") == "eval"]
    assert len(losses) == 2 and ev["examples"] == 10

    # the trainer's start: the example's seeded init
    module = resnet.resnet56(bn_impl="pallas", generator=torch.Generator().manual_seed(0)).train()
    jmodel = jax_resnet.resnet56()
    x0 = np.zeros((4, 32, 32, 3), np.float32)
    jvars = jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False))(x0)
    variables = _to_flax(module, jvars)
    # the trainer's stream (executor 0 of 1: its parse seed and shuffle seed)
    kw = dict(batch_size=4, seed=0, epochs=None)
    batches = stream(ImagePipeline(train, cifar.make_parse_fn(True, seed=0), **kw), n_batches=2)
    assert batches == stream(JImagePipeline(train, jax_cifar.make_parse_fn(True, seed=0), **kw), n_batches=2)
    batches = [{"image": np.frombuffer(b[2], np.float32).reshape(b[1]).copy(), "label": np.frombuffer(b[3], np.int32).copy()}
               for b in batches]

    # step 1: loss, gradients and BN statistics on converted weights
    loss_fn = resnet.make_loss_fn(weight_decay=1e-4)
    tloss, (tstate, _) = loss_fn(module, dict(module.named_buffers()),
                                 {k: torch.as_tensor(v) for k, v in batches[0].items()})
    tloss.backward()
    jloss_fn = jax_resnet.make_loss_fn(jmodel, weight_decay=1e-4)
    grad_fn = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))
    (jloss, (jstate, _)), jgrads = grad_fn(variables["params"], {"batch_stats": variables["batch_stats"]},
                                           batches[0])
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-4)
    want = convert.convert_variables({"params": jax.tree.map(np.asarray, jgrads)})
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=2e-3, err_msg=name)
    want = convert.convert_variables({"batch_stats": jax.tree.map(np.asarray, jstate["batch_stats"])})
    for name, value in want.items():
        np.testing.assert_allclose(tstate[name].numpy(), value.numpy(), atol=1e-4, err_msg=name)

    # the JAX package's two SGD steps (the example's optimizer) against the
    # trainer's logged losses and its final checkpoint's BN statistics
    tx = optax.sgd(resnet_spark.lr_schedule(args), momentum=0.9)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    jlosses = []
    for b in batches:
        (jloss, (jstate, _)), jgrads = grad_fn(params, {"batch_stats": stats}, b)
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params, stats = optax.apply_updates(params, updates), jstate["batch_stats"]
        jlosses.append(float(jloss))
    np.testing.assert_allclose(losses, jlosses, atol=1e-4)
    saved = checkpoint.restore_checkpoint(os.path.join(model_dir, "ckpt_2"))
    assert saved["step"] == 2
    trained = resnet.resnet56(bn_impl="pallas")
    trained.load_state_dict(dict(saved["params"], **saved["model_state"]))
    want = convert.convert_variables({"batch_stats": jax.tree.map(np.asarray, stats)})
    got = trained.state_dict()
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-4, err_msg=name)

    # the JAX example's eval on the trained parameters, over all eval shards
    tvars = _to_flax(trained, jvars)
    eval_fn = jax.jit(jax_resnet.make_eval_fn(jmodel))
    correct = total = 0
    for b in JImagePipeline(evals, jax_cifar.make_parse_fn(False), 4, shuffle=False, epochs=1,
                            drop_remainder=False):
        c, n = eval_fn(tvars["params"], {"batch_stats": tvars["batch_stats"]}, b)
        correct, total = correct + int(c), total + int(n)
    assert (ev["correct"], ev["examples"]) == (correct, total)
