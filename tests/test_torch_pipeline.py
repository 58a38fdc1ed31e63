"""The port's ``pipeline.py``, ``dfutil.py``, ``TFParallel.py`` and
``train/export.py`` on the CPU.

* The cases of ``tests/test_pipeline.py`` and ``tests/test_dfutil.py``
  (the JAX package's copies of these modules) re-run against the port's:
  param plumbing, the fit → export → transform loop with a known-weights
  regressor (weights 3.14 / 1.618), TFRecord provenance reuse, the Example
  codec, DataFrame round trips and TFParallel's independent instances.
* Export bundles: the npz lane holds plain arrays of a ``{name: tensor}``
  tree (a ``bfloat16`` leaf in the JAX package's tagged byte layout), the
  builder runs only at load (with the caller's ``device`` when it takes
  one), the ``trusted_builder`` lane, and a re-export removes the other
  lane's weights.
* ``TFEstimator.fit`` then ``TFModel.transform`` on a ``LocalDataFrame``
  with one executor: the predictions equal the bundle's ``predict_fn``
  applied directly, row for row.
"""

import os

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import dfutil, pipeline, tfrecord, util
from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
from tensorflowonspark_tpu_torch.train import export

CPU_ENV = {util.ENV_PLATFORM: "cpu"}


@pytest.fixture(scope="module")
def sc():
    ctx = LocalSparkContext(num_executors=2, task_timeout=300)
    yield ctx
    ctx.stop()


# -- tests/test_pipeline.py ----------------------------------------------------


class TestNamespace:
    def test_from_dict(self):
        ns = pipeline.Namespace({"a": 1, "b": "x"})
        assert ns.a == 1 and "b" in ns

    def test_from_namespace(self):
        ns = pipeline.Namespace(pipeline.Namespace({"a": 2}))
        assert ns.a == 2

    def test_from_argv(self):
        ns = pipeline.Namespace(["--foo", "1"])
        assert ns.argv == ["--foo", "1"]

    def test_bad_type(self):
        with pytest.raises(TypeError):
            pipeline.Namespace(42)


class TestParams:
    def test_defaults_all_mixins_initialized(self):
        est = pipeline.TFEstimator(lambda a, c: None, {})
        m = est.extractParamMap()
        assert m["batch_size"] == 100
        assert m["cluster_size"] == 1
        assert m["epochs"] == 1
        assert m["master_node"] == "chief"
        assert m["protocol"] == "ici"
        assert m["num_ps"] == 0

    def test_setters_override_args(self):
        est = pipeline.TFEstimator(lambda a, c: None, {"batch_size": 7, "other": "keep"})
        est.setBatchSize(32).setClusterSize(2)
        args = est.merge_args_params()
        assert args.batch_size == 32  # param wins over tf_args
        assert args.cluster_size == 2
        assert args.other == "keep"

    def test_input_mode_tensorflow_rejected(self):
        from tensorflowonspark_tpu_torch.TFCluster import InputMode

        est = pipeline.TFEstimator(lambda a, c: None, {})
        with pytest.raises(ValueError):
            est.setInputMode(InputMode.TENSORFLOW)

    def test_unknown_param_rejected(self):
        est = pipeline.TFEstimator(lambda a, c: None, {})
        with pytest.raises(ValueError):
            est._set(nope=1)

    def test_params_copy_to_model(self):
        est = pipeline.TFEstimator(lambda a, c: None, {})
        est.setBatchSize(5)
        model = pipeline.TFModel({})
        est.copyParamsTo(model)
        assert model.getBatchSize() == 5

    def test_call_scoped_params_do_not_stick(self):
        """``fit``/``transform`` extra params apply to that call only (the
        reference's stickiness contract); setters stick."""
        model = pipeline.TFModel({})
        model.setBatchSize(9).setInputMapping({"a": "a"}).setOutputMapping({"y": "y"})
        with pytest.raises(ValueError, match="export_dir"):
            model.transform(None, params={"batch_size": 3})
        assert model.getBatchSize() == 9


def linear_builder(device=None):
    """``predict_builder`` of the regressor bundle: ``y_ = x·w + b`` in torch
    on ``device`` (the CPU here)."""
    dev = torch.device(device or "cpu")

    def predict(params, model_state, arrays):
        x = torch.as_tensor(np.asarray(arrays["x"], np.float32), device=dev)
        w = torch.as_tensor(np.asarray(params["w"]), device=dev)
        b = torch.as_tensor(np.asarray(params["b"]), device=dev)
        return {"y_": (x @ w + b).cpu().numpy()}

    return predict


def _train_fn(args, ctx):
    """Linear regressor y = w.x + b on the feed; the chief exports a bundle."""
    import numpy as _np
    import torch as _torch

    from tensorflowonspark_tpu_torch.train import SyncDataParallel, export as _export, optim

    strategy = SyncDataParallel(ctx.device)

    class Linear(_torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = _torch.nn.Parameter(_torch.zeros(2, 1))
            self.b = _torch.nn.Parameter(_torch.zeros(1))

    def loss_fn(module, batch):
        pred = batch["x"] @ module.w + module.b
        return ((pred - batch["y"]) ** 2).mean()

    opt = optim.adam(0.3)
    state = strategy.create_state(Linear, opt)
    step = strategy.compile_train_step(loss_fn, opt)

    feed = ctx.get_data_feed(train_mode=True)
    while not feed.should_stop():
        batch = feed.next_batch(args.batch_size)
        if not batch:
            break
        x = _np.asarray([row[0] for row in batch], _np.float32)
        y = _np.asarray([row[1] for row in batch], _np.float32).reshape(-1, 1)
        state, _ = step(state, strategy.shard_batch({"x": x, "y": y}))

    if ctx.job_name in ("chief", "master"):
        _export.export_model(args.export_dir, linear_builder, state.params)


def _regression_data(n=256):
    rng = np.random.default_rng(0)
    w_true = np.array([[3.14], [1.618]], np.float32)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    return x, (x @ w_true).ravel() + 0.5


def test_fit_and_transform_equal_the_bundles_predict_fn(tmp_path):
    """``TFEstimator.fit`` trains on one executor's feed and the chief
    exports; ``TFModel.transform`` in the executor predicts row for row
    what the bundle's ``predict_fn`` gives when called directly, and the
    regressor learned the function (the reference's check, atol 0.5)."""
    export_dir = str(tmp_path / "bundle")
    x, y = _regression_data()
    sc1 = LocalSparkContext(num_executors=1, task_timeout=300)
    try:
        df = sc1.createDataFrame([(x[i].tolist(), float(y[i])) for i in range(len(x))], ["features", "label"], 4)
        est = (
            pipeline.TFEstimator(_train_fn, {"export_dir": export_dir}, env=CPU_ENV)
            .setInputMapping({"features": "x", "label": "y"})
            .setBatchSize(32)
            .setEpochs(25)
            .setClusterSize(1)
            .setGraceSecs(5)
        )
        model = est.fit(df)
        assert export.is_model_bundle(export_dir)
        counters = (est.cluster_metrics_ or {}).get("counters", {})
        assert counters.get("feed_rows_total", {}).get("value") == 25 * len(x), counters
        assert model.env == CPU_ENV  # the executors predict on the estimator's platform

        model.setInputMapping({"features": "x"}).setExportDir(export_dir)
        model.setOutputMapping({"y_": "prediction"}).setBatchSize(16)
        preds_df = model.transform(sc1.createDataFrame([(r.tolist(),) for r in x[:40]], ["features"], 3))
        assert preds_df.columns == ["prediction"]
        preds = np.asarray([row[0] for row in preds_df.collect()]).ravel()
    finally:
        sc1.stop()
    predict_fn, params, model_state = export.load_model(export_dir, device="cpu")
    # the executor's batches: the DataFrame's 3 partitions (14, 13, 13 rows),
    # each one batch of 16 padded with its last row as TFModel.transform pads
    # it, so the direct call computes every row in the batch it ran in
    direct = []
    for part in np.array_split(x[:40], 3):
        batch = np.concatenate([part, np.repeat(part[-1:], 16 - len(part), axis=0)])
        direct.extend(np.asarray(predict_fn(params, model_state, {"x": batch})["y_"]).ravel()[:len(part)])
    np.testing.assert_array_equal(preds, np.asarray(direct))
    np.testing.assert_allclose(preds, y[:40], atol=0.5)


def test_tfrecord_dir_materializes_and_reuses(sc, tmp_path):
    """setTFRecordDir materializes the input DataFrame as shards; a DataFrame
    loaded FROM that directory is not re-written (provenance reuse,
    reference dfutil.py:15-26 loadedDF registry)."""
    import time as _time

    tfr_dir = str(tmp_path / "tfr")

    def train_noop(args, ctx):
        feed = ctx.get_data_feed(train_mode=True)
        while not feed.should_stop():
            feed.next_batch(16)

    df = sc.createDataFrame([(i, float(i)) for i in range(32)], ["a", "b"], 2)
    est = (
        pipeline.TFEstimator(train_noop, {}, env=CPU_ENV)
        .setInputMapping({"a": "a", "b": "b"})
        .setEpochs(1)
        .setClusterSize(2)
        .setMasterNode(None)
        .setTFRecordDir(tfr_dir)
    )
    est.fit(df)
    shards = tfrecord.list_shards(tfr_dir)
    assert shards, "tfrecord_dir was not materialized"
    mtimes = {s: os.path.getmtime(s) for s in shards}

    _time.sleep(0.05)
    loaded = dfutil.loadTFRecords(sc, tfr_dir)
    est.fit(loaded)  # provenance hit: must NOT rewrite the shards
    assert {s: os.path.getmtime(s) for s in tfrecord.list_shards(tfr_dir)} == mtimes


# -- tests/test_dfutil.py ------------------------------------------------------


class TestTFRecordCodec:
    def test_example_roundtrip(self):
        features = {
            "an_int": [42],
            "floats": [1.5, -2.25],
            "a_string": ["hello"],
            "raw": [b"\x00\x01\xff"],
        }
        decoded = tfrecord.decode_example(tfrecord.encode_example(features))
        assert decoded["an_int"] == ("int64", [42])
        assert decoded["floats"][0] == "float"
        np.testing.assert_allclose(decoded["floats"][1], [1.5, -2.25])
        assert decoded["a_string"] == ("bytes", [b"hello"])
        assert decoded["raw"] == ("bytes", [b"\x00\x01\xff"])

    def test_negative_int64(self):
        buf = tfrecord.encode_example({"x": [-7, 0, 123456789012345]})
        assert tfrecord.decode_example(buf)["x"] == ("int64", [-7, 0, 123456789012345])

    def test_record_file_roundtrip(self, tmp_path):
        path = str(tmp_path / "part-r-00000")
        records = [b"first", b"second record", b""]
        with tfrecord.TFRecordWriter(path) as w:
            for r in records:
                w.write(r)
        assert list(tfrecord.read_records(path)) == records

    def test_corrupt_crc_detected(self, tmp_path):
        path = str(tmp_path / "part-r-00000")
        with tfrecord.TFRecordWriter(path) as w:
            w.write(b"payload-bytes")
        raw = bytearray(open(path, "rb").read())
        raw[14] ^= 0xFF  # flip a payload byte
        open(path, "wb").write(bytes(raw))
        with pytest.raises(IOError, match="corrupt"):
            list(tfrecord.read_records(path))

    def test_cross_validate_against_tensorflow(self):
        """Our wire bytes must parse with TF's own proto class, and vice
        versa (TF serves validation only)."""
        tf = pytest.importorskip("tensorflow")
        ours = tfrecord.encode_example({"i": [1, -2], "f": [0.5], "s": [b"abc"]})
        ex = tf.train.Example.FromString(ours)
        assert list(ex.features.feature["i"].int64_list.value) == [1, -2]
        assert list(ex.features.feature["s"].bytes_list.value) == [b"abc"]
        np.testing.assert_allclose(list(ex.features.feature["f"].float_list.value), [0.5])
        theirs = tf.train.Example(
            features=tf.train.Features(
                feature={
                    "i": tf.train.Feature(int64_list=tf.train.Int64List(value=[9, -9])),
                    "s": tf.train.Feature(bytes_list=tf.train.BytesList(value=[b"xyz"])),
                    "f": tf.train.Feature(float_list=tf.train.FloatList(value=[2.5, 3.5])),
                }
            )
        ).SerializeToString()
        decoded = tfrecord.decode_example(theirs)
        assert decoded["i"] == ("int64", [9, -9])
        assert decoded["s"] == ("bytes", [b"xyz"])
        np.testing.assert_allclose(decoded["f"][1], [2.5, 3.5])


class TestDFUtil:
    def test_dataframe_roundtrip(self, sc, tmp_path):
        out = str(tmp_path / "tfr")
        rows = [
            (i, float(i) * 1.5, "name-{}".format(i), [float(i), float(i + 1)], b"\x01\x02")
            for i in range(20)
        ]
        df = sc.createDataFrame(rows, ["idx", "score", "name", "vec", "blob"], 4)
        dfutil.saveAsTFRecords(df, out, binary_features=["blob"])

        df2 = dfutil.loadTFRecords(sc, out, binary_features=["blob"])
        assert dfutil.isLoadedDF(df2)
        assert sorted(df2.columns) == ["blob", "idx", "name", "score", "vec"]
        got = sorted(df2.collect(), key=lambda r: r[df2.columns.index("idx")])
        ci = {c: i for i, c in enumerate(df2.columns)}
        for i, row in enumerate(got):
            assert row[ci["idx"]] == i
            assert abs(row[ci["score"]] - i * 1.5) < 1e-6
            assert row[ci["name"]] == "name-{}".format(i)
            np.testing.assert_allclose(row[ci["vec"]], [i, i + 1])
            assert row[ci["blob"]] == b"\x01\x02"

    def test_infer_schema(self):
        example = tfrecord.decode_example(
            tfrecord.encode_example({"a": [1], "b": [1.0, 2.0], "c": ["s"]})
        )
        schema = dfutil.infer_schema(example)
        assert schema["a"] == {"kind": "int64", "multi": False}
        assert schema["b"] == {"kind": "float", "multi": True}
        assert schema["c"] == {"kind": "string", "multi": False}

    def test_shard_overwrite_is_idempotent(self, tmp_path):
        """Retried partition writes must overwrite, not duplicate."""
        sc2 = LocalSparkContext(num_executors=1, task_timeout=60)
        try:
            out = str(tmp_path / "t")
            df = sc2.createDataFrame([(1,), (2,)], ["v"], 1)
            dfutil.saveAsTFRecords(df, out)
            dfutil.saveAsTFRecords(df, out)  # simulate a retry
            assert len(tfrecord.list_shards(out)) == 1
            assert dfutil.loadTFRecords(sc2, out).count() == 2
        finally:
            sc2.stop()

    def test_dfutil_roundtrip_file_uri(self, sc, tmp_path):
        out = "file://" + str(tmp_path / "uri_shards")
        df = sc.createDataFrame([(i, float(i) / 2) for i in range(20)], ["a", "b"], 2)
        dfutil.saveAsTFRecords(df, out)
        loaded = dfutil.loadTFRecords(sc, out)
        assert sorted(loaded.collect()) == [(i, float(i) / 2) for i in range(20)]
        assert dfutil.isLoadedDF(loaded)

    def test_mnist_rows_round_trip_through_tfrecords(self, sc, tmp_path):
        """``mnist_data_setup --format tfrecords``: the feed's rows come back
        from the shards as written."""
        from tensorflowonspark_tpu_torch.examples.mnist import mnist_data_setup

        out = str(tmp_path / "mnist_tfr")
        mnist_data_setup.main(["--output", out, "--num_examples", "40", "--num_partitions", "2"], sc=sc)
        images, labels = mnist_data_setup.synthetic_mnist(40)
        got = {}
        for shard in tfrecord.list_shards(out):
            for ex in tfrecord.read_examples(shard):
                got.setdefault(int(ex["label"][1][0]), []).append(np.asarray(ex["image"][1], np.float32))
        assert sum(len(v) for v in got.values()) == 40
        for label in set(labels.tolist()):
            want = sorted(images[labels == label].reshape(-1, 784).tolist())
            assert sorted(a.tolist() for a in got[label]) == want


class TestTFParallel:
    def test_independent_instances(self, sc, tmp_path):
        from tensorflowonspark_tpu_torch import TFParallel

        marker_dir = str(tmp_path)

        def fn(args, ctx):
            with open("{}/done-{}".format(args["dir"], ctx.executor_id), "w") as f:
                f.write("{} {}".format(ctx.num_workers, ctx.device))

        done = TFParallel.run(sc, fn, {"dir": marker_dir}, 2, env=CPU_ENV)
        assert sorted(done) == [0, 1]
        assert sorted(os.listdir(marker_dir)) == ["done-0", "done-1"]
        assert open(os.path.join(marker_dir, "done-0")).read() == "2 cpu"

    def test_more_instances_than_cards_are_refused(self, sc, tmp_path, monkeypatch):
        """Two instances on a host with one card: TFParallel refuses (the
        card count is the executors' ``TOS_GPUS_PER_HOST`` override here)."""
        from tensorflowonspark_tpu_torch import TFParallel, gpu_info

        def fn(args, ctx):
            raise AssertionError("must not run")

        class _Ctx:  # run the task in this process, as an executor would
            def parallelize(self, data, n, **_kw):
                return self

            def mapPartitions(self, task):
                self.task = task
                return self

            def collect(self):
                return [r for i in range(2) for r in self.task(iter([i]))]

        monkeypatch.setenv(gpu_info.ENV_DEVICE_COUNT, "1")
        with pytest.raises(RuntimeError, match="only 1 cards"):
            TFParallel.run(_Ctx(), fn, {}, 2, env={util.ENV_PLATFORM: "gpu"})

    @pytest.mark.parametrize("cards,per_card,want", [
        (1, 2, ["0", "0"]), (2, 2, ["0", "1"]), (4, 1, ["0,1", "2,3"]), (3, 2, ["0", "1", "2", "0"])])
    def test_instances_per_card_shares_the_cards(self, tmp_path, monkeypatch, cards, per_card, want):
        """CUDA cards take several processes: with ``instances_per_card``
        the instances of a host share its cards round robin once they
        outnumber them, and split them as before otherwise."""
        from tensorflowonspark_tpu_torch import TFParallel, gpu_info

        def fn(args, ctx):
            with open("{}/cards-{}".format(args["dir"], ctx.executor_id), "w") as f:
                f.write(os.environ["CUDA_VISIBLE_DEVICES"])

        n = len(want)

        class _Ctx:  # run the tasks in this process, as executors would
            def parallelize(self, data, n, **_kw):
                return self

            def mapPartitions(self, task):
                self.task = task
                return self

            def collect(self):
                return [r for i in range(n) for r in self.task(iter([i]))]

        monkeypatch.setenv(gpu_info.ENV_DEVICE_COUNT, str(cards))
        done = TFParallel.run(_Ctx(), fn, {"dir": str(tmp_path)}, n, env={util.ENV_PLATFORM: "gpu"},
                              instances_per_card=per_card)
        assert done == list(range(n))
        assert [open(tmp_path / "cards-{}".format(i)).read() for i in range(n)] == want
        with pytest.raises(ValueError, match="instances_per_card"):
            TFParallel.run(_Ctx(), fn, {}, 1, instances_per_card=0)


class TestRemoteFS:
    def test_tfrecord_roundtrip_memory_fs(self):
        base = "memory://tos-torch-test/shards"
        tfrecord.write_shard(base + "/part-00000", [{"x": [1, 2]}, {"x": [3]}])
        tfrecord.write_shard(base + "/part-00001", [{"x": [4]}])
        shards = tfrecord.list_shards(base)
        assert [s.rsplit("/", 1)[-1] for s in shards] == ["part-00000", "part-00001"]
        rows = [ex["x"][1] for s in shards for ex in tfrecord.read_examples(s)]
        assert rows == [[1, 2], [3], [4]]


# -- train/export.py -----------------------------------------------------------


_BUILT = []


def counting_builder(device=None):
    """A builder that records its calls (the lazy-build contract)."""
    _BUILT.append(device)
    return linear_builder(device)


def no_device_builder():
    return linear_builder()


def _params():
    return {"w": torch.tensor([[1.0], [2.0]]), "b": torch.tensor([0.5])}


def test_export_npz_lane_holds_plain_arrays(tmp_path):
    out = str(tmp_path / "b")
    params = dict(_params(), half=torch.arange(6, dtype=torch.bfloat16).reshape(2, 3))
    export.export_model(out, counting_builder, params, model_state={"bn": {"mean": torch.ones(3)}})
    with np.load(os.path.join(out, "weights.npz"), allow_pickle=False) as z:
        files = sorted(z.files)
        assert z["params/w"].dtype == np.float32 and z["params/w"].tolist() == [[1.0], [2.0]]
        assert z["params/half::dtype=bfloat16"].dtype == np.uint8
    assert files == ["model_state/bn/mean", "params/b", "params/half::dtype=bfloat16", "params/w"]
    predict_fn, loaded, model_state = export.load_model(out, device="cpu")
    assert isinstance(loaded["w"], np.ndarray) and np.array_equal(loaded["w"], [[1.0], [2.0]])
    assert loaded["half"].dtype == torch.bfloat16 and torch.equal(loaded["half"], params["half"])
    assert model_state["bn"]["mean"].tolist() == [1.0, 1.0, 1.0]
    np.testing.assert_allclose(predict_fn(loaded, {}, {"x": np.ones((1, 2), np.float32)})["y_"], [[3.5]])


def test_export_builder_is_lazy_and_takes_the_device(tmp_path):
    out = str(tmp_path / "b")
    _BUILT.clear()
    export.export_model(out, counting_builder, _params())
    assert _BUILT == []  # nothing built at export
    export.load_model(out, device="cpu")
    export.load_model(out)
    assert _BUILT == ["cpu", None]
    # the safe lane: the caller's builder, nothing unpickled from the bundle
    predict_fn, params, _ = export.load_model(out, trusted_builder=__name__ + ":no_device_builder")
    assert predict_fn(params, {}, {"x": np.zeros((1, 2), np.float32)})["y_"].tolist() == [[0.5]]
    assert export.resolve_builder(__name__ + ".no_device_builder") is no_device_builder
    with pytest.raises(TypeError, match="device"):
        export.load_model(out, trusted_builder=no_device_builder, device="cpu")
    with pytest.raises(ValueError):
        export.resolve_builder("nomodule")


def test_export_removes_the_other_lanes_weights(tmp_path):
    out = str(tmp_path / "b")
    os.makedirs(os.path.join(out, "checkpoint"))  # a JAX orbax-era bundle
    export.export_model(out, no_device_builder, [torch.ones(2)])  # not a dict tree: pickle lane
    assert sorted(os.listdir(out)) == ["predict_builder.pkl", "weights.pkl"]
    with pytest.raises(ValueError, match="npz"):
        export.load_model(out, trusted_builder=no_device_builder)
    _, params, _ = export.load_model(out)
    assert params[0].tolist() == [1.0, 1.0]
    export.export_model(out, no_device_builder, _params())
    assert sorted(os.listdir(out)) == ["predict_builder.pkl", "weights.npz"]
    os.remove(os.path.join(out, "weights.npz"))
    with pytest.raises(FileNotFoundError, match="re-export"):
        export.load_model(out)
    assert export.is_model_bundle(out) and not export.is_model_bundle(str(tmp_path))


def test_mnist_bundle_predicts_on_the_cpu_and_refuses_the_card_without_one(tmp_path):
    from tensorflowonspark_tpu_torch.models import mnist

    out = str(tmp_path / "mnist")
    model = mnist.MnistMLP(hidden=32, generator=torch.Generator().manual_seed(0))
    export.export_model(out, mnist.bundle_builder("mlp", hidden=32), dict(model.named_parameters()))
    predict_fn, params, model_state = export.load_model(out, device="cpu")
    x = np.random.default_rng(0).random((5, 784), dtype=np.float32)
    out_arrays = predict_fn(params, model_state, {"image": x})
    assert out_arrays["device"].tolist() == ["cpu"] * 5
    np.testing.assert_array_equal(out_arrays["prediction"],
                                  model(torch.from_numpy(x)).argmax(-1).numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export.load_model(out)  # the card by default: never the CPU


def test_feed_segments_are_outside_the_jax_packages_sweep():
    """The JAX package's ``shm.unlink_leaked`` sweeps its ``tosfeed_*`` /
    ``tosslab_*`` segments host-wide (its tests call it with a zero age,
    beside the port's clusters in other workers); the port's segments carry
    prefixes neither side's sweep matches, so an in-flight port chunk is
    never unlinked by it."""
    from tensorflowonspark_tpu import shm as jax_shm
    from tensorflowonspark_tpu_torch import shm

    port, jax = (shm.NAME_PREFIX, shm.SLAB_PREFIX), (jax_shm.NAME_PREFIX, jax_shm.SLAB_PREFIX)
    assert not any(p.startswith(jax) for p in port) and not any(j.startswith(port) for j in jax)
    chunk = shm.ShmChunk.from_rows([([1.0, 2.0], 3), ([4.0, 5.0], 6)])
    assert chunk.name.startswith(shm.NAME_PREFIX) and chunk.name in os.listdir("/dev/shm")
    assert [(list(f), int(y)) for f, y in chunk.rows()] == [([1.0, 2.0], 3), ([4.0, 5.0], 6)]
    assert chunk.name not in os.listdir("/dev/shm")
