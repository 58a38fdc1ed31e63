"""The port's ``serving.py`` held against the JAX package's on the CPU.

* The wire: the same raw request bytes sent to both packages' servers
  (each serving the linear ``y = x·w + b`` bundle of
  ``tests/test_serving.py``, exported by its own ``export.export_model``)
  give equal reply objects; the binary lane's raw reply frame is compared
  byte for byte; one case frames exactly as the Java client does.
* Models through both servers on converted weights
  (``convert.convert_variables``): the MNIST CNN (predictions equal, logits
  within 2e-5), a small ResNet in eval mode (logits within 1e-4), the
  transformer with packed segments (``logits_last`` within 2e-5).
* The coalescing predictor: each case of ``tests/test_serving.py`` run on
  the port's ``_Predictor`` and the JAX package's, on the same inputs.
* ``run_batch_inference``: the same shards through both packages give
  byte-identical output files, ``json`` and ``tfrecord``.
* The device lane: ``TOS_PLATFORM=cpu`` (or ``device="cpu"``) loads on the
  CPU; without it the port's builders take the card and raise here; a
  torch output reaches the wire as numpy; a stopped predictor lets go of
  its model.

The port runs with ``TOS_PLATFORM=cpu`` throughout.
"""

import gc
import json
import os
import socket
import struct
import threading
import time
import urllib.request
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import serving as jserving
from tensorflowonspark_tpu import tfrecord as jtfrecord
from tensorflowonspark_tpu.models import mnist as jmnist
from tensorflowonspark_tpu.models import resnet as jresnet
from tensorflowonspark_tpu.models import transformer as jtransformer
from tensorflowonspark_tpu.train import export as jexport
from tensorflowonspark_tpu_torch import convert, serving, tfrecord, util
from tensorflowonspark_tpu_torch.models import mnist, resnet, transformer
from tensorflowonspark_tpu_torch.train import export

W = np.array([[2.0], [3.0]], np.float32)
B = np.array([1.0], np.float32)


@pytest.fixture(autouse=True)
def _cpu_lane(monkeypatch):
    monkeypatch.setenv(util.ENV_PLATFORM, "cpu")


def jax_linear_builder():
    def predict(params, model_state, arrays):
        return {"y_": arrays["x"] @ params["w"] + params["b"]}

    return predict


def torch_linear_builder(device=None):
    """The port's linear bundle: torch on ``device``, torch tensors out."""
    dev = torch.device(device or "cuda")

    def predict(params, model_state, arrays):
        x = torch.as_tensor(np.asarray(arrays["x"], np.float32), device=dev)
        return {"y_": x @ torch.as_tensor(params["w"], device=dev) + torch.as_tensor(params["b"], device=dev)}

    return predict


def _bundles(tmp_path):
    jdir, tdir = str(tmp_path / "jax_bundle"), str(tmp_path / "torch_bundle")
    jexport.export_model(jdir, jax_linear_builder, {"w": W, "b": B})
    export.export_model(tdir, torch_linear_builder, {"w": W, "b": B})
    return jdir, tdir


@pytest.fixture
def servers(tmp_path):
    jdir, tdir = _bundles(tmp_path)
    js, ts = jserving.InferenceServer(jdir, host="127.0.0.1"), serving.InferenceServer(tdir, host="127.0.0.1")
    js.start()
    ts.start()
    yield js, ts
    js.stop()
    ts.stop()


def _frame(payload):
    return struct.pack(">I", len(payload)) + payload


def _read_frame(sock):
    hdr = b""
    while len(hdr) < 4:
        hdr += sock.recv(4 - len(hdr))
    (length,) = struct.unpack(">I", hdr)
    body = b""
    while len(body) < length:
        body += sock.recv(length - len(body))
    return body


def _exchange(address, frames, replies):
    """Send raw frames on one connection, read ``replies`` frames back."""
    with socket.create_connection(address, timeout=30) as sock:
        sock.sendall(b"".join(_frame(f) for f in frames))
        return [_read_frame(sock) for _ in range(replies)]


# -- the wire -------------------------------------------------------------------


@pytest.mark.parametrize("request_text", [
    '{"type": "ping"}',
    '{"type": "predict", "inputs": {"x": [[1.0, 1.0], [0.0, 2.0]]}}',
    '{"type": "predict", "inputs": {"x": [[0.5, -1.5]]}}',
    '{"type": "predict", "inputs": {"wrong_column": [[1.0]]}}',
    '{"type": "wat"}',
    '"not an object"',
])
def test_json_requests_get_equal_replies_from_both_servers(servers, request_text):
    js, ts = servers
    want = json.loads(_exchange(js.address, [request_text.encode()], 1)[0])
    got = json.loads(_exchange(ts.address, [request_text.encode()], 1)[0])
    assert got == want


def test_info_replies_match_but_for_the_bundle_path(servers):
    js, ts = servers
    want = json.loads(_exchange(js.address, [b'{"type": "info"}'], 1)[0])
    got = json.loads(_exchange(ts.address, [b'{"type": "info"}'], 1)[0])
    assert want.pop("export_dir").endswith("jax_bundle") and got.pop("export_dir").endswith("torch_bundle")
    assert got == want == {"type": "info", "ready": True}


@pytest.mark.parametrize("x", [
    np.array([[1.0, 1.0]], np.float32),
    np.array([[1.0, 2.0], [3.0, 0.5], [-4.0, 0.25]], np.float32),
])
def test_binary_lane_raw_reply_frames_are_byte_identical(servers, x):
    js, ts = servers
    header = json.dumps({"type": "predict_binary",
                         "columns": [{"name": "x", "dtype": "<f4", "shape": list(x.shape)}]}).encode()
    want = _exchange(js.address, [header, x.tobytes()], 2)
    got = _exchange(ts.address, [header, x.tobytes()], 2)
    assert got == want
    assert json.loads(got[0])["columns"] == [{"name": "y_", "dtype": "<f4", "shape": [len(x), 1]}]


def test_binary_lane_error_is_a_lone_frame_on_both(servers):
    js, ts = servers
    header = json.dumps({"type": "predict_binary",
                         "columns": [{"name": "x", "dtype": "<f4", "shape": [4, 2]}]}).encode()
    for srv in servers:  # payload shorter than declared: one error frame, then a pong
        replies = _exchange(srv.address, [header, b"\x00" * 8, b'{"type": "ping"}'], 2)
        assert json.loads(replies[0])["type"] == "error"
        assert json.loads(replies[1]) == {"type": "pong"}


def test_java_client_framing_on_both_servers(servers):
    """writeInt(length) + UTF-8 bytes, one request a connection, as
    jvm/.../InferenceClient.java frames it (tests/test_serving.py:45)."""
    text = '{"type": "predict", "inputs": {"x": [[1.0, 1.0], [0.0, 2.0]]}}'
    replies = []
    for srv in servers:
        with socket.create_connection(srv.address, timeout=30) as sock:
            data = text.encode("utf-8")
            sock.sendall(struct.pack(">I", len(data)) + data)
            replies.append(json.loads(_read_frame(sock).decode("utf-8")))
    assert replies[0] == replies[1] == {"type": "result", "outputs": {"y_": [[6.0], [7.0]]}}


def test_python_clients_roundtrip_both_lanes(servers):
    js, ts = servers
    x = np.array([[1.0, 2.0], [3.0, 0.5]], np.float32)
    jc, tc = jserving.InferenceClient(js.address), serving.InferenceClient(ts.address)
    try:
        assert tc.ping() and jc.ping()
        assert tc.predict(x=x) == jc.predict(x=x)
        out = tc.predict_binary(x=x)
        assert out["y_"].dtype == np.float32
        np.testing.assert_array_equal(out["y_"], jc.predict_binary(x=x)["y_"])
        with pytest.raises(RuntimeError):
            tc.predict_binary(wrong=np.zeros((1, 2), np.float32))
        assert tc.ping()  # the connection stays usable after an error reply
    finally:
        jc.close()
        tc.close()


# -- models through both servers, on converted weights ---------------------------


def _serve_both(jdir, tdir, inputs):
    """``predict_binary(**inputs)`` through each package's server."""
    out = []
    for mod, d in ((jserving, jdir), (serving, tdir)):
        srv = mod.InferenceServer(d, host="127.0.0.1")
        srv.start()
        try:
            client = mod.InferenceClient(srv.address)
            try:
                out.append(client.predict_binary(**inputs))
            finally:
                client.close()
        finally:
            srv.stop()
    return out


def jax_mnist_builder():
    """Built like bench.py's serving bundle (a jitted predict), with the
    logits beside the prediction."""
    model = jmnist.create_model("cnn")

    def predict(params, model_state, arrays):
        logits = model.apply({"params": params}, arrays["image"], train=False)
        return {"prediction": jnp.argmax(logits, -1), "logits": logits}

    return jax.jit(predict)


def torch_mnist_builder(device=None):
    module = mnist.create_model("cnn").to(device).eval()

    def predict(params, model_state, arrays):
        module.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
        with torch.no_grad():
            logits = module(torch.as_tensor(np.asarray(arrays["image"], np.float32)), train=False)
        return {"prediction": logits.argmax(-1), "logits": logits}

    return predict


def test_mnist_cnn_through_both_servers(tmp_path):
    """Predictions equal, logits within 2e-5 (the MNIST slice's limit); the
    port's own ``mnist.bundle_builder("cnn")`` serves the same classes."""
    jmodel = jmnist.create_model("cnn")
    jparams = jax.tree.map(np.asarray, jmnist.make_init_fn(jmodel)(jax.random.PRNGKey(0))["params"])
    tparams = {k: v.numpy() for k, v in convert.convert_variables({"params": jparams}).items()}
    jdir, tdir, odir = (str(tmp_path / n) for n in ("j", "t", "own"))
    jexport.export_model(jdir, jax_mnist_builder, jparams)
    export.export_model(tdir, torch_mnist_builder, tparams)
    export.export_model(odir, mnist.bundle_builder("cnn"), tparams)
    image = np.random.default_rng(0).random((6, 28, 28), dtype=np.float32)
    want, got = _serve_both(jdir, tdir, {"image": image})
    np.testing.assert_allclose(got["logits"], want["logits"], atol=2e-5)
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    _, own = _serve_both(jdir, odir, {"image": image})
    np.testing.assert_array_equal(own["prediction"], want["prediction"])
    assert set(own["device"].tolist()) == {"cpu"}


RESNET_SMALL = dict(stage_sizes=(2, 2, 2, 2), filters=(64, 128, 256, 512), bottleneck=False,
                    stem="imagenet", num_classes=10)


def jax_resnet_builder():
    model = jresnet.ResNet(**RESNET_SMALL)

    def predict(params, model_state, arrays):
        return {"logits": model.apply({"params": params, **model_state}, arrays["image"], train=False)}

    return jax.jit(predict)


def torch_resnet_builder(device=None):
    module = resnet.resnet18(num_classes=10).to(device).eval()

    def predict(params, model_state, arrays):
        module.load_state_dict({k: torch.as_tensor(v) for k, v in {**params, **model_state}.items()})
        with torch.no_grad():
            return {"logits": module(torch.as_tensor(np.asarray(arrays["image"], np.float32)))}

    return predict


def test_small_resnet_eval_through_both_servers(tmp_path):
    """``resnet18`` (32 px, 10 classes) in eval mode with drawn running
    statistics: logits within 1e-4 (the reference's BN tolerance)."""
    rng = np.random.default_rng(3)
    image = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    jmodel = jresnet.ResNet(**RESNET_SMALL)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False))(jnp.asarray(image)))
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"])
    state = convert.convert_variables({"params": variables["params"], "batch_stats": stats})
    names = set(dict(resnet.resnet18(num_classes=10).named_parameters()))
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jexport.export_model(jdir, jax_resnet_builder, variables["params"], model_state={"batch_stats": stats})
    export.export_model(tdir, torch_resnet_builder, {k: v.numpy() for k, v in state.items() if k in names},
                        model_state={k: v.numpy() for k, v in state.items() if k not in names})
    want, got = _serve_both(jdir, tdir, {"image": image})
    np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-4)


LM_SMALL = dict(vocab_size=300, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=128)


def jax_lm_builder():
    model = jtransformer.create_model(dtype="float32", attention="plain", **LM_SMALL)

    def predict(params, model_state, arrays):
        logits = model.apply({"params": params}, arrays["tokens"], positions=arrays["positions"],
                             segment_ids=arrays["segment_ids"])
        return {"logits_last": logits[:, -1]}

    return jax.jit(predict)


def torch_lm_builder(device=None):
    module = transformer.create_model(dtype="float32", attention="auto", **LM_SMALL).to(device).eval()

    def predict(params, model_state, arrays):
        module.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
        t = {k: torch.as_tensor(np.asarray(v)) for k, v in arrays.items()}
        with torch.no_grad():
            logits = module(t["tokens"].long(), positions=t["positions"].long(), segment_ids=t["segment_ids"])
        return {"logits_last": logits[:, -1]}

    return predict


def test_small_lm_packed_through_both_servers(tmp_path):
    """2 layers, d_model 64, seq 128, three packed segments and padding:
    ``logits_last`` within 2e-5 (JAX attention ``plain``; the port's
    ``auto``, plain on the CPU)."""
    jmodel = jtransformer.create_model(dtype="float32", attention="plain", **LM_SMALL)
    jparams = jax.tree.map(np.asarray, jtransformer.make_init_fn(jmodel, sample_len=8)(
        jax.random.PRNGKey(0))["params"])
    tparams = {k: v.numpy() for k, v in convert.convert_variables({"params": jparams}).items()}
    rng = np.random.default_rng(2)
    tokens, seg, pos = (np.zeros((3, 128), np.int32) for _ in range(3))
    for i, (lo, hi) in enumerate(((0, 50), (50, 90), (90, 125)), start=1):
        tokens[:, lo:hi] = rng.integers(1, 300, (3, hi - lo))
        seg[:, lo:hi], pos[:, lo:hi] = i, np.arange(hi - lo)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jexport.export_model(jdir, jax_lm_builder, jparams)
    export.export_model(tdir, torch_lm_builder, tparams)
    want, got = _serve_both(jdir, tdir, {"tokens": tokens, "segment_ids": seg, "positions": pos})
    assert got["logits_last"].shape == (3, 300)
    np.testing.assert_allclose(got["logits_last"], want["logits_last"], atol=2e-5)


# -- the coalescing predictor, on both packages -----------------------------------


def _linear(params, model_state, arrays):
    return {"y_": arrays["x"] @ W + B}


def _torch_linear(params, model_state, arrays):
    return {"y_": torch.as_tensor(arrays["x"]) @ torch.as_tensor(W) + torch.as_tensor(B)}


def _concurrent(fn, n):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)


@pytest.mark.parametrize("torch_fn", [False, True])
def test_coalesced_replies_equal_individual_runs_and_the_jax_package(torch_fn):
    """8 concurrent 2-row requests: each reply is what an individual run
    gives (bitwise, on the CPU) and what the JAX package's predictor gives."""
    outs = {}
    for name, mod in (("jax", jserving), ("torch", serving)):
        fn = _torch_linear if name == "torch" and torch_fn else _linear
        pred = mod._Predictor(fn, None, None)
        try:
            def call(i, pred=pred, name=name):
                outs[(name, i)] = pred.submit({"x": np.full((2, 2), float(i) + 0.1, np.float32)})

            _concurrent(call, 8)
        finally:
            pred.stop()
    for i in range(8):
        single = serving._to_numpy((_torch_linear if torch_fn else _linear)(
            None, None, {"x": np.full((2, 2), float(i) + 0.1, np.float32)})["y_"])
        np.testing.assert_array_equal(outs[("torch", i)]["y_"], single)
        np.testing.assert_array_equal(outs[("torch", i)]["y_"], outs[("jax", i)]["y_"])


def test_mixed_signature_requests_all_complete_on_both():
    results = {}
    for name, mod in (("jax", jserving), ("torch", serving)):
        pred = mod._Predictor(_linear, None, None)
        outs, errors = {}, []
        try:
            def majority(i):
                try:
                    for _ in range(10):
                        outs[("maj", i)] = pred.submit({"x": np.full((4, 2), float(i), np.float32)})
                except Exception as e:
                    errors.append(e)

            def minority(_i):
                try:
                    for _ in range(5):
                        outs["min"] = pred.submit({"x": np.full((2, 2), 9.0, np.float64)})
                except Exception as e:
                    errors.append(e)

            _concurrent(lambda i: majority(i) if i < 6 else minority(i), 7)
        finally:
            pred.stop()
        assert not errors, errors
        results[name] = outs
    np.testing.assert_allclose(results["torch"]["min"]["y_"], np.full((2, 1), 46.0))
    assert results["torch"]["min"]["y_"].dtype == results["jax"]["min"]["y_"].dtype == np.float64
    for key in results["jax"]:
        np.testing.assert_array_equal(results["torch"][key]["y_"], results["jax"][key]["y_"])


def _max_rows_case(mod):
    shapes, release, first = [], threading.Event(), threading.Event()

    def fn(params, model_state, arrays):
        shapes.append(arrays["x"].shape[0])
        if not first.is_set():
            first.set()
            release.wait(30)
        return {"y": arrays["x"].sum(axis=1, keepdims=True)}

    pred = mod._Predictor(fn, None, None, max_rows=8)
    outs = {}
    try:
        blocker = threading.Thread(target=lambda: outs.setdefault(
            "b", pred.submit({"x": np.ones((1, 2), np.float32)})))
        blocker.start()
        assert first.wait(30)
        threads = [threading.Thread(target=lambda i=i: outs.setdefault(
            i, pred.submit({"x": np.full((3, 2), float(i), np.float32)}))) for i in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.5)  # all three queue behind the blocked dispatch
        release.set()
        for t in [blocker] + threads:
            t.join(timeout=60)
    finally:
        release.set()
        pred.stop()
    return shapes, outs


def test_coalesce_respects_max_rows_cap_like_the_jax_package():
    """3+3+3 rows queued behind a blocked dispatch with max_rows 8: the
    first two coalesce (padded to the 8-row bucket), the third waits."""
    jshapes, jouts = _max_rows_case(jserving)
    shapes, outs = _max_rows_case(serving)
    assert max(shapes) <= 8 and shapes == jshapes == [1, 8, 3]
    for i in range(3):
        np.testing.assert_array_equal(outs[i]["y"], jouts[i]["y"])
        np.testing.assert_allclose(outs[i]["y"], np.full((3, 1), 2.0 * i))


def _overload_case(mod):
    release = threading.Event()

    def slow_fn(params, model_state, arrays):
        release.wait(30)
        return {"y": arrays["x"].sum(axis=1, keepdims=True)}

    pred = mod._Predictor(slow_fn, None, None, max_pending=3)
    before = (pred._requests_c.value, pred._shed_over_c.value, pred._latency_h.count)
    results, errors, shed = [], [], None
    try:
        def call(_i):
            try:
                results.append(pred.submit({"x": np.ones((4, 2), np.float32)}))
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=call, args=(0,))]
        threads[0].start()
        time.sleep(0.4)
        for i in range(2):
            threads.append(threading.Thread(target=call, args=(i,)))
            threads[-1].start()
        time.sleep(0.4)
        try:
            pred.submit({"x": np.ones((1, 2), np.float32)})
        except mod.Overloaded as e:
            shed = str(e)
        release.set()
        for t in threads:
            t.join(timeout=60)
    finally:
        release.set()
        pred.stop()
    after = (pred._requests_c.value, pred._shed_over_c.value, pred._latency_h.count)
    return shed, len(results), errors, tuple(a - b for a, b in zip(after, before))


def test_overload_sheds_with_error_like_the_jax_package():
    jshed, jserved, jerrors, jdeltas = _overload_case(jserving)
    shed, served, errors, deltas = _overload_case(serving)
    assert shed == jshed and "3 requests pending" in shed
    assert served == jserved == 3 and not errors and not jerrors
    assert deltas == jdeltas == (4, 1, 3)


def _deadline_case(mod):
    release = threading.Event()

    def slow_fn(params, model_state, arrays):
        release.wait(30)
        return {"y": arrays["x"].sum(axis=1, keepdims=True)}

    pred = mod._Predictor(slow_fn, None, None, deadline_ms=200)
    before = pred._shed_deadline_c.value
    results, errors = [], []
    try:
        def call():
            try:
                results.append(pred.submit({"x": np.ones((2, 2), np.float32)}))
            except Exception as e:
                errors.append(e)

        t0 = threading.Thread(target=call)
        t0.start()
        time.sleep(0.4)
        t1 = threading.Thread(target=call)
        t1.start()
        time.sleep(0.4)
        release.set()
        t0.join(timeout=60)
        t1.join(timeout=60)
    finally:
        release.set()
        pred.stop()
    return len(results), [type(e).__name__ + ": " + str(e) for e in errors], pred._shed_deadline_c.value - before


def test_deadline_sheds_stale_queued_requests_like_the_jax_package():
    want = _deadline_case(jserving)
    got = _deadline_case(serving)
    assert got == want
    assert got[0] == 1 and got[1][0].startswith("DeadlineExceeded") and got[2] == 1


def test_predictor_stop_is_idempotent():
    pred = serving._Predictor(lambda p, ms, a: {"y": a["x"]}, None, None, max_pending=1)
    pred.stop()
    second = threading.Thread(target=pred.stop)
    second.start()
    second.join(timeout=10)
    assert not second.is_alive(), "second stop() blocked"
    with pytest.raises(RuntimeError):
        pred.submit({"x": np.ones((1, 2), np.float32)})


# -- run_batch_inference ---------------------------------------------------------


def _write_shards(mod, data_dir):
    os.makedirs(data_dir)
    rows = [([float(i), float(2 * i)], i) for i in range(10)]
    for s in range(2):
        with mod.TFRecordWriter(os.path.join(data_dir, "part-{:05d}".format(s))) as w:
            for feats, label in rows[s * 5:(s + 1) * 5]:
                w.write(mod.encode_example({"x": feats, "label": [label]}))


@pytest.mark.parametrize("out_format", ["json", "tfrecord"])
def test_batch_inference_files_are_byte_identical(tmp_path, out_format):
    jdir, tdir = _bundles(tmp_path)
    data = str(tmp_path / "records")
    _write_shards(jtfrecord, data)
    kw = dict(batch_size=4, input_mapping={"x": "x"}, output_mapping={"y_": "prediction"},
              out_format=out_format)
    assert jserving.run_batch_inference(data, jdir, str(tmp_path / "jax_out"), **kw) == 10
    assert serving.run_batch_inference(data, tdir, str(tmp_path / "torch_out"), **kw) == 10
    names = sorted(os.listdir(tmp_path / "jax_out"))
    assert names == sorted(os.listdir(tmp_path / "torch_out")) and len(names) == 2
    for name in names:
        assert (tmp_path / "torch_out" / name).read_bytes() == (tmp_path / "jax_out" / name).read_bytes()
    if out_format == "tfrecord":
        rec = list(tfrecord.read_records(str(tmp_path / "torch_out" / names[0])))[2]
        np.testing.assert_allclose(tfrecord.decode_example(rec)["prediction"][1], [17.0])


def test_batch_inference_through_the_ports_live_server(tmp_path, servers):
    """Shards → the port's running server (binary lane) → output shards,
    the same bytes as the in-process run."""
    _, ts = servers
    _, tdir = _bundles(tmp_path / "again")
    data = str(tmp_path / "records")
    _write_shards(tfrecord, data)
    assert serving.run_batch_inference(data, None, str(tmp_path / "remote"), batch_size=3, server=ts.address) == 10
    assert serving.run_batch_inference(data, tdir, str(tmp_path / "local"), batch_size=3) == 10
    for name in sorted(os.listdir(tmp_path / "local")):
        assert (tmp_path / "remote" / name).read_bytes() == (tmp_path / "local" / name).read_bytes()


# -- the device lane, tensors out, the swapped-out model ------------------------


@pytest.mark.parametrize("lane,want", [(None, None), ("gpu", None), ("cpu", "cpu")])
def test_platform_device_reads_the_env_lane(monkeypatch, lane, want):
    if lane is None:
        monkeypatch.delenv(util.ENV_PLATFORM, raising=False)
    else:
        monkeypatch.setenv(util.ENV_PLATFORM, lane)
    assert serving.platform_device() == want


def test_platform_device_refuses_an_unknown_platform(monkeypatch):
    monkeypatch.setenv(util.ENV_PLATFORM, "tpu")
    with pytest.raises(ValueError, match="TOS_PLATFORM"):
        serving.platform_device()


def test_server_loads_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """Without the cpu lane the port's builders take the card: here, with
    no card, the server raises instead of falling back to the CPU."""
    tdir = str(tmp_path / "mnist")
    export.export_model(tdir, mnist.bundle_builder("mlp"), {
        k: v.numpy() for k, v in mnist.create_model("mlp").state_dict().items()})
    monkeypatch.delenv(util.ENV_PLATFORM)
    with pytest.raises(RuntimeError, match="sees no CUDA device"):
        serving.InferenceServer(tdir, host="127.0.0.1")
    srv = serving.InferenceServer(tdir, host="127.0.0.1", device="cpu")
    srv.start()
    try:
        client = serving.InferenceClient(srv.address)
        out = client.predict_binary(image=np.zeros((2, 784), np.float32))
        client.close()
        assert out["device"].tolist() == ["cpu", "cpu"] and srv.device is None
    finally:
        srv.stop()


def test_torch_outputs_reach_the_wire_as_numpy():
    t = torch.arange(6, dtype=torch.float32, requires_grad=True).reshape(2, 3) * 2
    got = serving._to_numpy(t)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.arange(6).reshape(2, 3) * 2)
    assert serving._to_numpy([1, 2]).tolist() == [1, 2]


class _Model(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(2, 1))


def test_a_swapped_out_predictor_lets_go_of_its_model(tmp_path):
    """After a hot swap the old predictor's thread drops its predict
    function, so the model it closed over (and, on the card, its memory)
    is freed."""
    jdir, tdir = _bundles(tmp_path)
    srv = serving.InferenceServer(tdir, host="127.0.0.1")
    srv.start()
    module = _Model()
    ref = weakref.ref(module)

    def fn(params, model_state, arrays, module=module):
        return {"y_": torch.as_tensor(arrays["x"]) @ module.w.detach()}

    first = serving._Predictor(fn, None, None)
    del module, fn
    try:
        srv.swap_predictor(first).stop()
        client = serving.InferenceClient(srv.address)
        assert client.predict_binary(x=np.ones((1, 2), np.float32))["y_"].tolist() == [[2.0]]
        predict_fn, params, model_state, _ = serving.load_bundle(tdir)
        srv.swap_predictor(serving._Predictor(predict_fn, params, model_state)).stop()
        assert client.predict_binary(x=np.ones((1, 2), np.float32))["y_"].tolist() == [[6.0]]
        client.close()
        gc.collect()
        assert ref() is None, "the swapped-out model is still referenced"
    finally:
        srv.stop()


def test_serve_cli_with_metrics_endpoint(tmp_path):
    """``serving.main(["serve", ...])`` on the CPU lane: a scrape shows the
    predictor's request counter; the client's predict is served."""
    _, tdir = _bundles(tmp_path)
    port, metrics_port = util.find_free_port(), util.find_free_port()
    t = threading.Thread(target=serving.main, args=(["serve", "--export_dir", tdir, "--host", "127.0.0.1",
                                                     "--port", str(port), "--metrics_port", str(metrics_port)],),
                         daemon=True)
    t.start()
    try:
        deadline, client = time.time() + 60, None
        while client is None and time.time() < deadline:
            try:
                client = serving.InferenceClient(("127.0.0.1", port), timeout=30)
            except ConnectionError:
                time.sleep(0.1)
        assert client.predict(x=[[1.0, 1.0]]) == {"y_": [[6.0]]}
        client.close()
        body = urllib.request.urlopen("http://127.0.0.1:{}/metrics".format(metrics_port), timeout=10).read()
        assert b"serving_requests_total" in body
    finally:
        deadline = time.time() + 10
        while serving._exit_event is None and time.time() < deadline:
            time.sleep(0.05)
        if serving._exit_event is not None:
            serving._exit_event.set()
        t.join(timeout=60)
    assert not t.is_alive(), "serve CLI did not shut down"


def test_cli_infer_matches_the_jax_packages_cli(tmp_path):
    """``main(["infer", ...])`` of both packages on the same shards."""
    jdir, tdir = _bundles(tmp_path)
    data = str(tmp_path / "records")
    _write_shards(tfrecord, data)
    for mod, d, out in ((jserving, jdir, "j"), (serving, tdir, "t")):
        mod.main(["infer", "--tfrecords", data, "--export_dir", d, "--output", str(tmp_path / out),
                  "--batch_size", "3", "--input_mapping", "x=x"])
    for name in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
