"""The port's K-step train loop (``SyncDataParallel.compile_train_loop``),
its optimizer schedules on device tensors, ``run_steps`` and the prefetchers
that feed the loop, against the JAX package, on the CPU.

On the CPU the loop runs the eager step K times (the caller asked for the
CPU); on a CUDA device it captures the step in a CUDA graph and replays it
(``tests/test_torch_train_loop_cuda.py`` holds that against the eager step
on the card). Here the loop keeps the JAX version's contract — a list of K
device batches or one packed ``[K, ...]`` stack, the same ``ValueError``s,
the last step's metrics, ``state.step`` advanced by K — and matches the
JAX version's ``lax.scan`` loop from the same converted weights on the same
batches (float32).
"""

import os

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
from tensorflowonspark_tpu.train import strategy as jax_strategy
from tensorflowonspark_tpu_torch import convert, obs
from tensorflowonspark_tpu_torch.data import loop_prefetch, packed_prefetch
from tensorflowonspark_tpu_torch.models import resnet, transformer
from tensorflowonspark_tpu_torch.ops import kernel_trace
from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim
from tensorflowonspark_tpu_torch.train import strategy as strategy_mod

K = 3
RESNET = dict(stage_sizes=(1, 1), filters=(8, 16), num_classes=10, bottleneck=False, stem="cifar")
LM = dict(vocab_size=300, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=64)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_strategy():
    return JaxSyncDataParallel(parallel.build_mesh({"dp": 1}, devices=jax.devices()[:1]))


def _image_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((4, 8, 8, 3)).astype(np.float32),
             "label": rng.integers(0, 10, 4)} for _ in range(n)]


def _lm_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = rng.integers(1, LM["vocab_size"], (2, 33)).astype(np.int32)
        seg = np.ones_like(tokens)
        seg[:, 20:] = 2
        pos = np.concatenate([np.arange(20), np.arange(13)])[None].repeat(2, 0).astype(np.int32)
        out.append({"tokens": tokens, "segment_ids": seg, "positions": pos})
    return out


def _resnet_port(variables, bn_impl="pallas"):
    strategy = SyncDataParallel("cpu")
    optimizer = optim.sgd(0.1, momentum=0.9)
    state = strategy.create_state(
        lambda: convert.load_variables(resnet.ResNet(bn_impl=bn_impl, **RESNET), variables), optimizer)
    return strategy, optimizer, state


def _resnet_variables(batches, bn_impl="pallas"):
    jmodel = jax_resnet.ResNet(bn_impl=bn_impl, **RESNET)
    return jmodel, _np(jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False))(
        jnp.asarray(batches[0]["image"])))


@pytest.mark.parametrize("packed", [False, True])
def test_resnet_loop_matches_the_reference_loop(packed):
    """K=3 SGD steps (momentum 0.9, L2 in the loss) of the small ResNet
    with BN statistics (``mutable=True``), as a list of batches and as one
    packed stack: parameters and running statistics within 1e-5, the last
    step's loss and accuracy, and ``step`` advanced by 3."""
    batches = _image_batches(K)
    jmodel, variables = _resnet_variables(batches)
    jstrategy = _jax_strategy()
    tx = optax.sgd(0.1, momentum=0.9)
    jstate = jstrategy.create_state(lambda: variables, tx)
    jloop = jstrategy.compile_train_loop(jax_resnet.make_loss_fn(jmodel, weight_decay=1e-4), tx, K,
                                         mutable=True, donate=False, packed=packed)
    if packed:
        jstate, jmetrics = jloop(jstate, jstrategy.shard_batch(
            {k: np.stack([b[k] for b in batches]) for k in batches[0]}))
    else:
        jstate, jmetrics = jloop(jstate, [jstrategy.shard_batch(b) for b in batches])

    strategy, optimizer, state = _resnet_port(variables)
    loop = strategy.compile_train_loop(resnet.make_loss_fn(weight_decay=1e-4), optimizer, K,
                                       mutable=True, packed=packed)
    if packed:
        window = next(packed_prefetch(iter(batches), strategy, K))
    else:
        window = next(loop_prefetch(iter(batches), strategy, K))
    state, metrics = loop(state, window)

    assert state.step == K and metrics["step"] == K and int(jmetrics["step"]) == K
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), atol=1e-5)
    np.testing.assert_allclose(float(metrics["accuracy"]), float(jmetrics["accuracy"]), atol=1e-6)
    want = convert.convert_variables({"params": _np(jstate.params),
                                      "batch_stats": _np(jstate.model_state["batch_stats"])})
    got = dict(state.params, **state.model_state)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(), atol=1e-5, err_msg=name)
    assert int(state.opt_state["count"]) == K


def test_transformer_loop_matches_the_reference_loop():
    """K=3 AdamW(3e-4, the example's rate) steps of a small transformer
    (``has_aux=True``) on packed batches: parameters within 1e-5, the last
    step's loss and perplexity."""
    batches = _lm_batches(K, seed=1)
    jmodel = jtransformer.create_model(dtype="float32", attention="plain", **LM)
    params = _np(jtransformer.make_init_fn(jmodel, sample_len=8)(jax.random.PRNGKey(2))["params"])
    jstrategy = _jax_strategy()
    tx = optax.adamw(3e-4)
    jstate = jstrategy.create_state(lambda: {"params": params}, tx)
    jloop = jstrategy.compile_train_loop(jtransformer.make_loss_fn(jmodel), tx, K, has_aux=True,
                                         donate=False)
    jstate, jmetrics = jloop(jstate, [jstrategy.shard_batch(b) for b in batches])

    strategy = SyncDataParallel("cpu")
    optimizer = optim.adamw(3e-4)
    module = transformer.create_model(dtype="float32", attention="plain", **LM)
    state = strategy.create_state(lambda: convert.load_variables(module, {"params": params}), optimizer)
    loop = strategy.compile_train_loop(transformer.make_loss_fn(module), optimizer, K, has_aux=True)
    state, metrics = loop(state, [strategy.shard_batch(b) for b in batches])

    assert state.step == K and metrics["step"] == K
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), atol=1e-5)
    np.testing.assert_allclose(float(metrics["perplexity"]), float(jmetrics["perplexity"]), rtol=1e-5)
    want = convert.convert_variables({"params": _np(jstate.params)})
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, err_msg=name)


def test_loop_is_k_eager_steps_bitwise():
    """On the CPU the loop and K eager steps from the same state and batches
    end with bitwise-equal parameters, statistics, optimizer state and
    last-step metrics."""
    batches = _image_batches(K, seed=4)
    _, variables = _resnet_variables(batches)
    runs = []
    for use_loop in (True, False):
        strategy, optimizer, state = _resnet_port(variables)
        loss_fn = resnet.make_loss_fn(weight_decay=1e-4)
        placed = [strategy.shard_batch(b) for b in batches]
        if use_loop:
            state, metrics = strategy.compile_train_loop(loss_fn, optimizer, K, mutable=True)(state, placed)
        else:
            step = strategy.compile_train_step(loss_fn, optimizer, mutable=True)
            for b in placed:
                state, metrics = step(state, b)
        runs.append((state, metrics))
    (a, ma), (b, mb) = runs
    assert ma.keys() == mb.keys() and ma["step"] == mb["step"] == K
    for key in ("loss", "accuracy"):
        assert torch.equal(ma[key], mb[key]), key
    for name, value in dict(a.params, **a.model_state).items():
        assert torch.equal(value, dict(b.params, **b.model_state)[name]), name
    for name, value in a.opt_state["trace"].items():
        assert torch.equal(value, b.opt_state["trace"][name]), name
    assert torch.equal(a.opt_state["count"], b.opt_state["count"])


def test_loop_raises_the_reference_errors():
    """A wrong batch count or packed leading dimension raises ValueError
    with the JAX version's messages, before any step runs."""
    batches = _image_batches(2)
    _, variables = _resnet_variables(batches)
    strategy, optimizer, state = _resnet_port(variables)
    loss_fn = resnet.make_loss_fn(weight_decay=1e-4)
    loop = strategy.compile_train_loop(loss_fn, optimizer, K, mutable=True)
    placed = [strategy.shard_batch(b) for b in batches]
    with pytest.raises(ValueError, match="got 2 batches, loop compiled for 3"):
        loop(state, placed)
    packed = strategy.compile_train_loop(loss_fn, optimizer, K, mutable=True, packed=True)
    stack = {k: torch.stack([b[k] for b in placed]) for k in placed[0]}
    with pytest.raises(ValueError, match=r"packed window has leading dims \[2\], loop compiled for 3"):
        packed(state, stack)
    assert state.step == 0 and int(state.opt_state["count"]) == 0
    with pytest.raises(ValueError, match="num_steps"):
        strategy.compile_train_loop(loss_fn, optimizer, 0)
    with pytest.raises(ValueError, match="donate"):
        strategy.compile_train_loop(loss_fn, optimizer, K, donate="params")

    jstrategy = _jax_strategy()
    jloop = jstrategy.compile_train_loop(lambda p, b: 0.0, optax.sgd(0.1), K)
    with pytest.raises(ValueError, match="got 2 batches, loop compiled for 3"):
        jloop(None, [None, None])


def test_step_keyword_counts_through_the_loop():
    """A loss that declares ``step`` sees 0, 1, ... across loops and a
    tail of eager steps, as with the eager step alone."""
    strategy = SyncDataParallel("cpu")
    optimizer = optim.sgd(0.1)
    state = strategy.create_state(lambda: torch.nn.Linear(2, 1, bias=False), optimizer)
    seen = []

    def loss_fn(module, batch, step):
        seen.append(int(step))
        return module(batch["x"]).square().mean()

    loop = strategy.compile_train_loop(loss_fn, optimizer, 2)
    step = strategy.compile_train_step(loss_fn, optimizer)
    batch = strategy.shard_batch({"x": np.ones((3, 2), np.float32)})
    for _ in range(2):
        state, metrics = loop(state, [batch, batch])
    state, metrics = step(state, batch)
    assert seen == [0, 1, 2, 3, 4] and metrics["step"] == state.step == 5


@pytest.mark.parametrize("count", [0, 1, 3, 4, 5, 6, 90, 91, 92, 136, 137, 500])
def test_device_tensor_schedules_match_optax(count):
    """The schedules on int32 count tensors (the optimizer's device count)
    and on ints, against optax's on int32 counts: float32 results within
    1e-7 relative."""
    pairs = [
        (optim.linear_schedule(0.0, 0.25, 5), optax.linear_schedule(0.0, 0.25, 5)),
        (optim.linear_schedule(0.1, 0.001, 100, 3), optax.linear_schedule(0.1, 0.001, 100, 3)),
        (optim.linear_schedule(1.0, 0.5, 0), optax.linear_schedule(1.0, 0.5, 0)),
        (optim.piecewise_constant_schedule(0.1, {91: 0.1, 136: 0.1}),
         optax.piecewise_constant_schedule(0.1, {91: 0.1, 136: 0.1})),
    ]
    for port, ref in pairs:
        want = float(ref(jnp.asarray(count, jnp.int32)))
        got = port(torch.tensor(count, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-7)
        np.testing.assert_allclose(float(port(count)), want, rtol=1e-7)


def test_optimizer_count_is_a_device_tensor_advanced_in_place():
    """The count lives in the optimizer state as an int32 tensor on the
    parameters' device and is advanced in place (a captured step keeps
    advancing the same tensor); the learning rate is read from it."""
    for opt in (optim.sgd(optim.linear_schedule(0.0, 1.0, 4), momentum=0.9),
                optim.adamw(optim.piecewise_constant_schedule(1e-3, {2: 0.5}))):
        w = torch.nn.Parameter(torch.ones(3))
        state = opt.init({"w": w})
        count = state["count"]
        assert count.dtype == torch.int32 and count.device == w.device and int(count) == 0
        rates = []
        for _ in range(3):
            rates.append(float(opt.lr(count)))
            opt.update({"w": w}, {"w": torch.ones(3)}, state)
        assert state["count"] is count and int(count) == 3
        assert rates == [float(opt.lr(i)) for i in range(3)]


def test_run_steps_spans_and_hooks():
    """``run_steps`` over a loop: one ``step_fetch`` and one
    ``step_compute`` span a call (the global step as their attribute, and
    the ``{span}_seconds`` histograms), hooks see the global step from
    ``state.step`` on, and the last metrics come back."""
    strategy = SyncDataParallel("cpu")
    optimizer = optim.sgd(0.1)
    state = strategy.create_state(lambda: torch.nn.Linear(2, 1, bias=False), optimizer)
    state.step = 10
    loop = strategy.compile_train_loop(lambda m, b: m(b["x"]).square().mean(), optimizer, 2)
    batch = strategy.shard_batch({"x": np.ones((3, 2), np.float32)})
    seen = []
    fetched = obs.histogram("step_fetch_seconds").count
    computed = obs.histogram("step_compute_seconds").count
    state, metrics = strategy_mod.run_steps(loop, state, [[batch, batch]] * 3,
                                            hooks=[lambda s, step, m: seen.append((step, s.step))])
    assert seen == [(11, 12), (12, 14), (13, 16)] and metrics["step"] == 16
    assert obs.histogram("step_compute_seconds").count == computed + 3
    assert obs.histogram("step_fetch_seconds").count == fetched + 4  # the last fetch ends the loop


def test_run_steps_checkpoints_a_loop_through_the_engine(tmp_path):
    """``run_steps(engine=...)`` over a K=2 loop: the global step advances
    one a call, so ``save_every_n=2`` snapshots every second call (every 4
    train steps) in a ``ckpt_snapshot`` span; each commit holds the state
    of its own call — the step, parameters, momentum and count — and the
    engine is drained when the loop ends."""
    from tensorflowonspark_tpu_torch import ckpt
    from tensorflowonspark_tpu_torch.train import checkpoint

    strategy = SyncDataParallel("cpu")
    optimizer = optim.sgd(0.1, momentum=0.9)
    torch.manual_seed(0)
    state = strategy.create_state(lambda: torch.nn.Linear(2, 1), optimizer)
    loop = strategy.compile_train_loop(lambda m, b: m(b["x"]).square().mean(), optimizer, 2)
    batch = strategy.shard_batch({"x": np.ones((3, 2), np.float32)})
    seen = {}
    snapshots = obs.histogram("ckpt_snapshot_seconds").count
    engine = ckpt.AsyncCheckpointEngine(str(tmp_path), save_every_n=2)
    state, _ = strategy_mod.run_steps(
        loop, state, [[batch, batch]] * 4, engine=engine,
        hooks=[lambda s, step, m: seen.update({step: {k: v.detach().clone() for k, v in s.params.items()}})])
    assert engine.saves_accepted == 2 and engine.pending_desc() is None  # drained
    assert obs.histogram("ckpt_snapshot_seconds").count == snapshots + 2
    names = sorted(os.listdir(tmp_path))
    assert "ckpt_4" in names and set(names) <= {"ckpt_2", "ckpt_4"}
    for name in names:
        call = int(name.split("_")[1])
        tree = checkpoint.restore_checkpoint(os.path.join(tmp_path, name))
        assert tree["step"] == 2 * call and int(tree["opt_state"]["count"]) == 2 * call
        for key, value in seen[call].items():
            assert torch.equal(tree["params"][key], value)
    assert torch.equal(tree["opt_state"]["trace"]["weight"], state.opt_state["trace"]["weight"])
    engine.close()


@pytest.mark.parametrize("args", [(60000, 64, 3), (10, 64, 3), (1281167, 256, 4), (50000, 128, 0),
                                  (1000, 10, 7, 0.5)])
def test_steps_per_worker_matches_the_reference(args):
    assert strategy_mod.steps_per_worker(*args) == jax_strategy.steps_per_worker(*args)


def test_prefetchers_window_in_order_on_the_cpu():
    """loop_prefetch windows of K in order (the short tail dropped),
    packed_prefetch ``[K, ...]`` stacks, both placed with shard_batch on the
    CPU."""
    strategy = SyncDataParallel("cpu")
    host = [{"x": np.full((2, 3), i, np.float32), "y": np.arange(2) + i} for i in range(7)]
    windows = list(loop_prefetch(iter(host), strategy, num_steps=3))
    assert [len(w) for w in windows] == [3, 3]
    for got, want in zip([b for w in windows for b in w], host):
        assert isinstance(got["x"], torch.Tensor)
        np.testing.assert_array_equal(got["x"].numpy(), want["x"])
        np.testing.assert_array_equal(got["y"].numpy(), want["y"])
    stacks = list(packed_prefetch(iter(host), strategy, num_steps=3))
    assert [tuple(w["x"].shape) for w in stacks] == [(3, 2, 3), (3, 2, 3)]
    np.testing.assert_array_equal(stacks[1]["y"][2].numpy(), host[5]["y"])


def test_host_ints_ride_placement_and_loop_windows_on_the_host():
    """A batch's host ints (``sharding.sequence_chunk``'s ``row_length``)
    stay ints through ``shard_batch`` and the loop's prefetcher."""
    strategy = SyncDataParallel("cpu")
    host = [{"x": np.full((2, 3), i, np.float32), "row_length": 30 - i} for i in range(4)]
    assert strategy.shard_batch(host[0])["row_length"] == 30
    windows = list(loop_prefetch(iter(host), strategy, num_steps=2))
    assert [b["row_length"] for w in windows for b in w] == [30, 29, 28, 27]
    assert all(type(b["row_length"]) is int and isinstance(b["x"], torch.Tensor) for w in windows for b in w)


def test_a_captured_step_replays_only_its_own_host_values():
    """The captured step's batch check (``check_replay_batch``): the same
    keys, tensor shapes and dtypes, and host ints equal to the captured
    ones; a batch of another row length would replay the route the capture
    took for the first, so it raises."""
    static = {"tokens": torch.zeros(2, 9, dtype=torch.int32), "row_length": 30}
    strategy_mod.check_replay_batch({"tokens": torch.ones(2, 9, dtype=torch.int32), "row_length": 30}, static)
    for bad in ({"tokens": torch.ones(2, 9, dtype=torch.int32), "row_length": 29},
                {"tokens": torch.ones(2, 8, dtype=torch.int32), "row_length": 30},
                {"tokens": torch.ones(2, 9, dtype=torch.int32)}):
        with pytest.raises(ValueError, match="differs from the captured step"):
            strategy_mod.check_replay_batch(bad, static)


def test_eval_and_predict_steps_run_in_eval_mode_without_grad():
    """``compile_eval_step`` / ``compile_predict_step``: the module (or a
    TrainState's) in eval mode under no_grad, its mode restored after;
    the BN running statistics, not the batch's, normalize."""
    batches = _image_batches(1, seed=6)
    _, variables = _resnet_variables(batches)
    strategy, optimizer, state = _resnet_port(variables)
    seen = []

    def metric_fn(module, model_state, batch):
        seen.append((module.training, torch.is_grad_enabled()))
        return resnet.make_eval_fn()(module, model_state, batch)

    batch = strategy.shard_batch(batches[0])
    correct, count = strategy.compile_eval_step(metric_fn)(state, state.model_state, batch)
    logits = strategy.compile_predict_step(lambda m, b: m(b["image"]))(state.module, batch)
    assert seen == [(False, False)] and state.module.training and count == 4
    assert not logits.requires_grad and logits.shape == (4, 10)
    module = state.module.eval()
    with torch.no_grad():
        torch.testing.assert_close(logits, module(batch["image"]), rtol=0, atol=0)


def test_sync_dp_check_rehearses_on_the_cpu():
    """The multi-rank check's CPU rehearsal (two gloo ranks, small models):
    ranks agree bitwise, the loop matches the eager steps, one line a
    model."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", "tensorflowonspark_tpu_torch.examples.sync_dp_check",
                          "--platform", "cpu", "--world", "2", "--size", "small", "--steps", "2",
                          "--pairs", "0"], cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert [line["model"] for line in lines] == ["resnet50", "transformer"]
    for line in lines:
        assert line["world"] == 2 and line["loop_vs_eager_mismatches"] == [] and line["tensors_off_rank0"] == 0
        assert len(set(line["losses_by_rank"])) == 1


@pytest.mark.parametrize("name, want", [
    ("void bn_stats_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int, int, double*)", "bn_stats_kernel"),
    ("void (anonymous namespace)::flash_fwd_wgmma_kernel<64>(CUtensorMap, CUtensorMap, int)",
     "flash_fwd_wgmma_kernel"),
    ("normalize", "normalize"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
     "std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)",
     "vectorized_elementwise_kernel"),
])
def test_kernel_base_names(name, want):
    """A profiler's kernel name to the bare function name the wrappers'
    ``kernel_names`` list."""
    assert kernel_trace.kernel_base(name) == want


def test_every_counted_wrapper_names_its_kernels():
    """Each wrapper's ``kernel_names`` name ``__global__`` functions of its
    CUDA source, or the Triton kernels of ``ops/fused_bn.py``."""
    import os

    import tensorflowonspark_tpu_torch.ops as ops

    sources = ""
    for name in ("fused_bn.cu", "flash_attention.cu"):
        with open(os.path.join(os.path.dirname(ops.__file__), "..", "csrc", name)) as f:
            sources += f.read()
    with open(os.path.join(os.path.dirname(ops.__file__), "fused_bn.py")) as f:
        triton_src = f.read()
    for fn in kernel_trace.counted_wrappers():
        assert fn.kernel_names, fn.__name__
        for kernel in fn.kernel_names:
            assert (kernel + "(" in sources) or ("    def {}(".format(kernel) in triton_src), kernel


def test_kernel_trace_on_the_cpu_reads_host_ranges_and_no_kernels():
    """On the CPU a trace finds no device kernel (idle share 1) and reads
    the host ms of the call's ranges, within the window."""
    import time

    from torch.autograd.profiler import record_function

    with kernel_trace.KernelTrace() as trace:
        with record_function("train.call"):
            torch.ones(64, 64) @ torch.ones(64, 64)
            time.sleep(0.02)
        with record_function("train.sync"):
            pass
    got = trace.readings
    assert got["kernels"] == 0 and got["graph_launches"] == 0 and got["idle_share"] == 1.0
    assert got["launches"] == {fn.__name__: 0 for fn in kernel_trace.counted_wrappers()}
    assert got["host_ms"]["train.fetch"] == 0.0
    assert 20.0 <= got["host_ms"]["train.call"] <= got["window_ms"]
