"""The train loop captured in a CUDA graph, and the BN reductions' split
mode, on a CUDA device. Marked ``cuda``: each test skips without a card.
This file imports neither jax nor the JAX package, so it also runs on a
card host that has only PyTorch (``python -m pytest --noconftest -m cuda
tests/test_torch_train_loop_cuda.py``).

* A captured loop and the same number of eager steps, from the same
  weights and batches, end bitwise equal (cuDNN deterministic): the small
  ResNet through the four BN kernels and a small transformer through the
  three flash-attention kernels (bf16).
* The split BN launch at one rank (sums, then the finish) equals the single
  launch bitwise; the sums of two halves, added, finish within the kernel
  check's tolerance of the single launch on the whole.
* The kernel wrappers count the launches they make (the warm-up steps'
  and the capture's, none for a replay), and a ``torch.profiler`` trace of
  a window of replays finds every kernel of the step on the card; a capture
  that fails raises.
"""

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.models import resnet, transformer
from tensorflowonspark_tpu_torch.ops import flash_attention, fused_bn
from tensorflowonspark_tpu_torch.ops.kernel_trace import KernelTrace
from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

RESNET = dict(stage_sizes=(1, 1), filters=(16, 32), num_classes=10, bottleneck=True, stem="imagenet")
LM = dict(vocab_size=300, d_model=128, n_layers=2, n_heads=2, d_ff=256, max_seq_len=256)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and triton): run on the card")


@pytest.fixture
def deterministic():
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _resnet_parts(steps, seed=0):
    """``(strategy, optimizer, state, loss_fn, batches, compile kwargs)``."""
    strategy = SyncDataParallel("cuda")
    optimizer = optim.sgd(optim.linear_schedule(0.0, 0.1, 3), momentum=0.9)
    state = strategy.create_state(lambda: resnet.ResNet(
        dtype=torch.bfloat16, bn_impl="pallas", generator=torch.Generator().manual_seed(0), **RESNET),
        optimizer)
    loss_fn = resnet.make_loss_fn(weight_decay=1e-4)
    rng = np.random.default_rng(seed)
    batches = [strategy.shard_batch({"image": rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
                                     "label": rng.integers(0, 10, 8)}) for _ in range(steps)]
    return strategy, optimizer, state, loss_fn, batches, {"mutable": True}


def _lm_parts(steps):
    """``(strategy, optimizer, state, loss_fn, batches, compile kwargs)``."""
    strategy = SyncDataParallel("cuda")
    model = transformer.create_model(dtype="bfloat16", **LM)
    optimizer = optim.adamw(3e-4)
    state = strategy.create_state(transformer.make_init_fn(model), optimizer, torch.Generator().manual_seed(0))
    loss_fn = transformer.make_loss_fn(model)
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(steps):
        tokens = rng.integers(1, LM["vocab_size"], (2, 201)).astype(np.int32)
        seg = np.repeat(np.array([[1] * 120 + [2] * 81]), 2, 0).astype(np.int32)
        pos = np.repeat(np.concatenate([np.arange(120), np.arange(81)])[None], 2, 0).astype(np.int32)
        batches.append(strategy.shard_batch({"tokens": tokens, "segment_ids": seg, "positions": pos}))
    return strategy, optimizer, state, loss_fn, batches, {"has_aux": True}


def _run(parts, use_loop):
    """Train on every batch of ``parts`` (:func:`_resnet_parts`,
    :func:`_lm_parts`): eager steps, or loop calls of ``use_loop`` steps.
    ``(state, the loss of every call)``."""
    strategy, optimizer, state, loss_fn, batches, kw = parts
    losses = []
    if use_loop:
        loop = strategy.compile_train_loop(loss_fn, optimizer, use_loop, **kw)
        for i in range(0, len(batches), use_loop):
            state, metrics = loop(state, batches[i:i + use_loop])
            losses.append(metrics["loss"])
    else:
        step = strategy.compile_train_step(loss_fn, optimizer, **kw)
        for batch in batches:
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
    torch.cuda.synchronize()
    return state, losses


def _assert_bitwise(a, b):
    for name, value in dict(a.params, **a.model_state).items():
        assert torch.equal(value, dict(b.params, **b.model_state)[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["resnet", "transformer"])
def test_captured_loop_equals_eager_steps_bitwise(model, deterministic):
    """Two windows of 4 (2 warm-up steps, the capture, 5 replays) against 8
    eager steps, and two eager runs against each other first: every
    parameter, BN statistic and window-end loss bitwise equal."""
    _card()
    parts = _resnet_parts if model == "resnet" else _lm_parts
    eager_a, losses_a = _run(parts(8), None)
    eager_b, _ = _run(parts(8), None)
    _assert_bitwise(eager_a, eager_b)
    looped, losses = _run(parts(8), 4)
    _assert_bitwise(eager_a, looped)
    assert looped.step == 8 and int(looped.opt_state["count"]) == 8
    assert torch.equal(losses[0], losses_a[3]) and torch.equal(losses[1], losses_a[7])


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["resnet", "transformer"])
def test_wrappers_count_their_launches_and_a_trace_counts_the_replays(model, deterministic):
    """One eager step gives each kernel wrapper's count a step. A first
    window of 5 (2 warm-up steps, the capture, 3 replays) counts 3 steps'
    launches: the warm-ups' and the capture's. A second window, all
    replays, calls no wrapper; its trace finds 5 steps' launches of each
    kernel on the card, in 5 graph launches."""
    _card()
    ops = fused_bn if model == "resnet" else flash_attention
    strategy, optimizer, state, loss_fn, batches, kw = (_resnet_parts if model == "resnet" else _lm_parts)(11)
    step = strategy.compile_train_step(loss_fn, optimizer, **kw)
    ops.reset_launch_counts()
    state, _ = step(state, batches[0])
    per_step = ops.launch_counts()
    assert all(n > 0 for n in per_step.values()), per_step
    loop = strategy.compile_train_loop(loss_fn, optimizer, 5, **kw)
    ops.reset_launch_counts()
    state, _ = loop(state, batches[1:6])
    assert ops.launch_counts() == {k: 3 * n for k, n in per_step.items()}
    with KernelTrace() as trace:
        state, _ = loop(state, batches[6:11])
    assert ops.launch_counts() == {k: 3 * n for k, n in per_step.items()}
    assert {k: trace.readings["launches"][k] for k in per_step} == {k: 5 * n for k, n in per_step.items()}
    assert trace.readings["graph_launches"] == 5 and state.step == 11
    assert fused_bn.bn_finish.launches == 0  # one rank: single launches


#: [R, C] bf16 shapes of both load paths: the stem, a stage-3 layer, odd C
SPLIT_SHAPES = [(802816, 64), (12544, 1024), (3136, 2048), (3143, 37), (175, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_ch", SPLIT_SHAPES)
def test_split_launch_at_one_rank_equals_the_single_launch_bitwise(rows, n_ch):
    """bn_stats and bn_bwd_reduce split (f64 sums, then bn_finish) against
    their single launches: bitwise at one rank. The batch split in two
    halves, their sums added and finished over all rows: within 1e-4 of
    the single launch on the whole (relative to the largest value, floor
    1), the kernel check's tolerance for f32 sums."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = (torch.randn(rows, n_ch, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
    dy = torch.randn(rows, n_ch, device="cuda", generator=gen).to(torch.bfloat16)
    mean, var = fused_bn.bn_stats(x)
    single_bwd = fused_bn.bn_bwd_reduce(x, dy, mean, var, 1e-5)
    split = fused_bn.bn_finish(fused_bn.bn_stats_sums(x), rows, True)
    split_bwd = fused_bn.bn_finish(fused_bn.bn_bwd_reduce_sums(x, dy, mean, var, 1e-5), rows, False)
    for got, want in zip(split + split_bwd, (mean, var) + single_bwd):
        assert torch.equal(got, want)
    # the finish kernel against its plain version on the same f64 sums
    for sums, stats in ((fused_bn.bn_stats_sums(x), True),
                        (fused_bn.bn_bwd_reduce_sums(x, dy, mean, var, 1e-5), False)):
        for g, w in zip(fused_bn.bn_finish(sums, rows, stats), fused_bn.bn_finish_plain(sums, rows, stats)):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * max(1.0, float(w.abs().max())))
    if rows < 2:
        return
    h = rows // 2
    halves = fused_bn.bn_stats_sums(x[:h]) + fused_bn.bn_stats_sums(x[h:])
    halves_bwd = (fused_bn.bn_bwd_reduce_sums(x[:h], dy[:h], mean, var, 1e-5)
                  + fused_bn.bn_bwd_reduce_sums(x[h:], dy[h:], mean, var, 1e-5))
    got = fused_bn.bn_finish(halves, rows, True) + fused_bn.bn_finish(halves_bwd, rows, False)
    for g, w in zip(got, (mean, var) + single_bwd):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * max(1.0, float(w.abs().max())))


#: a loop whose loss reads a value back to the host: ``python -c FAILED_CAPTURE``
FAILED_CAPTURE = r"""
import numpy as np
import torch

from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

strategy = SyncDataParallel("cuda")
optimizer = optim.sgd(0.1)
state = strategy.create_state(lambda: torch.nn.Linear(4, 1), optimizer)


def loss_fn(module, batch):
    loss = module(batch["x"]).square().mean()
    if float(loss.detach()) < 0:  # a host sync: legal eagerly, not under capture
        raise AssertionError("a square is never negative")
    return loss


loop = strategy.compile_train_loop(loss_fn, optimizer, 3)
batch = strategy.shard_batch({"x": np.ones((2, 4), np.float32)})
try:
    loop(state, [batch] * 3)
except RuntimeError as e:
    print("RAISED after", state.step, "steps:", type(e).__name__)  # a RuntimeError subclass
else:
    print("NO ERROR after", state.step, "steps")
"""


@pytest.mark.cuda
def test_a_failed_capture_raises():
    """A loss that reads a value back to the host cannot be captured: the
    loop raises on the card after its two warm-up steps rather than run the
    third step eagerly. (In a process of its own: a failed capture leaves
    PyTorch's default CUDA generator in its capture state.)"""
    _card()
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", FAILED_CAPTURE], cwd=repo, env=env, capture_output=True,
                         text=True, timeout=300)
    assert "RAISED after 2 steps" in out.stdout, out.stdout + out.stderr[-3000:]
