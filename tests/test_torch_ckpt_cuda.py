"""Checkpoints of a train loop captured in a CUDA graph, on a CUDA device.
Marked ``cuda``: each test skips without a card. This file imports neither
jax nor the JAX package (``python -m pytest --noconftest -m cuda
tests/test_torch_ckpt_cuda.py`` on a card host with only PyTorch).

* A snapshot taken right after a captured loop call, followed at once by
  another call that updates the state in place, commits the state of the
  first call bitwise: the device-to-host copies are queued on the stream
  the next replay runs on, and the writer waits for them.
* A restore into a live state whose loop is already captured, then one
  more call, equals the eager continuation from the same checkpoint: the
  restore copies into the tensors the graph points at.
"""

import os

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import ckpt
from tensorflowonspark_tpu_torch.models import resnet
from tensorflowonspark_tpu_torch.train import SyncDataParallel, checkpoint, optim

RESNET = dict(stage_sizes=(1, 1), filters=(16, 32), num_classes=10, bottleneck=True, stem="imagenet")
K = 3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and triton): run on the card")


@pytest.fixture
def deterministic():
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _parts(calls, seed=0):
    """``(strategy, optimizer, state, loss_fn, windows of K batches)``."""
    strategy = SyncDataParallel("cuda")
    optimizer = optim.sgd(optim.linear_schedule(0.05, 0.1, 10), momentum=0.9)
    state = strategy.create_state(lambda: resnet.ResNet(
        dtype=torch.bfloat16, bn_impl="pallas", generator=torch.Generator().manual_seed(seed), **RESNET),
        optimizer)
    rng = np.random.default_rng(7)
    windows = [[strategy.shard_batch({"image": rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
                                      "label": rng.integers(0, 10, 8)}) for _ in range(K)]
               for _ in range(calls)]
    return strategy, optimizer, state, resnet.make_loss_fn(weight_decay=1e-4), windows


def _host(state):
    """A blocking copy of every tensor of the state, by name."""
    torch.cuda.synchronize()
    out = {"module/" + k: v.detach().cpu().clone() for k, v in dict(state.params, **state.model_state).items()}
    out.update(("trace/" + k, v.cpu().clone()) for k, v in state.opt_state["trace"].items())
    out["count"] = state.opt_state["count"].cpu().clone()
    return out


def _saved(tree):
    out = {"module/" + k: v for k, v in dict(tree["params"], **tree["model_state"]).items()}
    out.update(("trace/" + k, v) for k, v in tree["opt_state"]["trace"].items())
    out["count"] = tree["opt_state"]["count"]
    return out


@pytest.mark.cuda
def test_a_snapshot_after_a_captured_call_commits_that_calls_state(tmp_path, deterministic):
    """The snapshot is queued while call 2's replays may still run, and call
    3 is queued right behind it with no sync between; the commit equals a
    blocking copy of a deterministic twin's state after its call 2."""
    _card()
    strategy, optimizer, twin, loss_fn, windows = _parts(4)
    twin_loop = strategy.compile_train_loop(loss_fn, optimizer, K, mutable=True)
    for window in windows[:2]:
        twin, _ = twin_loop(twin, window)
    want = _host(twin)
    del twin, twin_loop

    _, _, state, _, _ = _parts(0)
    loop = strategy.compile_train_loop(loss_fn, optimizer, K, mutable=True)
    state, _ = loop(state, windows[0])  # warm-up steps and the capture
    state, _ = loop(state, windows[1])  # replays
    with ckpt.AsyncCheckpointEngine(str(tmp_path)) as engine:
        engine.save(state, state.step)
        snap_step = state.step
        state, _ = loop(state, windows[2])  # queued at once, updates in place
        state, _ = loop(state, windows[3])
        assert engine.drain(timeout=120)
    assert engine.error is None
    tree = checkpoint.restore_checkpoint(os.path.join(str(tmp_path), "ckpt_{}".format(snap_step)))
    assert tree["step"] == snap_step == 2 * K
    got = _saved(tree)
    assert got.keys() == want.keys()
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    assert int(_host(state)["count"]) == 4 * K  # the state did move on


@pytest.mark.cuda
def test_a_restore_into_a_captured_loop_trains_the_restored_state(tmp_path, deterministic):
    _card()
    strategy, optimizer, state, loss_fn, windows = _parts(3)
    loop = strategy.compile_train_loop(loss_fn, optimizer, K, mutable=True)
    state, _ = loop(state, windows[0])
    path = checkpoint.save_checkpoint(str(tmp_path / "ckpt_{}".format(state.step)), state)
    state, _ = loop(state, windows[1])  # the graph's tensors move past the checkpoint
    first = next(state.module.parameters())
    checkpoint.restore_checkpoint(path, target=state)
    assert state.step == K and next(state.module.parameters()) is first
    state, metrics = loop(state, windows[2])  # a replay of the graph built before the restore

    # the eager continuation from the same checkpoint, in a state of other weights
    _, _, other, _, _ = _parts(0, seed=1)
    checkpoint.restore_checkpoint(path, target=other)
    step = strategy.compile_train_step(loss_fn, optimizer, mutable=True)
    for batch in windows[2]:
        other, eager_metrics = step(other, batch)
    assert other.step == state.step == 2 * K
    assert torch.equal(metrics["loss"], eager_metrics["loss"])
    got, want = _host(state), _host(other)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
