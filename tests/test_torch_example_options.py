"""The examples' options that the image-plane slice lifted, run in
process on the CPU through each ``main_fun`` with a one-process node
context: ``resnet_spark``'s ``--data_dir``, ``--eval_dir`` and
``--profile_steps`` on TFRecord shards (and the loud failure of a worker
with no shard), and the LM example's forked pack workers and packed-slab
cache, which must train on the thread packer's stream."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import tfrecord
from tensorflowonspark_tpu_torch.data import cifar
from tensorflowonspark_tpu_torch.examples.resnet import resnet_spark
from tensorflowonspark_tpu_torch.examples.transformer import transformer_spark

TINY_LM = ["--platform", "cpu", "--vocab_size", "300", "--d_model", "32", "--n_layers", "1",
           "--n_heads", "2", "--d_ff", "64", "--seq_len", "64", "--batch_size", "2",
           "--dtype", "float32", "--train_steps", "3", "--log_steps", "1"]


def _local_ctx():
    """The node context a ``main_fun`` reads, for one CPU process."""
    return SimpleNamespace(executor_id=0, num_workers=1, process_id=0, num_processes=1, job_name="chief",
                           task_index=0, device=torch.device("cpu"), initialize_distributed=lambda: None)


def _printed_losses(text):
    return [float(line.split("loss ")[1].split()[0]) for line in text.splitlines()
            if line.startswith("step ") and "loss " in line]


def _cifar_shards(root, name, n):
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, name))
    with tfrecord.TFRecordWriter(os.path.join(root, name, "part-00000")) as w:
        for i in range(n):
            w.write(cifar.encode_example(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8), i % 10))
    return os.path.join(root, name)


@pytest.mark.parametrize("flag", ["--data_dir", "--eval_dir", "--profile_steps"])
def test_real_data_options_run(flag, tmp_path, capsys, monkeypatch):
    """``--data_dir`` trains from TFRecord shards (ResNet-56 on CIFAR
    records), ``--eval_dir`` scores every eval record after training, and
    ``--profile_steps`` writes a torch.profiler trace into the model dir."""
    monkeypatch.delenv("TOS_DECODE_WORKERS", raising=False)
    argv = ["--platform", "cpu", "--dataset", "cifar", "--batch_size", "2", "--train_steps", "1",
            "--log_steps", "1", "--data_threads", "2", "--data_dir", _cifar_shards(tmp_path, "train", 8)]
    if flag == "--eval_dir":
        argv += ["--eval_dir", _cifar_shards(tmp_path, "eval", 3)]
    if flag == "--profile_steps":
        argv += ["--profile_steps", "0,1", "--model_dir", str(tmp_path / "model")]
    resnet_spark.main_fun(resnet_spark.build_parser().parse_args(argv), _local_ctx())
    out = capsys.readouterr().out
    losses = _printed_losses(out)
    assert len(losses) == 1 and np.isfinite(losses).all()
    if flag == "--eval_dir":
        assert "(3 examples)" in out
    if flag == "--profile_steps":
        assert os.path.getsize(tmp_path / "model" / "profile" / "trace.json") > 0


def test_a_worker_without_shards_fails_at_once(tmp_path):
    """More workers than shard files: the worker with none raises before
    touching the device (it would hang a distributed world at step 1)."""
    args = resnet_spark.build_parser().parse_args(
        ["--platform", "cpu", "--dataset", "cifar", "--data_dir", _cifar_shards(tmp_path, "train", 1)])
    ctx = _local_ctx()
    ctx.num_workers, ctx.executor_id = 2, 1
    with pytest.raises(RuntimeError, match="got 0 of 1 shard files"):
        resnet_spark.main_fun(args, ctx)


@pytest.mark.parametrize("flag", [["--pack_workers", "2"], ["--slab_cache_dir", "cache"]],
                         ids=["pack_workers", "slab_cache_dir"])
def test_lm_pack_workers_and_slab_cache_dir_run(flag, tmp_path, capsys, monkeypatch):
    """The LM example's forked pack workers and packed-slab cache train on
    the thread packer's stream: the same losses, step for step."""
    monkeypatch.chdir(tmp_path)  # a relative cache dir lands here
    data_dir = str(tmp_path / "corpus")
    transformer_spark.make_text_corpus(data_dir, num_shards=2, records_per_shard=40)
    runs = []
    for extra in ([], flag):
        args = transformer_spark.build_parser().parse_args(TINY_LM + ["--data_dir", data_dir] + extra)
        transformer_spark.main_fun(args, _local_ctx())
        runs.append(_printed_losses(capsys.readouterr().out))
    assert len(runs[0]) == 3 and runs[1] == runs[0]
