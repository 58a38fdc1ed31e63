"""Where the time of one transformer LM train step goes on the card.

Builds the model, loss, AdamW and train step as ``transformer_spark.main_fun``
does (the full-width ``TransformerConfig``: vocab 32000, d_model 512, 6
layers, 8 heads, d_ff 2048; bf16; seq 2048, batch 8; the step from
``SyncDataParallel.compile_train_step``) in this process on ``cuda:0``, on
one packed batch of the example's synthetic corpus (byte tokens), warms up,
then:

* times ``--steps`` steps with a device sync after each (host clock) →
  step time and tokens/s;
* traces ``--traced`` more steps with ``torch.profiler`` and reads from
  that one trace the kernels' device time by group (the port's flash-
  attention CUDA kernels, GEMMs, other PyTorch kernels), the device's busy
  time and idle share of the window, and the ``train_step.forward`` /
  ``.backward`` / ``.optimizer`` ranges (as the ResNet profiler does).

Prints one JSON line per ``--attention`` given (``flash``: the kernels;
``plain``: dense attention in f32)::

    python -m tensorflowonspark_tpu_torch.examples.transformer.profile_step \\
        --attention flash plain
"""

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

from tensorflowonspark_tpu_torch.examples.resnet.profile_step import read_trace

#: kernel-name fragments of each group, matched in this order
GROUPS = [
    ("flash_attention_cuda", ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")),
    ("gemm", ("gemm", "cublas", "cutlass", "xmma", "nvjet")),
]
LM = dict(vocab_size=32000, d_model=512, n_layers=6, n_heads=8, d_ff=2048)


def packed_batch(seq_len, batch_size, data_dir):
    """The first packed ``[batch_size, seq_len + 1]`` batch of the example's
    corpus, as the trainer of a one-executor run draws it."""
    from tensorflowonspark_tpu_torch import tfrecord
    from tensorflowonspark_tpu_torch.data import TextPipeline, Tokenizer
    from tensorflowonspark_tpu_torch.examples.transformer import transformer_spark

    transformer_spark.make_text_corpus(data_dir)
    stream = iter(TextPipeline(tfrecord.list_shards(data_dir), Tokenizer(kind="byte"),
                               seq_len=seq_len + 1, batch_size=batch_size, seed=0, epochs=None,
                               pack_workers=0))
    batch = next(stream)
    stream.close()
    return batch


def profile(attention, host_batch, steps, traced):
    import torch

    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

    torch.cuda.reset_peak_memory_stats()
    strategy = SyncDataParallel(torch.device("cuda", 0))
    model = transformer.create_model(dtype="bfloat16", attention=attention, **LM)
    optimizer = optim.adamw(3e-4)
    state = strategy.create_state(transformer.make_init_fn(model), optimizer,
                                  torch.Generator().manual_seed(0))
    step = strategy.compile_train_step(transformer.make_loss_fn(model), optimizer, has_aux=True)
    batch = strategy.shard_batch(host_batch)
    tokens = batch["tokens"].shape[0] * (batch["tokens"].shape[1] - 1)

    for _ in range(3):  # warm-up: kernel build, cuBLAS heuristics, allocator
        state, _ = step(state, batch)
    torch.cuda.synchronize()

    wall = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("profile_window"):
            for _ in range(traced):
                state, metrics = step(state, batch)
            torch.cuda.synchronize()
    out = {
        "attention": attention, "config": dict(LM, seq_len=tokens // batch["tokens"].shape[0]),
        "batch": batch["tokens"].shape[0], "dtype": "bfloat16", "steps_timed": steps,
        "step_ms_median": statistics.median(wall) * 1e3,
        "tokens_per_sec": tokens / statistics.median(wall),
        "loss": float(metrics["loss"]),
    }
    out.update(read_trace(prof.events(), traced, GROUPS))
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def main(argv=None):
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--attention", nargs="+", choices=["flash", "plain"], default=["flash"])
    parser.add_argument("--seq_len", type=int, default=2048)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--traced", type=int, default=3)
    parser.add_argument("--data_dir", default=os.path.join(tempfile.gettempdir(), "tos_transformer_corpus"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    host_batch = packed_batch(args.seq_len, args.batch_size, args.data_dir)
    for attention in args.attention:
        out = profile(attention, host_batch, args.steps, args.traced)
        out["card"] = card
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
