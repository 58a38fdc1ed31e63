"""Times the BatchNorm reductions (``bn_stats``, ``bn_bwd_reduce``) on the card.

At every BatchNorm shape of a ResNet-50 step (batch 64, 224 px, bf16; 53
layers, 12 distinct shapes), per wrapper: the median device time of a call
with the 50 MB L2 flushed before each and a device spin queued after the
flush (so the host's enqueue never shows in the time), one PyTorch library
call computing the same function (``torch.var_mean``; the dγ/dβ half of
``native_batch_norm_backward``) as the yardstick, the byte bound (3.35 TB/s)
and the outputs' agreement with the plain versions; then the same summed
over the step's 53 layers. Each time is read after two flushes: ``write``
(``chip_smoke.py``'s: 256 MB written, which leaves up to 50 MB of dirty
lines that the timed call's reads must write back) and ``clean`` (256 MB
read, so the L2 holds clean lines of other data). Last, each wrapper's host
time per call: a host clock over many calls queued while the card is kept
busy.

``--baseline MODULE`` also loads another copy of ``ops/fused_bn.py`` (the
same wrappers, e.g. an earlier commit's, copied under ``build/``), with
``--baseline_source`` its own ``csrc/fused_bn.cu`` (default: this
checkout's), and times its wrappers in turns with the current ones
(baseline, current, current, baseline, per round), so that both are read on
one card in one process; at every shape it also holds the two copies'
outputs against each other bitwise (``bitwise_equal_baseline``), and exits
non-zero after its last line if any differ::

    python -m tensorflowonspark_tpu_torch.examples.resnet.bench_bn \\
        --baseline build/parent_bn/fused_bn.py --baseline_source build/parent_bn/fused_bn.cu

Prints one JSON line per shape, one for the step, one for the host times,
then the card's name and power limit. Needs a CUDA device.
"""

import argparse
import importlib.util
import json
import statistics
import subprocess
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
#: a device spin queued before each timed call (cycles; about 0.2 ms)
SPIN_CYCLES = 400_000
#: bytes per activation element each wrapper reads: x (stats); x, dy (reduce)
READS = {"bn_stats": 1, "bn_bwd_reduce": 2}
#: the step timed: ResNet-50 at batch 64, 224 px
BATCH, IMAGE = 64, 224
#: calls a host-time reading averages over
HOST_CALLS = 200


def bn_shapes(torch, batch, image):
    """Input shapes (N, H, W, C) of the 53 BatchNorm layers of ResNet-50 at
    ``batch`` x ``image`` px, read with hooks from an eval-mode forward on
    the card (no BN kernel runs in eval mode)."""
    from tensorflowonspark_tpu_torch.models import resnet
    from tensorflowonspark_tpu_torch.ops import fused_bn

    model = resnet.resnet50(dtype=torch.bfloat16, bn_impl="pallas").cuda().eval()
    shapes = []
    hooks = [
        m.register_forward_pre_hook(lambda _m, inp: shapes.append(tuple(inp[0].shape)))
        for m in model.modules() if isinstance(m, fused_bn.FusedBatchNorm)
    ]
    with torch.no_grad():
        model(torch.zeros(batch, image, image, 3, device="cuda"))
    for h in hooks:
        h.remove()
    del model
    return shapes


FLUSHES = ("write", "clean")


def time_ms(torch, fn, flush, iters=7, kind="write"):
    """Median device time of one call of ``fn`` over ``iters`` calls: the
    L2 flushed (by writing or by reading ``flush``, see ``FLUSHES``), then
    a device spin, before each (``chip_smoke.py`` times every kernel of its
    table with it)."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if kind == "write":
            flush.zero_()
        else:
            flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def host_us(torch, fn, calls):
    """Host microseconds per call of ``fn``, over ``calls`` calls queued
    behind a device spin long enough that the card never waits on them."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES * 100)  # about 20 ms
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def load_module(path):
    """Another copy of ``ops/fused_bn.py`` loaded from ``path``."""
    spec = importlib.util.spec_from_file_location("fused_bn_baseline", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def max_rel_err(got, want):
    """Largest |got - ref| over the outputs, of the largest |ref| (floor 1)."""
    return max(float((g - r).abs().max()) / max(1.0, float(r.abs().max())) for g, r in zip(got, want))


def main(argv=None):
    import torch

    from tensorflowonspark_tpu_torch.ops import fused_bn

    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", default=None, help="another ops/fused_bn.py to time in turns")
    parser.add_argument("--baseline_source", default=None,
                        help="the csrc/fused_bn.cu of --baseline (default: this checkout's)")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--iters", type=int, default=7)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_bn: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    impls = {"current": fused_bn}
    if args.baseline:
        impls["baseline"] = load_module(args.baseline)
        if args.baseline_source:
            impls["baseline"]._lib = impls["baseline"].bind(impls["baseline"].build(args.baseline_source))
    order = ["baseline", "current", "current", "baseline"] if args.baseline else ["current"]

    counts = {}
    for s in bn_shapes(torch, BATCH, IMAGE):
        counts[s] = counts.get(s, 0) + 1
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    gen = torch.Generator(device="cuda").manual_seed(0)
    eps = 1e-5
    step = {kind: {name: {impl: 0.0 for impl in impls} for name in READS} for kind in FLUSHES}
    for kind in FLUSHES:
        step[kind].update({"library_stats": 0.0, "library_bwd_reduce": 0.0})
    step.update({"bound_stats": 0.0, "bound_bwd_reduce": 0.0})
    host, differ = {}, []
    for shape, n_layers in sorted(counts.items()):
        n, h, w, c = shape
        rows = n * h * w
        x = (torch.randn(rows, c, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
        dy = torch.randn(rows, c, device="cuda", generator=gen).to(torch.bfloat16)
        x4, dy4 = (t.view(shape).permute(0, 3, 1, 2) for t in (x, dy))
        mean, var = fused_bn.bn_stats_plain(x)
        invstd = torch.rsqrt(var + eps)
        gamma = torch.ones(c, device="cuda")
        calls = {
            "bn_stats": {impl: (lambda m=m: m.bn_stats(x)) for impl, m in impls.items()},
            "bn_bwd_reduce": {impl: (lambda m=m: m.bn_bwd_reduce(x, dy, mean, var, eps))
                              for impl, m in impls.items()},
        }
        library = {
            "library_stats": lambda: torch.var_mean(x, dim=0, correction=0),
            "library_bwd_reduce": lambda: torch.ops.aten.native_batch_norm_backward(
                dy4, x4, gamma, None, None, mean, invstd, True, eps, [False, True, True]),
        }
        want = {"bn_stats": (mean, var),
                "bn_bwd_reduce": fused_bn.bn_bwd_reduce_plain(x, dy, mean, var, eps)}
        times = {kind: {name: {impl: [] for impl in impls} for name in calls} for kind in FLUSHES}
        lib_times = {kind: {name: [] for name in library} for kind in FLUSHES}
        for _ in range(args.rounds):
            for kind in FLUSHES:
                for name, fn in library.items():
                    lib_times[kind][name].append(time_ms(torch, fn, flush, args.iters, kind))
                for name in calls:
                    for impl in order:
                        times[kind][name][impl].append(
                            time_ms(torch, calls[name][impl], flush, args.iters, kind))
        line = {"shape": [rows, c], "nhwc": list(shape), "layers": n_layers, "dtype": "bfloat16"}
        if args.baseline:
            line["bitwise_equal_baseline"] = {
                name: all(torch.equal(a, b) for a, b in zip(calls[name]["current"](),
                                                            calls[name]["baseline"]()))
                for name in calls}
            differ.extend("{} at {}".format(name, [rows, c])
                          for name, same in line["bitwise_equal_baseline"].items() if not same)
        for name in calls:
            g = fused_bn.reduce_geometry(rows, c, 2, READS[name], fused_bn._vector_path(x, dy),
                                         fused_bn._workspace(x, fused_bn._stream(x)).n_sms)
            bound_ms = READS[name] * rows * c * x.element_size() / HBM_BYTES_PER_S * 1e3
            key = name[len("bn_"):]
            line[name] = {"bound_ms": bound_ms, "strips": g.strips, "splits": g.splits,
                          "rows_per_split": g.rows_per_split,
                          "max_rel_err": {impl: max_rel_err(calls[name][impl](), want[name])
                                          for impl in impls}}
            step["bound_" + key] += n_layers * bound_ms
            for kind in FLUSHES:
                line[name][kind] = {impl: {"ms": statistics.median(times[kind][name][impl]),
                                           "ms_each": times[kind][name][impl]} for impl in impls}
                line[name][kind]["library_ms"] = statistics.median(lib_times[kind]["library_" + key])
                for impl in impls:
                    step[kind][name][impl] += n_layers * line[name][kind][impl]["ms"]
                step[kind]["library_" + key] += n_layers * line[name][kind]["library_ms"]
        print(json.dumps(line), flush=True)
        if shape == (BATCH, 14, 14, 256):  # a stage-3 layer: host cost per call
            for name in calls:
                host[name] = {impl: host_us(torch, calls[name][impl], HOST_CALLS) for impl in impls}
        del x, dy, x4, dy4, calls, library, want
        torch.cuda.empty_cache()
    print(json.dumps({"per": "ResNet-50 step, batch {}, {} px, bf16: sum over its {} BatchNorm layers"
                      .format(BATCH, IMAGE, sum(counts.values())), "ms": step,
                      "card": card}), flush=True)
    print(json.dumps({"host_us_per_call": host, "at": [BATCH * 14 * 14, 256],
                      "calls": HOST_CALLS, "card": card}), flush=True)
    print(card, flush=True)
    if differ:
        raise SystemExit("bench_bn: outputs differ from the baseline's: {}".format(", ".join(differ)))


if __name__ == "__main__":
    main()
