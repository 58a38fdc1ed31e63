"""Times the bf16 flash-attention kernels (forward, dq, dk/dv) on the card.

At the LM slice's shape (``[B·H = 64, L = 2048, D = 64]`` bf16, causal), on
two lines: with the segment ids of the example's first packed batch (the
main path's attention), and without ids (pure causal). Per line and kernel:
the median device time of a launch with the 50 MB L2 flushed before each,
``scaled_dot_product_attention``'s forward and whole backward (dq + dk + dv;
boolean causal+segment mask, or ``is_causal=True``) as the yardsticks, the
blocks the kernels visit (``visited_blocks``) and the outputs' agreement
with the plain versions.

``--baseline SOURCE`` also builds another copy of ``flash_attention.cu``
(the same C interface, e.g. an earlier commit's, unpacked under ``build/``)
into ``build/cuda_baseline`` and times its kernels in turns with the
current ones (baseline, current, current, baseline, per round), so that
both are read on one card in one process::

    python -m tensorflowonspark_tpu_torch.examples.transformer.bench_flash \\
        --baseline build/parent/flash_attention.cu

Prints one JSON line per line of work, then the card's name and power
limit. Needs a CUDA device.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import tempfile

HEADS, D, SEQ, BATCH = 8, 64, 2048, 8


def time_ms(torch, fn, flush, iters):
    """Median device time of one call of ``fn``, the L2 flushed before each."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def launchers(torch, fa, lib):
    """The forward, dq and dk/dv through the C interface of ``lib`` (the
    wrappers' calls, without their launch counts)."""
    def stream(t):
        return torch.cuda.current_stream(t.device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    def fwd(q, k, v, seg, scale, causal, heads):
        o = torch.empty_like(q)
        bh, length, d = q.shape
        lse = torch.empty((bh, length), device=q.device, dtype=torch.float32)
        fa._raise_on(lib.tos_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(seg), o.data_ptr(), lse.data_ptr(), bh, heads,
            length, d, 1, float(scale), int(causal), stream(q)), "flash_fwd")
        return o, lse

    def dq(q, k, v, seg, do, lse, delta, scale, causal, heads):
        out = torch.empty_like(q)
        bh, length, d = q.shape
        fa._raise_on(lib.tos_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(seg), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), out.data_ptr(), bh, heads, length, d, 1, float(scale), int(causal),
            stream(q)), "flash_bwd_dq")
        return out

    def dkv(q, k, v, seg, do, lse, delta, scale, causal, heads):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        bh, length, d = q.shape
        fa._raise_on(lib.tos_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(seg), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, heads, length, d, 1, float(scale),
            int(causal), stream(q)), "flash_bwd_dkv")
        return dk, dv

    return {"flash_fwd": fwd, "flash_bwd_dq": dq, "flash_bwd_dkv": dkv}


def agreement(torch, got, want):
    """Largest elementwise ``|got - ref| / (|ref| + rms(ref))`` and norm
    ``||got - ref|| / ||ref||`` over the outputs (the card tests' readings)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    elem = norm = 0.0
    for g, r in zip(got, want):
        g, r = g.float(), r.float()
        rms = r.square().mean().sqrt()
        elem = max(elem, float(((g - r).abs() / (r.abs() + rms)).max()))
        norm = max(norm, float((g - r).norm() / r.norm()))
    return {"elem": elem, "norm": norm}


def main(argv=None):
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from tensorflowonspark_tpu_torch.examples.transformer.profile_step import packed_batch
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", default=None, help="another flash_attention.cu to time in turns")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--iters", type=int, default=7)
    parser.add_argument("--data_dir", default=os.path.join(tempfile.gettempdir(), "tos_transformer_corpus"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    impls = {"current": launchers(torch, fa, fa.bind(fa.build()))}
    if args.baseline:
        path = fa.build(os.path.abspath(args.baseline), os.path.join(os.path.dirname(fa.BUILD_DIR),
                                                                      "cuda_baseline"))
        impls["baseline"] = launchers(torch, fa, fa.bind(path))
    order = ["baseline", "current", "current", "baseline"] if args.baseline else ["current"]

    seg_all = torch.as_tensor(packed_batch(SEQ, BATCH, args.data_dir)["segment_ids"][:, :-1])
    seg_all = seg_all.to(torch.int32).contiguous().cuda()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    gen = torch.Generator(device="cuda").manual_seed(1)
    shape = (BATCH * HEADS, SEQ, D)
    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(4))
    q4, k4, v4, do4 = (t.view(BATCH, HEADS, SEQ, D) for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(D)
    pos = torch.arange(SEQ, device="cuda")
    for line, seg in (("segments", seg_all), ("causal", None)):
        o_ref, lse = fa.flash_fwd_plain(q, k, v, seg, scale, True, HEADS)
        delta = (do.float() * o_ref.float()).sum(-1)
        inputs = {"flash_fwd": (seg, scale, True, HEADS),
                  "flash_bwd_dq": (seg, do, lse, delta, scale, True, HEADS)}
        inputs["flash_bwd_dkv"] = inputs["flash_bwd_dq"]
        qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
        if seg is None:
            sdpa = dict(is_causal=True)
            backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]
            library = "sdpa, is_causal=True"
        else:
            sdpa = dict(attn_mask=((pos[:, None] >= pos[None, :])[None]
                                   & (seg[:, :, None] == seg[:, None, :]))[:, None])
            backends = [SDPBackend.EFFICIENT_ATTENTION]
            library = "sdpa, memory-efficient, boolean causal+segment mask"
        with sdpa_kernel(backends):
            out = F.scaled_dot_product_attention(qg, kg, vg, **sdpa)

        def library_fwd():
            with sdpa_kernel(backends):
                return F.scaled_dot_product_attention(q4, k4, v4, **sdpa)

        def library_bwd():
            return torch.autograd.grad(out, (qg, kg, vg), do4, retain_graph=True)

        visit = fa.visited_blocks(seg.cpu() if seg is not None else torch.zeros(BATCH, SEQ, dtype=torch.int32),
                                  True)
        n = visit.shape[-1]
        result = {"line": line, "shape": list(shape), "dtype": "bfloat16", "causal": True,
                  "blocks_visited": int(visit.sum()), "blocks_causal": BATCH * n * (n + 1) // 2,
                  "library": library, "card": card}
        want = {"flash_fwd": (o_ref, lse),
                "flash_bwd_dq": fa.flash_bwd_dq_plain(q, k, v, *inputs["flash_bwd_dq"]),
                "flash_bwd_dkv": fa.flash_bwd_dkv_plain(q, k, v, *inputs["flash_bwd_dkv"])}
        times = {name: {impl: [] for impl in impls} for name in want}
        lib_ms = {"forward": [], "backward": []}
        for _ in range(args.rounds):
            lib_ms["forward"].append(time_ms(torch, library_fwd, flush, args.iters))
            lib_ms["backward"].append(time_ms(torch, library_bwd, flush, args.iters))
            for name in want:
                for impl in order:
                    fn, a = impls[impl][name], inputs[name]
                    times[name][impl].append(time_ms(torch, lambda: fn(q, k, v, *a), flush, args.iters))
        result["library_ms"] = {phase: statistics.median(ms) for phase, ms in lib_ms.items()}
        for name in want:
            result[name] = {impl: {"ms": statistics.median(times[name][impl]), "ms_each": times[name][impl],
                                   "vs_plain": agreement(torch, impls[impl][name](q, k, v, *inputs[name]),
                                                         want[name])}
                            for impl in impls}
        for impl in impls:
            result["pair_ms_" + impl] = sum(result[name][impl]["ms"] for name in ("flash_bwd_dq", "flash_bwd_dkv"))
        print(json.dumps(result), flush=True)
        del out, qg, kg, vg, want, o_ref, lse, delta, inputs
        torch.cuda.empty_cache()
    print(card, flush=True)


if __name__ == "__main__":
    main()
