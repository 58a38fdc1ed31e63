"""Sequence-packed tokenized-text input pipeline (the text plane).

:class:`TextPipeline` is :class:`~tensorflowonspark_tpu_torch.data.loader.
ImagePipeline`'s contract transplanted onto variable-length text: stages
1+2 (shard read-ahead over the chunked-read ABI, bounded shuffle, raw
cache, ``max_bad_records``, the ``data.shard_read`` /
``data.readahead_stall`` chaos seams) are inherited verbatim, and stage 3
replaces fixed-geometry batch assembly with **sequence packing**: records
are tokenized and first-fit-decreasing bin-packed into fixed ``[B, L]``
int32 buffers (T5-style packing, Raffel et al. 2020), so the accelerator
sees one static shape regardless of the length distribution.

Each emitted batch is ``{"tokens", "segment_ids", "positions"}``, all
``int32 [B, L]`` views of one ``[B, 3, L]`` buffer:

- ``tokens`` — packed ids, 0 (PAD) in the slack;
- ``segment_ids`` — 0 for padding, 1..n per packed sequence, the
  cross-attention fence :mod:`~tensorflowonspark_tpu_torch.models.transformer`
  turns into a block-diagonal attention mask (flash and ring included);
- ``positions`` — restart at 0 per segment so rotary phases never leak
  across pack neighbours.

Packing runs producer-side as a *plan* (lengths only, via the tokenizer's
cheap validating :meth:`~tensorflowonspark_tpu_torch.data.tokenizer.Tokenizer.
token_length`), then the plan's cache misses are tokenized either on the
in-process thread pool or — with ``pack_workers > 0`` — in the decode
plane's forked workers writing straight into shared-memory slabs under the
slot-lease protocol (:mod:`~tensorflowonspark_tpu_torch.data.decode_plane`; the
payload is the pack plan, one lease per packed row). Because the plan, the
budget accounting, and the zeroing all happen in the producer thread, the
delivered ``[B, L]`` stream is **byte-identical** across ``pack_workers``
settings, readahead/chunk knobs, and packed-slab cache states (cold, warm,
off) — the same determinism contract the image plane enforces.

The packed-slab cache (:mod:`~tensorflowonspark_tpu_torch.data.slab_cache`) is
reused with per-*sequence* geometry ``(L,) int32``: rows are keyed by
record crc32 under the tokenizer-config fingerprint (kind, vocab, field,
``L`` — truncation depends on the bin capacity), the row label is the
effective token count, and epoch >= 2 (or a warm relaunch) serves token
ids from a memory map instead of re-tokenizing.

Chaos sites native to this stage: ``data.tokenize_error`` poisons a
record's bytes producer-side so the tokenizer rejects it (charged against
``max_bad_records``, identically in every pack mode) and
``data.pack_stall`` injects a delay inside the timed pack region, charged
to parse time so the stall classifier reports the run input-bound.
"""

import logging
import queue
import threading
import time
import weakref
import zlib

import numpy as np

from tensorflowonspark_tpu_torch import chaos, obs
from tensorflowonspark_tpu_torch.data import decode_plane, slab_cache
from tensorflowonspark_tpu_torch.data import tokenizer as tokenizer_mod
from tensorflowonspark_tpu_torch.data.loader import ImagePipeline, _Stopped

logger = logging.getLogger(__name__)

__all__ = ["TextPipeline", "pack_bins"]

#: invalid UTF-8 the ``data.tokenize_error`` site swaps in for a record
_CHAOS_BAD_RECORD = b"\xff\xfe chaos-malformed-text-record"


def pack_bins(lengths, capacity):
    """First-fit-decreasing bin packing of ``lengths`` into bins of
    ``capacity``. Returns bins in creation order, each a list of indices
    into ``lengths`` in placement (descending-length, arrival-stable)
    order. Pure and deterministic — the packing *plan* is computed once,
    producer-side, and every pack mode executes the same plan.

    FFD's classic guarantee (11/9 OPT + 6/9, Dósa 2007) is what bounds the
    pad waste the efficiency tests assert on adversarial distributions.
    """
    order = sorted(range(len(lengths)), key=lambda i: (-lengths[i], i))
    bins = []  # [used, [idx, ...]]
    for i in order:
        n = lengths[i]
        for b in bins:
            if b[0] + n <= capacity:
                b[0] += n
                b[1].append(i)
                break
        else:
            bins.append([n, [i]])
    return [b[1] for b in bins]


class TextPipeline(ImagePipeline):
    """files -> shuffled, tokenized, sequence-packed batches of
    ``{"tokens", "segment_ids", "positions"}`` (all ``int32 [B, L]``).

    Mirrors :class:`~tensorflowonspark_tpu_torch.data.loader.ImagePipeline`'s
    constructor and determinism contract; the differences:

    - ``tokenizer`` + ``seq_len`` replace ``parse_fn`` (the pack-plane
      parse fn is built internally via :func:`~tensorflowonspark_tpu_torch.data.
      tokenizer.make_pack_fn`);
    - ``pack_workers`` is the text plane's ``decode_workers`` (0 = thread
      pool, ``"auto"``/N = forked slab workers);
    - ``pack_ahead`` sizes the packing window: records accumulate until
      roughly ``pack_ahead * B * L`` tokens are pending, then the window
      is FFD-packed — deeper windows pack tighter, at more producer
      buffering (leftover part-full bins carry their sequences into the
      next window, so nothing is dropped mid-stream);
    - ``cache="decoded"`` and ``recycle_buffers`` are not supported (the
      decoded-pair cache is image-geometry machinery; packed rows already
      have the packed-slab cache).

    ``max_bad_records`` budgets records the tokenizer rejects (malformed
    UTF-8, empty text, missing Example feature) exactly like undecodable
    images: skipped and counted until the budget is spent, then the
    :class:`~tensorflowonspark_tpu_torch.data.tokenizer.TokenizeError` surfaces
    to the consumer. Sequences longer than ``L`` are not errors — they are
    truncated (terminal EOS kept) and counted in
    ``text_sequences_truncated_total``.
    """

    def __init__(
        self,
        files,
        tokenizer,
        seq_len,
        batch_size,
        shuffle=True,
        seed=0,
        num_threads=None,
        epochs=1,
        prefetch_batches=2,
        verify_crc=False,
        drop_remainder=True,
        max_bad_records=0,
        readahead=None,
        chunk_records=None,
        shuffle_buffer=4096,
        cache=None,
        pack_workers=None,
        pack_ahead=2.0,
        slab_cache_dir=None,
        store=None,
        prefetch=None,
    ):
        if cache == "decoded":
            raise ValueError(
                "cache='decoded' is image-plane machinery; the text plane's "
                "cross-epoch cache is the packed-slab cache (slab_cache_dir)"
            )
        seq_len = int(seq_len)
        if seq_len < 4:
            raise ValueError("seq_len must be >= 4 (BOS + body + EOS)")
        super().__init__(
            files,
            tokenizer_mod.make_pack_fn(tokenizer, seq_len),
            batch_size,
            shuffle=shuffle,
            seed=seed,
            num_threads=num_threads,
            epochs=epochs,
            prefetch_batches=prefetch_batches,
            verify_crc=verify_crc,
            drop_remainder=drop_remainder,
            max_bad_records=max_bad_records,
            readahead=readahead,
            chunk_records=chunk_records,
            shuffle_buffer=shuffle_buffer,
            cache=cache,
            decode_workers=pack_workers,
            slab_cache_dir=slab_cache_dir,
            store=store,
            prefetch=prefetch,
        )
        self.tokenizer = tokenizer
        self.seq_len = seq_len
        self.pack_ahead = float(pack_ahead)

    # -- stage 3: pack assembly ---------------------------------------------

    def __iter__(self):
        """The packed stream. The pack plane (``pack_workers > 0``) forks
        its workers here, when ``iter()`` is called, not at the first
        ``next()``: a trainer takes its iterator before it touches CUDA, so
        the workers never start from a process with a CUDA context."""
        plane = None
        workers, _auto = decode_plane.resolve_workers(self.decode_workers)
        if workers > 0:
            if decode_plane.available():
                plane = decode_plane.DecodePlane(self.parse_fn, workers)
            else:
                logger.warning(
                    "pack_workers=%s requested but fork/shared_memory is "
                    "unavailable here; falling back to the thread pack pool",
                    workers,
                )
        batches = self._batches(plane)
        if plane is not None:
            # a stream dropped before its first next() never runs its
            # finally: the plane goes down with the generator instead
            weakref.finalize(batches, plane.close)
        return batches

    def _batches(self, plane):
        from concurrent.futures import ThreadPoolExecutor

        B, L = self.batch_size, self.seq_len
        out_q = queue.Queue(maxsize=max(1, self.prefetch_batches))
        stop = threading.Event()  # consumer departed
        abort = threading.Event()  # producer died: unblocks reader threads
        _END = object()
        free_q = queue.Queue()  # recycled slab pairs (process mode only)
        pool_cap = max(1, self.prefetch_batches) + 2
        alloc_count = [0]

        produced_c = obs.counter(
            "data_batches_produced_total", help="batches parsed by the input pipeline"
        )
        consumed_c = obs.counter(
            "data_batches_consumed_total", help="batches handed to the training loop"
        )
        depth_g = obs.gauge(
            "data_prefetch_depth", help="parsed batches waiting in the prefetch queue"
        )
        skipped_c = obs.counter(
            "data_records_skipped_total",
            help="undecodable records skipped within the max_bad_records budget",
        )
        read_c = obs.counter(
            "data_producer_read_seconds_total",
            help="seconds spent in shard IO (open + chunk reads)",
        )
        parse_c = obs.counter(
            "data_producer_parse_seconds_total",
            help="seconds the parse pool spent decoding records into batch buffers",
        )
        emit_c = obs.counter(
            "data_producer_emit_seconds_total",
            help="seconds the producer blocked on a full prefetch queue "
            "(backpressure: the consumer is the bottleneck)",
        )
        wait_c = obs.counter(
            "data_consumer_wait_seconds_total",
            help="seconds the consumer waited on an empty prefetch queue "
            "(starvation: the input pipeline is the bottleneck)",
        )
        tok_err_c = obs.counter(
            "text_tokenize_errors_total",
            help="records the tokenizer rejected (charged to max_bad_records)",
        )
        trunc_c = obs.counter(
            "text_sequences_truncated_total",
            help="sequences longer than seq_len cut down to the bin capacity",
        )
        tokens_c = obs.counter(
            "text_tokens_packed_total", help="real (non-pad) tokens emitted in packed batches"
        )
        seqs_c = obs.counter(
            "text_sequences_packed_total", help="sequences emitted inside packed batches"
        )
        stall_c = obs.counter(
            "text_pack_stall_seconds_total",
            help="seconds the packer stalled inside the pack stage "
            "(slab-pool waits and injected data.pack_stall faults)",
        )
        eff_g = obs.gauge(
            "text_pack_efficiency",
            help="cumulative real-token fraction of emitted [B, L] slots",
        )
        pad_g = obs.gauge(
            "text_pad_fraction", help="cumulative pad fraction of emitted [B, L] slots"
        )

        reader_pool = (
            ThreadPoolExecutor(self.readahead, thread_name_prefix="tos-text-reader")
            if self.readahead > 0
            else None
        )

        # packed-row geometry is static — unlike images no bootstrap record
        # is needed to size the cache or the buffers
        cache_box = [None]
        if self.slab_cache_dir is not None:
            try:
                cache_box[0] = slab_cache.SlabCache(
                    self.slab_cache_dir, self.parse_fn.cache_key, (L,), np.int32
                )
            except Exception as e:
                logger.warning("packed-slab cache disabled: %s", e)
        into = self.parse_fn.into

        def _final_put(item):
            # never block forever on a departed consumer: its finally drains
            # the queue and sets stop, so either the put lands or stop shows
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def _acquire():
            # slabs are pooled (workers hold attachments by name); thread
            # mode emits fresh heap buffers, nothing to recycle
            if plane is None:
                return np.zeros((B, 3, L), np.int32), np.empty((B,), np.int32)
            try:
                pair = free_q.get_nowait()
            except queue.Empty:
                pair = None
            if pair is None:
                if alloc_count[0] < pool_cap:
                    alloc_count[0] += 1
                    pair = plane.new_slab(B, (3, L), np.int32)
                else:
                    # pool exhausted: timed-get until a slab returns or the
                    # consumer departs — this is a genuine pack stall
                    t0 = time.monotonic()
                    while True:
                        if stop.is_set():
                            raise _Stopped()
                        try:
                            pair = free_q.get(timeout=0.1)
                            break
                        except queue.Empty:
                            continue
                    waited = time.monotonic() - t0
                    plane.note_slab_wait(waited)
                    stall_c.inc(waited)
            pair[0][...] = 0  # zero tokens/segments/positions: pad baseline
            return pair

        def producer():
            bad = []  # tokenize errors absorbed so far (within budget)
            window = []  # (record bytes, eff_len) awaiting packing
            window_tokens = 0
            # at least one batch's worth of tokens per window: a mid-stream
            # flush then always yields >= B bins (ceil(tokens/L) >= B) and
            # the carry can never exceed the window it came from
            window_cap = max(B * L, int(self.pack_ahead * B * L))
            emitted_slots = [0]
            emitted_tokens = [0]

            def _absorb(err):
                if len(bad) >= self.max_bad_records:
                    raise err
                bad.append(err)
                skipped_c.inc()
                tok_err_c.inc()
                logger.warning("skipping untokenizable record: %s", err)

            def _emit(batch):
                if chaos.active:
                    chaos.delay("data.producer_delay")
                t0 = time.monotonic()
                while True:
                    try:
                        out_q.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        if stop.is_set():
                            raise _Stopped()
                emit_c.inc(time.monotonic() - t0)
                produced_c.inc()
                depth_g.set(out_q.qsize())

            def _cache_hit(rec, eff_len):
                """Serve a sequence's token ids from the packed-slab cache:
                returns (ids, None) on a hit, (None, crc) on a miss to be
                staged after tokenizing, (None, None) when the cache is
                off."""
                cache = cache_box[0]
                if cache is None:
                    return None, None
                crc = zlib.crc32(rec)
                hit = cache.lookup(crc)
                if hit is None:
                    return None, crc
                row, lbl = hit
                if int(lbl) != eff_len:  # stale geometry guard; re-tokenize
                    return None, crc
                return row[:eff_len], None

            def _fill_and_emit(bins):
                """Assemble one batch from packed bins: zeroed buffer, cache
                hits written parent-side, misses tokenized by the pack
                plane (one slot lease per row, the plan as payload) or the
                thread pool, fresh rows staged back into the cache."""
                rows = len(bins)
                buf, labels = _acquire()
                t0 = time.monotonic()
                if chaos.active:
                    tc = time.monotonic()
                    if chaos.delay("data.pack_stall"):
                        stall_c.inc(time.monotonic() - tc)
                plans = []  # (slot, plan tuple) for rows with cache misses
                puts = []  # (crc, slot, offset, eff_len) staged after the round
                for slot, entries in enumerate(bins):
                    offset = 0
                    plan = []
                    for seg_id, (rec, eff_len) in enumerate(entries, start=1):
                        ids, crc = _cache_hit(rec, eff_len)
                        if ids is not None:
                            tokenizer_mod.write_segment(buf[slot], offset, seg_id, ids)
                        else:
                            plan.append((offset, seg_id, eff_len, rec))
                            if crc is not None:
                                puts.append((crc, slot, offset, eff_len))
                        offset += eff_len
                    labels[slot] = len(entries)
                    if plan:
                        plans.append((slot, tuple(plan)))
                if plane is not None:
                    if plans:
                        try:
                            failures = plane.run_round(
                                buf, labels, plans, should_stop=stop.is_set
                            )
                        except decode_plane.Stopped:
                            raise _Stopped()
                        if failures:
                            # token_length already validated every record —
                            # a worker-side encode failure is a real bug,
                            # not a budget event
                            raise failures[0][1]
                else:
                    list(pool.map(lambda sp: into(sp[1], buf[sp[0]]), plans))
                cache = cache_box[0]
                if cache is not None:
                    padded = np.zeros((L,), np.int32)
                    for crc, slot, offset, eff_len in puts:
                        padded[...] = 0
                        padded[:eff_len] = buf[slot, 0, offset : offset + eff_len]
                        cache.put(crc, padded, eff_len)
                parse_c.inc(time.monotonic() - t0)
                n_tokens = sum(n for entries in bins for _, n in entries)
                tokens_c.inc(n_tokens)
                seqs_c.inc(sum(len(entries) for entries in bins))
                emitted_tokens[0] += n_tokens
                emitted_slots[0] += rows * L
                eff = emitted_tokens[0] / emitted_slots[0]
                eff_g.set(eff)
                pad_g.set(1.0 - eff)
                if plane is not None:
                    # slab views are copied out and the slab returns to the
                    # pool at once (yielded batches are retainable)
                    out = np.array(buf[:rows])
                    free_q.put((buf, labels))
                else:
                    out = buf[:rows]
                _emit(
                    {
                        "tokens": out[:, 0],
                        "segment_ids": out[:, 1],
                        "positions": out[:, 2],
                    }
                )

            def _flush(final):
                """FFD-pack the window and emit whole batches of B bins.
                Mid-stream, sequences in leftover part-full bins carry into
                the next window (arrival order preserved); at stream end
                the leftovers become one short batch unless
                ``drop_remainder``."""
                nonlocal window, window_tokens
                bins = pack_bins([n for _, n in window], L)
                full = (len(bins) // B) * B
                for g in range(0, full, B):
                    _fill_and_emit([[window[i] for i in b] for b in bins[g : g + B]])
                rest = bins[full:]
                if final:
                    if rest and not self.drop_remainder:
                        _fill_and_emit([[window[i] for i in b] for b in rest])
                    # else: short remainder dropped (one static shape)
                    window, window_tokens = [], 0
                else:
                    carry = sorted(i for b in rest for i in b)
                    window = [window[i] for i in carry]
                    window_tokens = sum(n for _, n in window)

            def _epoch_end():
                # pack the epoch's tail into full batches, then seal the
                # staged cache generation — epoch >= 2 reads it back.
                # Part-full leftover bins carry across the epoch boundary
                # (their rows join the next epoch's first commit).
                _flush(final=False)
                if cache_box[0] is not None:
                    cache_box[0].commit()

            try:
                pool_cm = (
                    ThreadPoolExecutor(self.num_threads)
                    if plane is None
                    else _NullPool()
                )
                with pool_cm as pool:
                    for rec in self._record_stream(
                        reader_pool, stop, abort, read_c, on_epoch_end=_epoch_end
                    ):
                        if stop.is_set():
                            return
                        # rolled here, in the producer thread, so the seeded
                        # schedule is independent of reader-thread timing
                        # (chaos call-order determinism) — and identical in
                        # thread and process pack modes: mode-invariant
                        if chaos.active and chaos.fire("data.tokenize_error"):
                            rec = _CHAOS_BAD_RECORD
                        t0 = time.monotonic()
                        try:
                            raw_len = self.tokenizer.token_length(rec)
                        except Exception as e:
                            parse_c.inc(time.monotonic() - t0)
                            _absorb(e)
                            continue
                        parse_c.inc(time.monotonic() - t0)
                        if raw_len > L:
                            trunc_c.inc()
                        window.append((bytes(rec), min(raw_len, L)))
                        window_tokens += min(raw_len, L)
                        if window_tokens >= window_cap:
                            _flush(final=False)
                    if window:
                        _flush(final=True)
            except _Stopped:
                return
            except BaseException as e:  # surfaced on the consuming side
                _final_put(e)
                return
            finally:
                if cache_box[0] is not None:
                    # commit the stream tail's staged rows, then release
                    cache_box[0].commit()
                    cache_box[0].close()
                _final_put(_END)
                abort.set()
                if reader_pool is not None:
                    reader_pool.shutdown(wait=False, cancel_futures=True)

        thread = threading.Thread(target=producer, name="tos-text-producer", daemon=True)
        thread.start()
        try:
            while True:
                t0 = time.monotonic()
                item = out_q.get()
                wait_c.inc(time.monotonic() - t0)
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                consumed_c.inc()
                depth_g.set(out_q.qsize())
                yield item
        finally:
            stop.set()
            # unblock the producer if it is waiting on a full queue (empty()
            # instead of catching Empty: exception classes may already be
            # torn down when a half-consumed generator is GC'd at exit)
            while not out_q.empty():
                out_q.get_nowait()
            if plane is not None:
                # the producer observes stop within one poll interval; only
                # after it is out of the lease protocol is the plane torn
                # down (workers drained, slab pool unlinked)
                thread.join(timeout=10.0)
                plane.close()


class _NullPool:
    """Context stand-in for the thread pool when the pack plane owns the
    parse stage (mirrors the loader's nullcontext use, but typed so the
    ``pool`` name always exists)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, items):
        return [fn(it) for it in items]
