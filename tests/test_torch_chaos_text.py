"""Text-plane chaos sites exercised through a live cluster: the seeded plan
propagates into the spawned jax children, ``data.tokenize_error`` skips are
charged against ``max_bad_records`` without corrupting the stream, a
``data.pack_stall`` delay lands in the pack stage's timed region, and every
fault plus the ``text_*`` accounting travels back through the merged
``TFCluster.metrics()`` snapshot."""

import time

import pytest

from tensorflowonspark_tpu_torch import TFCluster, chaos, util
from tensorflowonspark_tpu_torch.TFCluster import InputMode
from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext

pytestmark = pytest.mark.chaos

CPU_ENV = {util.ENV_PLATFORM: "cpu"}


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.uninstall()
    yield
    chaos.uninstall()


@pytest.fixture
def sc():
    ctx = LocalSparkContext(num_executors=2, task_timeout=120)
    yield ctx
    ctx.stop()


def fn_text_pipeline_under_chaos(args, ctx):
    # runs inside the spawned jax child: the plan must have propagated, the
    # pipeline must absorb the injected tokenize errors within its budget
    # and deliver every surviving record exactly once
    from tensorflowonspark_tpu_torch import chaos as _chaos
    from tensorflowonspark_tpu_torch.data import TextPipeline, Tokenizer

    assert _chaos.active, "chaos plan did not reach the jax child"

    pipe = TextPipeline(
        [args["shard"]], Tokenizer(kind="word", vocab_size=64),
        seq_len=32, batch_size=2, shuffle=False, epochs=1,
        max_bad_records=8, drop_remainder=False,
    )
    # segment ids are 1..n per row: the per-row max IS the sequence count
    n_seqs = sum(int(b["segment_ids"].max(axis=1).sum()) for b in pipe)
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        batch = feed.next_batch(16)
        if batch:
            feed.batch_results([n_seqs for _ in batch])


def _poll_counter(cluster, name, want, deadline_s=60):
    # include_driver=False: mid-suite the driver registry carries counters
    # from earlier in-process tests (spawned children start clean); every
    # assertion below must hold from the two children alone
    deadline = time.monotonic() + deadline_s
    while True:
        snap = cluster.metrics(include_driver=False)
        got = snap["counters"].get(name, {}).get("value", 0)
        if got >= want or time.monotonic() > deadline:
            return snap, got


class TestTextChaosCluster:
    def test_tokenize_error_and_pack_stall_surface_in_cluster_metrics(
        self, sc, tmp_path
    ):
        from tensorflowonspark_tpu_torch import tfrecord

        shard = str(tmp_path / "part-00000")
        with tfrecord.TFRecordWriter(shard) as w:
            for i in range(48):
                w.write("record number {} with a few words".format(i).encode())

        plan = (
            chaos.ChaosPlan(seed=3)
            # child side: three records swapped for invalid UTF-8 — charged
            # to the pipeline's max_bad_records, stream otherwise intact
            .site("data.tokenize_error", probability=1.0, max_count=3)
            # child side: the packer sleeps inside the timed pack region
            .site("data.pack_stall", probability=1.0, max_count=2, delay_s=0.02)
        )
        chaos.install(plan)  # propagate=True: children inherit via env
        cluster = TFCluster.run(
            sc, fn_text_pipeline_under_chaos, {"shard": shard}, num_executors=2,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        try:
            results = cluster.inference(sc.parallelize(range(40), 4)).collect()
            # both children packed the stream: 48 records - 3 chaos-poisoned
            # skips survived in each (the answer is per-child, rows echo it)
            assert results and all(r == 45 for r in results), results

            snap, faults = _poll_counter(
                cluster, "chaos_fault_data_tokenize_error_total", 6
            )
            counters = snap["counters"]
            # both sites fired in both children and surfaced in the merge
            assert counters["chaos_fault_data_tokenize_error_total"]["value"] >= 6
            assert counters["chaos_fault_data_pack_stall_total"]["value"] >= 4
            # the text accounting traveled the same lane: the skips were
            # charged to the budget (and to the data-plane skip counter)...
            assert counters["text_tokenize_errors_total"]["value"] >= 6
            assert counters["data_records_skipped_total"]["value"] >= 6
            # ...and the injected delay is visible as pack-stall seconds,
            # charged into parse time so the stall classifier reads the job
            # as input-bound (decode_bound: parse >= read)
            assert counters["text_pack_stall_seconds_total"]["value"] >= 0.04
            assert (
                counters["data_producer_parse_seconds_total"]["value"]
                >= counters["data_producer_read_seconds_total"]["value"]
            )
            assert counters["text_sequences_packed_total"]["value"] >= 90
        finally:
            cluster.shutdown(timeout=120)
