"""TFNode unit tests: hdfs_path matrix + DataFeed against a real local IPC
channel (mirrors reference test/test_TFNode.py)."""

import numpy as np
import pytest

from tensorflowonspark_tpu_torch import TFManager, TFNode
from tensorflowonspark_tpu_torch.marker import EndPartition


def mock_ctx(**kwargs):
    return type("MockContext", (), kwargs)


class TestHdfsPath:
    def test_absolute_uri_passthrough(self):
        ctx = mock_ctx(defaultFS="hdfs://namenode:8020")
        for p in (
            "file:///tmp/x",
            "hdfs://nn/data",
            "viewfs://cluster/data",
            "gs://bucket/data",
            "s3a://bucket/data",
            "abfss://c@acct.dfs.core.windows.net/d",
        ):
            assert TFNode.hdfs_path(ctx, p) == p

    def test_absolute_path_gets_default_fs(self):
        ctx = mock_ctx(defaultFS="hdfs://namenode:8020")
        assert TFNode.hdfs_path(ctx, "/data/mnist") == "hdfs://namenode:8020/data/mnist"

    def test_relative_path_hdfs_user_home(self):
        import getpass

        ctx = mock_ctx(defaultFS="hdfs://namenode:8020")
        assert TFNode.hdfs_path(ctx, "mnist") == "hdfs://namenode:8020/user/{}/mnist".format(
            getpass.getuser()
        )

    def test_relative_path_local_fs_working_dir(self):
        ctx = mock_ctx(defaultFS="file://", working_dir="/home/me")
        assert TFNode.hdfs_path(ctx, "mnist") == "file:///home/me/mnist"


@pytest.fixture
def ipc():
    mgr = TFManager.start(authkey=b"test-key", queues=("input", "output", "error"))
    yield mgr
    mgr.shutdown()


class TestDataFeed:
    def test_next_batch_and_end_of_feed(self, ipc):
        q = ipc.get_queue("input")
        for i in range(10):
            q.put(i)
        q.put(None)  # end-of-feed
        feed = TFNode.DataFeed(ipc)
        batch = feed.next_batch(4)
        assert batch == [0, 1, 2, 3]
        assert not feed.should_stop()
        batch = feed.next_batch(100)
        assert batch == [4, 5, 6, 7, 8, 9]
        assert feed.should_stop()
        q.join()  # every item including the marker was task_done'd

    def test_end_partition_breaks_batch(self, ipc):
        q = ipc.get_queue("input")
        q.put(1)
        q.put(2)
        q.put(EndPartition())
        q.put(3)
        q.put(None)
        feed = TFNode.DataFeed(ipc)
        assert feed.next_batch(10) == [1, 2]
        assert feed.next_batch(10) == [3]
        assert feed.should_stop()

    def test_input_mapping_columns(self, ipc):
        q = ipc.get_queue("input")
        q.put((1.0, 10))
        q.put((2.0, 20))
        q.put(None)
        feed = TFNode.DataFeed(ipc, input_mapping={"colA": "x", "colB": "y"})
        batch = feed.next_batch(2)
        assert batch == {"x": [1.0, 2.0], "y": [10, 20]}

    def test_as_numpy(self, ipc):
        q = ipc.get_queue("input")
        q.put((1.0, 10))
        q.put((2.0, 20))
        q.put(None)
        feed = TFNode.DataFeed(ipc, input_mapping={"a": "x", "b": "y"})
        batch = feed.next_batch(16, as_numpy=True)
        np.testing.assert_array_equal(batch["x"], np.array([1.0, 2.0]))
        np.testing.assert_array_equal(batch["y"], np.array([10, 20]))
        assert feed.should_stop()

    def test_batch_results_roundtrip(self, ipc):
        from tensorflowonspark_tpu_torch.marker import Chunk
        from tensorflowonspark_tpu_torch.shm import ShmChunk

        import numpy as _np

        feed = TFNode.DataFeed(ipc)
        # numpy results ride the shared-memory lane (types round-trip as
        # numpy either way)...
        feed.batch_results(list(_np.asarray([42, 43])))
        out = ipc.get_queue("output")
        chunk = out.get()
        assert isinstance(chunk, ShmChunk)
        assert [int(v) for v in chunk.rows()] == [42, 43]

        # ...while plain-Python rows pickle, so collectors see the exact
        # types the worker produced (json.dumps-able ints, not np.int64)
        feed.batch_results([42, 43])
        chunk = out.get()
        assert isinstance(chunk, Chunk) and chunk.items == [42, 43]

        feed.batch_results(["a", "b"])  # non-numeric -> pickled Chunk
        chunk = out.get()
        assert isinstance(chunk, Chunk) and chunk.items == ["a", "b"]

    def test_terminate_sets_state_and_drains(self, ipc):
        q = ipc.get_queue("input")
        for i in range(5):
            q.put(i)
        feed = TFNode.DataFeed(ipc)
        feed.terminate()
        assert ipc.get("state") == "terminating"
        assert q.qsize() == 0


class TestFeedChunking:
    """Feed-plane chunking: >=chunk_size fewer proxied puts per partition,
    transparent to DataFeed consumers."""

    def test_train_task_chunks_messages(self, tmp_path, monkeypatch):
        import os
        import secrets

        from tensorflowonspark_tpu_torch import TFManager, TFSparkNode, util
        from tensorflowonspark_tpu_torch.TFNode import DataFeed

        monkeypatch.chdir(tmp_path)
        authkey = secrets.token_bytes(8)
        mgr = TFManager.start(authkey=authkey, queues=("input", "output", "error"), mode="remote")
        try:
            mgr.set("state", "running")
            util.write_executor_state(
                {"executor_id": 7, "cluster_id": 1, "address": mgr.address,
                 "authkey": authkey, "job_name": "worker", "task_index": 0},
                cwd=str(tmp_path),
            )
            TFSparkNode._live_channels[7] = mgr
            task = TFSparkNode._TrainPartitionTask({"server_addr": None}, feed_timeout=30, chunk_size=100)

            import threading

            rows = list(range(1000))
            feeder = threading.Thread(target=task, args=(iter(rows),))
            feeder.start()
            # 1000 rows -> exactly 10 chunked messages on the queue
            import time

            q = mgr.get_queue("input")
            deadline = time.time() + 20
            while q.qsize() < 10 and time.time() < deadline:
                time.sleep(0.05)
            assert q.qsize() == 10, q.qsize()

            feed = DataFeed(mgr)
            got = []
            while len(got) < 1000:
                # batch size divides the feed: next_batch blocks (reference
                # semantics) until a batch fills or a marker arrives
                got.extend(feed.next_batch(50))
            assert got == rows
            feeder.join(timeout=30)
            assert not feeder.is_alive()
        finally:
            TFSparkNode._live_channels.pop(7, None)
            mgr.shutdown()
