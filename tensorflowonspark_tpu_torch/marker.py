"""Sentinel markers used on the feed queues.

Mirrors the roles of the reference's markers
(/root/reference/tensorflowonspark/marker.py:11-16): ``None`` on a feed queue is
the implicit end-of-feed signal, :class:`EndPartition` separates RDD partitions
so an inference task can collect exactly the results for its own partition.
"""


class Marker:
    """Base class for control markers placed on data queues."""

    __slots__ = ()

    def __repr__(self):  # pragma: no cover - cosmetic
        return "<{}>".format(type(self).__name__)


class EndPartition(Marker):
    """Marks the end of one RDD partition within a continuing feed."""

    __slots__ = ()


class Chunk(Marker):
    """A block of consecutive feed items shipped as ONE queue message.

    The feed plane's throughput unit: the reference pushed one pickled row
    per Manager proxy call (its hot-loop bottleneck, TFSparkNode.py:430-434);
    chunking amortizes the proxy round trip over ``len(items)`` rows. Fully
    transparent to consumers — :class:`~tensorflowonspark_tpu_torch.TFNode.DataFeed`
    unwraps chunks and plain items alike.
    """

    __slots__ = ("items",)

    def __init__(self, items):
        self.items = list(items)

    def __len__(self):
        return len(self.items)


#: The end-of-feed marker. Kept as ``None`` for wire-compat with the reference
#: semantics (/root/reference/tensorflowonspark/TFNode.py:267).
END_OF_FEED = None
