"""Host-side input pipelines of the port, copied from the JAX package's
``data/``: TFRecord shards streamed in chunks through the native reader
(:mod:`tensorflowonspark_tpu_torch.native_io`) with shard read-ahead,
records re-ordered by a bounded shuffle buffer, images decoded and augmented
on a thread pool (the native decoder, or PIL) or — with ``decode_workers >
0`` — in the forked :mod:`~tensorflowonspark_tpu_torch.data.decode_plane`
writing into shared-memory slabs, an optional cross-epoch decoded-slab
cache, remote stores with prefetch staging, and the text plane (tokenize →
FFD-pack into ``[B, seq_len + 1]`` rows). Batches reach the card through
pinned buffers on a copy stream (``loader.PinnedPlacer``: the prefetchers
and the feed autotuner's probes); the JAX package's ``packed_place`` has no
counterpart.
"""

from tensorflowonspark_tpu_torch.data.loader import (  # noqa: F401
    ImagePipeline,
    device_prefetch,
    loop_prefetch,
    packed_prefetch,
    shard_files,
)
from tensorflowonspark_tpu_torch.data.autotune import (  # noqa: F401
    AutotunedWindow,
    FeedAutotuner,
    LinkEstimator,
    autotuned_prefetch,
)
from tensorflowonspark_tpu_torch.data.decode_plane import (  # noqa: F401
    DecodeAutotuner,
    DecodePlane,
)
from tensorflowonspark_tpu_torch.data.text_plane import (  # noqa: F401
    TextPipeline,
    pack_bins,
)
from tensorflowonspark_tpu_torch.data.tokenizer import (  # noqa: F401
    TokenizeError,
    Tokenizer,
)
from tensorflowonspark_tpu_torch.data import cifar, imagenet  # noqa: F401
