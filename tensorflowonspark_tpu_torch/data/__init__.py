"""Input-side helpers of the port: the text plane (TFRecord text shards →
tokenize → FFD-pack into ``[B, seq_len + 1]`` rows with ``segment_ids`` and
``positions``) and the loader under it (local shards, thread pools),
copied from the JAX package's ``data/`` with placement through
``strategy.shard_batch``. The image real-data plane's parsing, the forked
decode plane, the slab cache, the autotuners and the remote stores come in
a later slice."""

from tensorflowonspark_tpu_torch.data.loader import (  # noqa: F401
    ImagePipeline,
    device_prefetch,
    loop_prefetch,
    packed_place,
    packed_prefetch,
    shard_files,
)
from tensorflowonspark_tpu_torch.data.text_plane import (  # noqa: F401
    TextPipeline,
    pack_bins,
)
from tensorflowonspark_tpu_torch.data.tokenizer import (  # noqa: F401
    TokenizeError,
    Tokenizer,
)
from tensorflowonspark_tpu_torch.data import imagenet  # noqa: F401
