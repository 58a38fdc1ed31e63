"""Version/platform compatibility shims — the port of the JAX package's
``compat.py``.

The reference's three shims smoothed over TF 2.0/2.1 differences; here:

* ``export_saved_model`` — the chief-vs-worker export dance of the
  reference (workers dumped to a throwaway dir) is unnecessary: it
  delegates to the checkpoint layer's export, kept for drop-in source
  compatibility.
* ``disable_auto_shard`` — a tf.data concept with no counterpart in the
  port's input path; does nothing.
* ``is_gpu_available`` — whether this process sees an NVIDIA card.
"""

import logging

logger = logging.getLogger(__name__)


def export_saved_model(model_or_state, export_dir, is_chief=False):
    """Write ``model_or_state`` (a TrainState or a tree of tensors or
    arrays) to ``export_dir`` through
    :func:`tensorflowonspark_tpu_torch.train.checkpoint.export_saved_model`;
    returns the path. ``is_chief`` is accepted for source compatibility."""
    from tensorflowonspark_tpu_torch.train import checkpoint

    return checkpoint.export_saved_model(None, export_dir, model_or_state, is_chief=is_chief)


def disable_auto_shard(options):
    """Auto-sharding is a tf.data policy that does not exist in the port's
    input path — explicit shard placement replaces it."""
    del options


def is_gpu_available():
    """Whether this process sees a CUDA device (``gpu_info``, which answers
    without creating a CUDA context)."""
    from tensorflowonspark_tpu_torch import gpu_info

    return gpu_info.detect_local_chips() > 0


def is_tpu_available():
    """Kept for source compatibility with the JAX package, whose stack runs
    on TPU chips; the port runs on NVIDIA cards and never on a TPU, so this
    is always ``False``."""
    return False
