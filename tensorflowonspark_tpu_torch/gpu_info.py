"""GPU discovery and device-visibility control.

The counterpart of the JAX package's ``tpu_info`` for NVIDIA cards: the local
device count comes from ``torch.cuda.device_count()``, and a child process is
pinned to a subset of cards (or kept off the card entirely) with
``CUDA_VISIBLE_DEVICES``.

These probes run in the executor process, which starts the trainer child and
must never initialise CUDA itself: ``torch.cuda.device_count()`` answers
through NVML without creating a CUDA context.
"""

import logging
import os

logger = logging.getLogger(__name__)

#: env var that overrides the detected device count (tests, odd hosts)
ENV_DEVICE_COUNT = "TOS_GPUS_PER_HOST"


def detect_local_chips():
    """Number of CUDA devices this process may use (honours
    ``CUDA_VISIBLE_DEVICES``; 0 without a card or a CUDA build of torch)."""
    override = os.environ.get(ENV_DEVICE_COUNT)
    if override:
        return int(override)
    import torch

    return torch.cuda.device_count()


def validate_against_runtime(local_device_count):
    """Compare :func:`detect_local_chips` with ``torch.cuda.device_count()``
    as the trainer child sees it. Logs, never raises: detection feeds
    placement hints, not correctness."""
    detected = detect_local_chips()
    if not detected or not local_device_count or detected == local_device_count:
        return True
    logger.warning(
        "gpu_info detected %d local device(s) but the runtime reports %d; "
        "trusting the runtime (override with %s)",
        detected, local_device_count, ENV_DEVICE_COUNT,
    )
    return False


def local_topology():
    """Summary of this host's cards, shipped in the reservation record."""
    return {"num_chips": detect_local_chips()}


def visibility_env(chip_ids=None, platform=None):
    """Environment that pins a child process to ``chip_ids`` (CUDA device
    indices), or hides every card when ``platform == "cpu"``."""
    env = {}
    if platform == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    elif chip_ids is not None:
        env["CUDA_VISIBLE_DEVICES"] = ",".join(str(c) for c in chip_ids)
    return env
