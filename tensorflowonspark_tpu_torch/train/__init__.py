"""Training strategy and optimizer of the port (``torch.distributed`` data
parallelism; checkpointing comes in a later slice)."""

from tensorflowonspark_tpu_torch.train.optim import (  # noqa: F401
    adamw,
    linear_schedule,
    piecewise_constant_schedule,
    sgd,
)
from tensorflowonspark_tpu_torch.train.strategy import SyncDataParallel, TrainState  # noqa: F401
