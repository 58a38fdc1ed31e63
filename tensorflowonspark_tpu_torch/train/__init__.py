"""Training strategy, optimizer and checkpointing of the port
(``torch.distributed`` data parallelism; ``torch.save`` checkpoints with the
JAX package's commit protocol)."""

from tensorflowonspark_tpu_torch.train import checkpoint  # noqa: F401
from tensorflowonspark_tpu_torch.train.metrics import TimeHistory, build_stats  # noqa: F401
from tensorflowonspark_tpu_torch.train.optim import (  # noqa: F401
    adam,
    adamw,
    linear_schedule,
    piecewise_constant_schedule,
    sgd,
)
from tensorflowonspark_tpu_torch.train.strategy import (  # noqa: F401
    SyncDataParallel,
    TrainState,
    run_steps,
    steps_per_worker,
)
