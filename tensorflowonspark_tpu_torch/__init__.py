"""tensorflowonspark_tpu_torch — the PyTorch/CUDA port of tensorflowonspark_tpu.

The same Spark driver/executor lifecycle as the JAX package
(``TFCluster.run``, reservations, the IPC feed channel, the obs plane), with
the trainer child running PyTorch on an NVIDIA GPU and every TPU kernel of the
ported paths rewritten by hand for Hopper. Module paths and names mirror the
JAX package so a reader finds each counterpart:

* :mod:`~tensorflowonspark_tpu_torch.TFCluster` — driver-side cluster lifecycle API.
* :mod:`~tensorflowonspark_tpu_torch.TFSparkNode` — executor-side node runtime;
  the trainer child joins a ``torch.distributed`` world.
* :mod:`~tensorflowonspark_tpu_torch.gpu_info` — GPU discovery and
  ``CUDA_VISIBLE_DEVICES`` pinning (the ``tpu_info`` counterpart).
* :mod:`~tensorflowonspark_tpu_torch.ops.fused_bn` — training-mode BatchNorm
  as four Triton kernels.
* :mod:`~tensorflowonspark_tpu_torch.models` — ResNets (``nn.Module``).
* :mod:`~tensorflowonspark_tpu_torch.train` — ``SyncDataParallel`` and the
  SGD optimizer.
* :mod:`~tensorflowonspark_tpu_torch.convert` — JAX-package variables →
  ``state_dict``.

The package imports ``torch`` and never ``jax`` nor anything of the JAX
package: the control-plane modules it shares with it are copies. CUDA must
not be initialised in a process that later forks; the trainer child is
spawned, and touches the card only after it starts.
"""

__version__ = "0.1.0"
