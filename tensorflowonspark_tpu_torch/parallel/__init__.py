"""Parallelism helpers of the port. Data parallelism lives in
:mod:`~tensorflowonspark_tpu_torch.train.strategy`; of the JAX package's
model axes only the single-device attention reference is ported so far
(:func:`~tensorflowonspark_tpu_torch.parallel.ring_attention.plain_attention`)."""
