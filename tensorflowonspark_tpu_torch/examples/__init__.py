"""Ported example programs, runnable as modules
(``python -m tensorflowonspark_tpu_torch.examples.resnet.resnet_spark``)."""
