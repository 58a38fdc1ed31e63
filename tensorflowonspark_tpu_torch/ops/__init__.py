"""Hand-written Hopper kernels of the port, one module per TPU kernel family
of the JAX package; each wrapper launches its kernel on a CUDA tensor and
takes its plain PyTorch version on a CPU one."""
