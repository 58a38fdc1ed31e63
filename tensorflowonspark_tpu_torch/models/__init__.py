"""PyTorch model zoo of the port; the counterpart of the JAX package's flax
zoo:

* :mod:`~tensorflowonspark_tpu_torch.models.mnist` — the MLP and CNN MNIST
  classifiers.
* :mod:`~tensorflowonspark_tpu_torch.models.resnet` — ResNet-50 v1.5
  (ImageNet), ResNet-56 (CIFAR) and ResNet-18.
* :mod:`~tensorflowonspark_tpu_torch.models.transformer` — the decoder-only
  transformer LM (no mixture of experts yet).
* :mod:`~tensorflowonspark_tpu_torch.models.segmentation` — the U-Net of the
  segmentation example.
"""

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_model(name, **cfg):
    """Construct a registered model by name (e.g. 'mnist_mlp', 'resnet50',
    'resnet56', 'unet')."""
    if name not in _REGISTRY:
        # import lazily so get_model('resnet50') works without the caller
        # importing the module first
        from tensorflowonspark_tpu_torch.models import mnist, resnet, segmentation, transformer  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError("unknown model {!r}; known: {}".format(name, sorted(_REGISTRY)))
    return _REGISTRY[name](**cfg)
