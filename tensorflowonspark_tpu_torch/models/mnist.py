"""MNIST classifiers — the port of the JAX package's ``models/mnist.py``.

The Keras MLP of the reference (Flatten, Dense(512, relu), Dropout(0.2),
Dense(10)) and a small CNN. Parameters are float32 and initialised as flax
initialises them (lecun-normal kernels, zero biases); the products run in
``dtype`` and the logits come back in float32.

Submodules carry flax's names (``Dense_0``, ``Conv_1``, ...) so
:func:`~tensorflowonspark_tpu_torch.convert.convert_variables` loads the JAX
package's variables name for name. The CNN computes in NCHW and flattens in
flax's NHWC order (h, w, c), so ``Dense_0`` takes the converted kernel as
it is.

Dropout: jax's mask (``fold_in(PRNGKey(seed), step)``) cannot be drawn in
torch. Here the mask comes from a ``torch.Generator`` on the model's device
seeded from ``(dropout_seed, step)`` alone (:func:`dropout_generator`), with
flax's scaling of the kept values by ``1/(1-rate)``.
"""

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch.models import register

#: lecun_normal's truncated-normal correction: the std of a unit normal
#: truncated to [-2, 2] (flax/jax ``variance_scaling`` constant)
_TRUNC_STD = 0.87962566103423978


_M64 = (1 << 64) - 1


def _splitmix64(x):
    """A bijection of 64-bit ints that spreads every input bit over every
    output bit (the CPU generator keeps only a seed's low 32 bits)."""
    z = (x + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def dropout_generator(dropout_seed, step, device):
    """A ``torch.Generator`` on ``device`` seeded from ``(dropout_seed,
    step)`` alone: equal masks for equal steps, fresh ones every step.
    ``step`` is an int or a tensor (read back to the host)."""
    seed = _splitmix64(((int(dropout_seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
    return torch.Generator(device=device).manual_seed(seed)


def dropout(x, rate, generator=None):
    """flax ``nn.Dropout`` in training: keep each value with probability
    ``1 - rate`` and scale the kept ones by ``1/(1-rate)``."""
    if rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class _Flax(nn.Module):
    """flax-initialised parameters and ``dtype`` products."""

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """flax's initialisers, drawn from ``generator``."""
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                w = module.weight
                fan_in = w[0].numel()
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                nn.init.zeros_(module.bias)

    def _dense(self, layer, x):
        return F.linear(x, layer.weight.to(self.dtype), layer.bias.to(self.dtype))

    def _conv(self, layer, x):
        # flax Conv pads SAME: 1 on each side for a 3x3 kernel at stride 1
        return F.conv2d(x, layer.weight.to(self.dtype), layer.bias.to(self.dtype), padding=1)


class MnistMLP(_Flax):
    """The reference Keras model: 784 → ``hidden``, relu, dropout → 10."""

    def __init__(self, hidden=512, num_classes=10, dropout_rate=0.2, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.hidden, self.num_classes = hidden, num_classes
        self.dropout_rate, self.dtype = dropout_rate, dtype
        self.Dense_0 = nn.Linear(28 * 28, hidden)
        self.Dense_1 = nn.Linear(hidden, num_classes)
        self.reset_parameters(generator)

    def forward(self, x, train=False, rng=None):
        """``x``: ``[N, 28, 28]`` (or ``[N, 784]``); ``rng``: the dropout
        generator (``train=True`` only)."""
        x = x.to(self.dtype).reshape(x.shape[0], -1)
        x = F.relu(self._dense(self.Dense_0, x))
        if train:
            x = dropout(x, self.dropout_rate, rng)
        return self._dense(self.Dense_1, x).float()


class MnistCNN(_Flax):
    """conv 3×3 32, relu, maxpool 2; conv 3×3 64, relu, maxpool 2; dense
    128, relu, dropout 0.5 → 10."""

    dropout_rate = 0.5

    def __init__(self, num_classes=10, dtype=torch.float32, generator=None):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        self.Conv_0 = nn.Conv2d(1, 32, 3)
        self.Conv_1 = nn.Conv2d(32, 64, 3)
        self.Dense_0 = nn.Linear(7 * 7 * 64, 128)
        self.Dense_1 = nn.Linear(128, num_classes)
        self.reset_parameters(generator)

    def forward(self, x, train=False, rng=None):
        """``x``: ``[N, 28, 28]`` or ``[N, 28, 28, C]`` (NHWC, as in the
        JAX package)."""
        x = x.to(self.dtype)
        if x.dim() == 3:
            x = x[..., None]
        x = x.reshape(x.shape[0], 28, 28, -1).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self._conv(self.Conv_0, x)), 2, 2)  # flax pools VALID
        x = F.max_pool2d(F.relu(self._conv(self.Conv_1, x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's (h, w, c) order
        x = F.relu(self._dense(self.Dense_0, x))
        if train:
            x = dropout(x, self.dropout_rate, rng)
        return self._dense(self.Dense_1, x).float()


@register("mnist_mlp")
def create_mlp(**cfg):
    return MnistMLP(**cfg)


@register("mnist_cnn")
def create_cnn(**cfg):
    return MnistCNN(**cfg)


def create_model(kind="mlp", **cfg):
    return MnistMLP(**cfg) if kind == "mlp" else MnistCNN(**cfg)


def make_init_fn(model):
    """``init(generator) -> model`` with its parameters drawn afresh from
    the ``torch.Generator`` (the JAX version's ``init(rng) -> variables``)."""

    def init(generator=None):
        model.reset_parameters(generator)
        return model

    return init


def make_loss_fn(model, dropout_seed=0):
    """``loss_fn(module, batch, step=0) -> (loss, {"accuracy"})`` for
    ``SyncDataParallel.compile_train_step(..., has_aux=True)``; batch keys
    ``image`` (N,28,28[,1]) float and ``label`` (N,) int. The ``step``
    keyword is filled in with ``state.step``, so the dropout mask
    (:func:`dropout_generator`) changes every step."""
    del model  # the module arrives with each call

    def loss_fn(module, batch, step=0):
        image = batch["image"]
        rng = dropout_generator(dropout_seed, step, image.device)
        logits = module(image, train=True, rng=rng)
        label = batch["label"].long()
        loss = F.cross_entropy(logits, label)
        acc = (logits.argmax(-1) == label).float().mean()
        return loss, {"accuracy": acc}

    return loss_fn


def make_predict_fn(model):
    """``predict(module, batch) -> argmax class`` (eval mode, no dropout)."""
    del model

    def predict(module, batch):
        return module(batch["image"], train=False).argmax(-1)

    return predict


def build_predict(device=None, kind="mlp", **cfg):
    """An export bundle's ``predict_builder`` (bind ``kind`` and the model's
    ``cfg`` with :func:`bundle_builder`): builds the model on ``device``
    (default: the card, raising without one) and returns
    ``predict(params, model_state, arrays) -> {"prediction", "device"}``.
    ``params`` (``{name: array}``) are loaded into the module once per
    params object; ``arrays["image"]`` is any ``[N, 784]`` or
    ``[N, 28, 28]`` float array. ``device`` in the result names, row by
    row, the device the prediction ran on."""
    import numpy as np

    from tensorflowonspark_tpu_torch import util

    device = torch.device(device) if device is not None else util.select_device("gpu")
    module = create_model(kind, **cfg).to(device).eval()
    predict_fn = make_predict_fn(module)
    loaded = {}

    def predict(params, model_state, arrays):
        del model_state  # the MNIST models hold no buffers
        if loaded.get("params") is not params:
            module.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in params.items()})
            loaded["params"] = params
        images = torch.as_tensor(np.asarray(arrays["image"], np.float32).reshape(-1, 28, 28))
        with torch.no_grad():
            pred = predict_fn(module, {"image": images.to(device)})
        return {"prediction": pred.cpu().numpy(),
                "device": np.full(len(pred), str(device))}

    return predict


def bundle_builder(kind="mlp", **cfg):
    """The picklable ``predict_builder`` of an MNIST bundle
    (:func:`build_predict` with ``kind`` and ``cfg`` bound); the bundle's
    loader may pass it a ``device``."""
    return functools.partial(build_predict, kind=kind, **cfg)
