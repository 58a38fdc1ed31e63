"""Image segmentation U-Net — the port of the JAX package's
``models/segmentation.py``.

The model of BASELINE config 5: an encoder/decoder of ``depth`` levels with
skip connections on 128×128×3 images and 3 output classes. Each level is a
:class:`ConvBlock` (twice: a 3×3 SAME conv without bias, GroupNorm of 8
groups, tanh gelu); the encoder max-pools 2×2 after each block, the decoder
upsamples with a 2×2 stride-2 transposed conv and concatenates the skip on
the channel axis; a 1×1 conv with bias gives the logits, which come back in
float32.

Images and logits are NHWC at the interface, as in the JAX package; the
convs run in NCHW inside. The flax defaults are kept where torch's differ:
``nn.gelu`` is the tanh approximation, ``nn.GroupNorm``'s epsilon is 1e-6
(its statistics in float32), and parameters are initialised as flax does
(lecun-normal kernels, zero biases, unit norm scales). Products run in
``dtype`` (float32 by default, as the JAX model's; bfloat16 keeps float32
parameters).

Submodules carry flax's names (``enc0.Conv_0``, ``enc0.GroupNorm_0``,
``up0``, ``head``, ...), so
:func:`~tensorflowonspark_tpu_torch.convert.convert_variables` loads the
JAX package's variables name for name. Convs and GroupNorm are cuDNN's and
PyTorch's: the JAX model reaches no Pallas kernel either.
"""

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch.models import register
from tensorflowonspark_tpu_torch.models.mnist import _TRUNC_STD

#: flax ``nn.GroupNorm``'s defaults
GROUPS, GROUP_EPS = 8, 1e-6


class ConvBlock(nn.Module):
    """(3×3 conv without bias → GroupNorm(8) → tanh gelu) twice."""

    def __init__(self, in_channels, filters):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, filters, 3, padding=1, bias=False)
        self.GroupNorm_0 = nn.GroupNorm(GROUPS, filters, eps=GROUP_EPS)
        self.Conv_1 = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.GroupNorm_1 = nn.GroupNorm(GROUPS, filters, eps=GROUP_EPS)

    def _layer(self, conv, norm, x):
        x = F.conv2d(x, conv.weight.to(x.dtype), padding=1)
        # flax normalises in float32 and casts the result to the compute dtype
        x = F.group_norm(x.float(), GROUPS, norm.weight, norm.bias, GROUP_EPS).to(x.dtype)
        return F.gelu(x, approximate="tanh")

    def forward(self, x):
        x = self._layer(self.Conv_0, self.GroupNorm_0, x)
        return self._layer(self.Conv_1, self.GroupNorm_1, x)


class UNet(nn.Module):
    """Encoder/decoder with skip connections (the JAX package's ``UNet``).

    ``forward(x)``: ``x`` ``[N, H, W, in_channels]`` (H and W divisible by
    ``2**depth``) → logits ``[N, H, W, num_classes]`` float32."""

    def __init__(self, num_classes=3, base_filters=32, depth=4, dtype=torch.float32, in_channels=3,
                 generator=None):
        super().__init__()
        self.num_classes, self.base_filters, self.depth = num_classes, base_filters, depth
        self.dtype, self.in_channels = dtype, in_channels
        width = [base_filters * 2 ** d for d in range(depth + 1)]
        prev = in_channels
        for d in range(depth):
            self.add_module("enc{}".format(d), ConvBlock(prev, width[d]))
            prev = width[d]
        self.bottleneck = ConvBlock(prev, width[depth])
        for d in reversed(range(depth)):
            self.add_module("up{}".format(d), nn.ConvTranspose2d(width[d + 1], width[d], 2, stride=2))
            self.add_module("dec{}".format(d), ConvBlock(2 * width[d], width[d]))
        self.head = nn.Conv2d(width[0], num_classes, 1)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """flax's initialisers, drawn from ``generator``: lecun-normal
        kernels (fan-in = input channels × kernel area, for the transposed
        convs too), zero biases, unit GroupNorm scales."""
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
                w = module.weight
                # Conv2d holds [out, in, kh, kw], ConvTranspose2d [in, out, kh, kw]
                fan_in = w.shape[1 if isinstance(module, nn.Conv2d) else 0] * w.shape[2] * w.shape[3]
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
            elif isinstance(module, nn.GroupNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)

    def forward(self, x, train=False):
        del train  # no dropout or BN: the signature of the other models
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        skips = []
        for d in range(self.depth):
            x = getattr(self, "enc{}".format(d))(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)  # flax pools VALID
        x = self.bottleneck(x)
        for d in reversed(range(self.depth)):
            up = getattr(self, "up{}".format(d))
            x = F.conv_transpose2d(x, up.weight.to(x.dtype), up.bias.to(x.dtype), stride=2)
            x = getattr(self, "dec{}".format(d))(torch.cat([x, skips[d]], 1))
        logits = F.conv2d(x, self.head.weight.to(x.dtype), self.head.bias.to(x.dtype))
        return logits.permute(0, 2, 3, 1).float()


@register("unet")
def create_model(**cfg):
    return UNet(**cfg)


def make_init_fn(model, image_size=128, channels=3):
    """``init(generator) -> model`` with its parameters drawn afresh from
    the ``torch.Generator`` (the JAX version's ``init(rng) -> variables``).
    The convs take any image size, so ``image_size`` only keeps the JAX
    signature; ``channels`` must be the model's."""
    del image_size
    if channels != model.in_channels:
        raise ValueError("init for {} channels, the model takes {}".format(channels, model.in_channels))

    def init(generator=None):
        model.reset_parameters(generator)
        return model

    return init


def make_loss_fn(model):
    """``loss_fn(module, batch) -> (loss, {"pixel_accuracy"})`` for
    ``compile_train_step(..., has_aux=True)``; batch ``image`` ``[N, H, W,
    C]`` float and ``mask`` ``[N, H, W]`` int. The loss is the mean
    softmax cross-entropy over every pixel."""
    del model  # the module arrives with each call

    def loss_fn(module, batch):
        logits = module(batch["image"])
        mask = batch["mask"].long()
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), mask.reshape(-1))
        acc = (logits.argmax(-1) == mask).float().mean()
        return loss, {"pixel_accuracy": acc}

    return loss_fn


def make_predict_fn(model):
    """``predict(module, batch) -> [N, H, W]`` class of every pixel."""
    del model

    def predict(module, batch):
        return module(batch["image"]).argmax(-1)

    return predict


def build_predict(device=None, **cfg):
    """An export bundle's ``predict_builder`` (bind the model's ``cfg`` with
    :func:`bundle_builder`): builds the U-Net on ``device`` (default: the
    card, raising without one) and returns ``predict(params, model_state,
    arrays) -> {"mask", "device"}``. ``params`` (``{name: array}``) are
    loaded once per params object; ``arrays["image"]`` is ``[N, H, W, C]``
    float; ``mask`` is ``[N, H, W]`` int64 and ``device`` names, image by
    image, the device the prediction ran on."""
    import numpy as np

    from tensorflowonspark_tpu_torch import util

    device = torch.device(device) if device is not None else util.select_device("gpu")
    module = create_model(**cfg).to(device).eval()
    predict_fn = make_predict_fn(module)
    loaded = {}

    def predict(params, model_state, arrays):
        del model_state  # the U-Net holds no buffers
        if loaded.get("params") is not params:
            module.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in params.items()})
            loaded["params"] = params
        images = torch.as_tensor(np.asarray(arrays["image"], np.float32))
        with torch.no_grad():
            mask = predict_fn(module, {"image": images.to(device)})
        return {"mask": mask.cpu().numpy(), "device": np.full(len(mask), str(device))}

    return predict


def bundle_builder(**cfg):
    """The picklable ``predict_builder`` of a U-Net bundle
    (:func:`build_predict` with ``cfg`` bound); the bundle's loader may pass
    it a ``device``."""
    return functools.partial(build_predict, **cfg)
