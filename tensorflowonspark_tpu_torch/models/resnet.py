"""ResNets as ``nn.Module``s — the port of the JAX package's
``models/resnet.py``, the performance workload.

Same architecture, names and numerics contract as the flax version:
ResNet-50 v1.5 (bottleneck blocks, stride 2 in the 3x3), ResNet-56 for
CIFAR, ResNet-18; bf16 compute with float32 parameters (each op casts its
weights to ``dtype``); BN momentum 0.9, eps 1e-5; the last BN of each
residual branch starts with a zero scale. Submodule names follow flax's
(``stem``, ``stem_bn``, ``stage{s}_block{i}.{conv1,bn1,...,proj,proj_bn}``,
``head``), so :mod:`~tensorflowonspark_tpu_torch.convert` maps the JAX
package's variables name for name.

The public input is NHWC, as in the reference, and every activation stays
channels-last: a conv sees an NCHW *view* of channels-last memory (cuDNN
takes it without a copy) and hands back the same, so BatchNorm's
``[N·H·W, C]`` view is free. Convolutions and the head matmul are PyTorch's
(the JAX package leaves them to XLA); ``bn_impl="pallas"`` runs BatchNorm
through the port's kernels
(:class:`~tensorflowonspark_tpu_torch.ops.fused_bn.FusedBatchNorm`),
``bn_impl="flax"`` through plain PyTorch math with f32 statistics, as the
JAX package's flax BatchNorm; under data parallelism both take the
statistics over the global batch. ``bn_impl="plain"`` is the kernels' plain
versions composed, with f64 statistics: the yardstick the kernels' train
step is held against.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch.models import register
from tensorflowonspark_tpu_torch.ops.fused_bn import BatchNorm, FusedBatchNorm, PlainBatchNorm

#: lecun_normal's truncated-normal correction: the std of a unit normal
#: truncated to [-2, 2] (flax/jax ``variance_scaling`` constant)
_TRUNC_STD = 0.87962566103423978


def _norm(bn_impl, num_features, zero_init_scale=False):
    if bn_impl == "pallas":
        cls = FusedBatchNorm
    elif bn_impl == "flax":
        cls = BatchNorm
    elif bn_impl == "plain":  # the checks' yardstick (f64 statistics)
        cls = PlainBatchNorm
    else:
        raise ValueError("bn_impl must be 'flax', 'pallas' or 'plain', got {!r}".format(bn_impl))
    return cls(num_features, momentum=0.9, eps=1e-5, zero_init_scale=zero_init_scale)


def _same_pads(size, kernel, stride):
    """flax/XLA ``padding="SAME"``: output ``ceil(size/stride)``, the extra
    pixel of an odd total on the high side — ``(0, 1)`` for a 3x3/2 conv on
    an even input, where a symmetric ``padding=1`` would shift the window."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """``flax.linen.Conv(use_bias=False)`` on channels-last activations:
    ``[N, H, W, C_in] → [N, H', W', C_out]``, weight OIHW in float32,
    computed in ``dtype``. ``padding`` is ``"SAME"`` or an explicit
    symmetric pad."""

    def __init__(self, in_features, features, kernel, stride=1, padding="SAME",
                 dtype=torch.float32):
        super().__init__()
        self.kernel, self.stride, self.padding, self.dtype = kernel, stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel, kernel))

    def forward(self, x):
        pad, stride = self.padding, self.stride
        if self.kernel == 1 and stride > 1:
            # a strided 1x1 conv reads every stride-th pixel: sample them
            # first and convolve at stride 1 (same result; PyTorch's oneDNN
            # CPU backend crashes in the strided 1x1 backward on
            # channels-last input)
            x, stride = x[:, ::stride, ::stride, :].contiguous(), 1
        if pad == "SAME":
            ph = _same_pads(x.shape[1], self.kernel, stride)
            pw = _same_pads(x.shape[2], self.kernel, stride)
            if ph[0] == ph[1] and pw[0] == pw[1]:
                pad = (ph[0], pw[0])
            else:
                x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
                pad = 0
        y = F.conv2d(
            x.to(self.dtype).permute(0, 3, 1, 2), self.weight.to(self.dtype),
            stride=stride, padding=pad,
        )
        return y.permute(0, 2, 3, 1)


class BottleneckBlock(nn.Module):
    """ResNet v1.5 bottleneck: 1x1 → 3x3(stride) → 1x1, projection shortcut."""

    def __init__(self, in_features, filters, strides=1, dtype=torch.float32, bn_impl="flax"):
        super().__init__()
        if in_features != filters * 4 or strides != 1:
            self.proj = Conv(in_features, filters * 4, 1, strides, dtype=dtype)
            self.proj_bn = _norm(bn_impl, filters * 4)
        self.conv1 = Conv(in_features, filters, 1, dtype=dtype)
        self.bn1 = _norm(bn_impl, filters)
        self.conv2 = Conv(filters, filters, 3, strides, dtype=dtype)
        self.bn2 = _norm(bn_impl, filters)
        self.conv3 = Conv(filters, filters * 4, 1, dtype=dtype)
        self.bn3 = _norm(bn_impl, filters * 4, zero_init_scale=True)

    def forward(self, x):
        shortcut = self.proj_bn(self.proj(x)) if hasattr(self, "proj") else x
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + shortcut)


class BasicBlock(nn.Module):
    """CIFAR ResNet basic block: 3x3 → 3x3."""

    def __init__(self, in_features, filters, strides=1, dtype=torch.float32, bn_impl="flax"):
        super().__init__()
        if in_features != filters or strides != 1:
            self.proj = Conv(in_features, filters, 1, strides, dtype=dtype)
            self.proj_bn = _norm(bn_impl, filters)
        self.conv1 = Conv(in_features, filters, 3, strides, dtype=dtype)
        self.bn1 = _norm(bn_impl, filters)
        self.conv2 = Conv(filters, filters, 3, dtype=dtype)
        self.bn2 = _norm(bn_impl, filters, zero_init_scale=True)

    def forward(self, x):
        shortcut = self.proj_bn(self.proj(x)) if hasattr(self, "proj") else x
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + shortcut)


class ResNet(nn.Module):
    """Stage-configurable ResNet; ``bottleneck`` picks the block type.

    ``forward(x)`` takes NHWC images (any float dtype) and returns float32
    logits; ``.train()`` / ``.eval()`` play flax's ``train=`` argument.
    Parameters are initialised as flax initialises them (lecun-normal conv
    and head kernels, zero head bias, BN scale 1 or 0, bias 0) from
    ``generator`` when one is given.
    """

    def __init__(self, stage_sizes, filters, num_classes=1000, bottleneck=True,
                 stem="imagenet", dtype=torch.float32, bn_impl="flax", channels=3,
                 generator=None):
        super().__init__()
        self.stem_kind, self.dtype = stem, dtype
        if stem == "imagenet":
            self.stem = Conv(channels, 64, 7, 2, padding=3, dtype=dtype)
            width = 64
        elif stem == "imagenet_s2d":
            # the JAX package's space-to-depth stem: 2x2 pixel blocks fold
            # into channels, then a stride-1 4x4 SAME conv
            self.stem = Conv(4 * channels, 64, 4, 1, dtype=dtype)
            width = 64
        elif stem == "cifar":
            self.stem = Conv(channels, filters[0], 3, dtype=dtype)
            width = filters[0]
        else:
            raise ValueError(
                "unknown stem {!r}; expected 'imagenet', 'imagenet_s2d', or 'cifar'".format(stem)
            )
        self.stem_bn = _norm(bn_impl, width)
        block_cls, expansion = (BottleneckBlock, 4) if bottleneck else (BasicBlock, 1)
        self.block_names = []
        for stage, (n_blocks, f) in enumerate(zip(stage_sizes, filters)):
            for i in range(n_blocks):
                strides = 2 if (i == 0 and stage > 0) else 1
                name = "stage{}_block{}".format(stage, i)
                setattr(self, name, block_cls(width, f, strides, dtype=dtype, bn_impl=bn_impl))
                self.block_names.append(name)
                width = f * expansion
        self.head = nn.Linear(width, num_classes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """flax's initialisers, drawn from ``generator``."""
        for module in self.modules():
            if isinstance(module, (Conv, nn.Linear)):
                w = module.weight
                fan_in = w.shape[1] * (w[0, 0].numel() if w.dim() > 2 else 1)
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
        nn.init.zeros_(self.head.bias)

    def forward(self, x):
        x = x.to(self.dtype)
        if self.stem_kind == "imagenet_s2d":
            b, h, w, c = x.shape
            if h % 2 or w % 2:
                raise ValueError(
                    "imagenet_s2d stem needs even spatial dims, got {}x{}".format(h, w)
                )
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(b, h // 2, w // 2, 4 * c)
        x = F.relu(self.stem_bn(self.stem(x)))
        if self.stem_kind != "cifar":
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(1, 2))
        return F.linear(x, self.head.weight.to(self.dtype), self.head.bias.to(self.dtype)).float()


@register("resnet50")
def resnet50(num_classes=1000, dtype=torch.float32, stem="imagenet", bn_impl="flax",
             generator=None):
    """ResNet-50 v1.5 (stages [3,4,6,3], filters 64/128/256/512);
    ``bn_impl="pallas"`` runs BatchNorm through the Triton kernels."""
    return ResNet(
        stage_sizes=(3, 4, 6, 3), filters=(64, 128, 256, 512),
        num_classes=num_classes, bottleneck=True, stem=stem, dtype=dtype,
        bn_impl=bn_impl, generator=generator,
    )


@register("resnet56")
def resnet56(num_classes=10, dtype=torch.float32, bn_impl="flax", generator=None):
    """ResNet-56 for CIFAR (3 stages × 9 basic blocks, filters 16/32/64)."""
    return ResNet(
        stage_sizes=(9, 9, 9), filters=(16, 32, 64),
        num_classes=num_classes, bottleneck=False, stem="cifar", dtype=dtype,
        bn_impl=bn_impl, generator=generator,
    )


@register("resnet18")
def resnet18(num_classes=1000, dtype=torch.float32, bn_impl="flax", generator=None):
    return ResNet(
        stage_sizes=(2, 2, 2, 2), filters=(64, 128, 256, 512),
        num_classes=num_classes, bottleneck=False, stem="imagenet", dtype=dtype,
        bn_impl=bn_impl, generator=generator,
    )


def _images(batch, normalize):
    return batch["image"] if normalize is None else normalize(batch["image"])


def _apply(module, model_state, images):
    """Run ``module`` with ``model_state`` (its BN running buffers) in place
    of its own buffers; a training-mode call updates them in place."""
    return torch.func.functional_call(module, model_state, (images,))


def make_loss_fn(model=None, weight_decay=1e-4, label_smoothing=0.0, normalize=None):
    """Mutable loss for ``SyncDataParallel.compile_train_step(mutable=True)``:
    ``loss_fn(module, model_state, batch) -> (loss, (model_state, aux))``.

    The module plays the JAX version's ``params`` (it holds them); the BN
    running statistics in ``model_state`` are updated in place and returned.
    The L2 term is ``weight_decay·0.5·Σ w²`` over the conv and head
    *kernels* — the parameters with more than one dimension — and excludes
    the BN scale/bias and the head bias, as the reference's ``kernel``
    filter does. ``model`` is accepted for signature parity and unused: the
    module arrives with each call.
    """
    del model

    def loss_fn(module, model_state, batch):
        logits = _apply(module, model_state, _images(batch, normalize))
        labels = batch["label"]
        loss = F.cross_entropy(logits, labels, label_smoothing=label_smoothing)
        if weight_decay:
            l2 = sum(p.square().sum() for p in module.parameters() if p.dim() > 1)
            loss = loss + weight_decay * 0.5 * l2
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, (model_state, {"accuracy": acc.detach()})

    return loss_fn


def make_eval_fn(model=None, normalize=None):
    """``eval_fn(module, model_state, batch) -> (correct, count)``: top-1
    with the running statistics (call with the module in eval mode)."""
    del model

    @torch.no_grad()
    def eval_fn(module, model_state, batch):
        logits = _apply(module, model_state, _images(batch, normalize))
        correct = (logits.argmax(-1) == batch["label"]).sum()
        return correct, batch["label"].shape[0]

    return eval_fn


def make_predict_fn(model=None, normalize=None):
    """``predict_fn(module, model_state, batch) -> class ids``."""
    del model

    @torch.no_grad()
    def predict_fn(module, model_state, batch):
        return _apply(module, model_state, _images(batch, normalize)).argmax(-1)

    return predict_fn
