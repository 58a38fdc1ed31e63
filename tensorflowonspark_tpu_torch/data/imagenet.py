"""ImageNet constants and the on-device normalisation of the port (the JAX
package's ``data/imagenet.py``; its host-side parsing and augmentation come
with the real-data input plane in a later slice)."""

import numpy as np

#: standard per-channel RGB means (same constants the reference subtracts,
#: imagenet_preprocessing.py:54-57)
CHANNEL_MEANS = np.array([123.68, 116.78, 103.94], np.float32)


def device_normalize(images):
    """On-device twin of the host mean subtraction: uint8 ``[B,H,W,C]``
    tensor → float32 minus :data:`CHANNEL_MEANS`, so the feed can ship
    uint8 (a quarter of the float32 bytes) to the device."""
    import torch

    return images.float() - torch.as_tensor(CHANNEL_MEANS, device=images.device)
