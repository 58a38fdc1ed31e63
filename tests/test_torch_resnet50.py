"""The port's full-depth, full-width ResNet-50 against the JAX package's, on
the CPU: the JAX model's variables go through ``convert.load_variables`` into
the port's module, and both see the same numpy batch at 32 px."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tensorflowonspark_tpu.models import resnet as jax_resnet
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.models import resnet


def test_full_resnet50_forward_loss_matches_reference():
    """Full depth and width at 32 px, batch 2, f32, train mode, against the
    reference's bn_impl='flax' (pinned to its pallas path by
    test_fused_bn.py). 1e-3: 53 BN layers each normalising over as few as
    2 rows at the 1x1 stage-3 resolution amplify float32 summation-order
    differences through the depth."""
    rng = np.random.default_rng(3)
    batch = {"image": rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 1000, 2)}
    jmodel = jax_resnet.resnet50(bn_impl="flax")
    variables = jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False))(
        jnp.asarray(batch["image"]))
    variables = jax.tree.map(np.asarray, jax.device_get(variables))
    jloss, _ = jax.jit(jax_resnet.make_loss_fn(jmodel, weight_decay=1e-4))(
        variables["params"], {"batch_stats": variables["batch_stats"]},
        {k: jnp.asarray(v) for k, v in batch.items()},
    )
    module = convert.load_variables(resnet.resnet50(bn_impl="pallas"), variables).train()
    with torch.no_grad():
        tloss, _ = resnet.make_loss_fn(weight_decay=1e-4)(
            module, dict(module.named_buffers()), {k: torch.as_tensor(v) for k, v in batch.items()}
        )
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-3)
