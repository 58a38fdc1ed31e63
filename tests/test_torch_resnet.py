"""The port's ResNets and weight converter against the JAX package's flax
ResNets, on the CPU.

The JAX model's variables go through ``convert.load_variables`` into the
port's module; both then see the same numpy batch. Small models cover both
block types, every stem and both ``bn_impl``s (the JAX package's
``bn_impl="pallas"`` runs its kernels in interpret mode on the CPU); the
full-depth, full-width ResNet-50 is in test_torch_resnet50.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models import resnet as jax_resnet
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.models import resnet


def _variables(model, x):
    variables = jax.jit(lambda x: model.init(jax.random.PRNGKey(0), x, train=False))(jnp.asarray(x))
    return jax.tree.map(np.asarray, jax.device_get(variables))


def _batch(rng, n, size, classes):
    return {
        "image": rng.standard_normal((n, size, size, 3)).astype(np.float32),
        "label": rng.integers(0, classes, n),
    }


SMALL = {
    "bottleneck_imagenet": dict(stage_sizes=(1, 1), filters=(8, 16), bottleneck=True, stem="imagenet"),
    "basic_cifar": dict(stage_sizes=(1, 1), filters=(8, 16), bottleneck=False, stem="cifar"),
    "bottleneck_s2d": dict(stage_sizes=(1,), filters=(8,), bottleneck=True, stem="imagenet_s2d"),
}


@pytest.mark.parametrize("arch,bn_impl", [
    ("bottleneck_imagenet", "flax"), ("bottleneck_imagenet", "pallas"),
    ("basic_cifar", "flax"), ("bottleneck_s2d", "flax"),
])
def test_converted_small_resnet_matches_loss_grads_and_stats(arch, bn_impl):
    """Loss within 1e-4 and grads within 2e-3 (the reference's pallas-vs-flax
    tolerances, test_fused_bn.py:195-199); updated BN statistics within 1e-4.
    The imagenet stem's strided 3x3 on an even input checks flax's SAME
    (0, 1) padding."""
    cfg = dict(SMALL[arch], num_classes=10)
    rng = np.random.default_rng(7)
    batch = _batch(rng, 4, 16, 10)
    jmodel = jax_resnet.ResNet(bn_impl=bn_impl, **cfg)
    variables = _variables(jmodel, batch["image"])
    jloss_fn = jax_resnet.make_loss_fn(jmodel, weight_decay=1e-4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, (jstate, _)), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        variables["params"], {"batch_stats": variables["batch_stats"]}, jbatch
    )

    module = convert.load_variables(resnet.ResNet(bn_impl=bn_impl, **cfg), variables).train()
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    tloss, (tstate, _) = resnet.make_loss_fn(weight_decay=1e-4)(
        module, dict(module.named_buffers()), tbatch
    )
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-4)
    want_grads = convert.convert_variables({"params": jax.tree.map(np.asarray, jgrads)})
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), atol=2e-3, err_msg=name)
    want_stats = convert.convert_variables({"batch_stats": jax.tree.map(np.asarray, jstate["batch_stats"])})
    for name, value in want_stats.items():
        np.testing.assert_allclose(tstate[name].numpy(), value.numpy(), atol=1e-4, err_msg=name)


def test_eval_and_predict_use_running_statistics():
    cfg = dict(SMALL["basic_cifar"], num_classes=10)
    rng = np.random.default_rng(9)
    batch = _batch(rng, 4, 8, 10)
    jmodel = jax_resnet.ResNet(**cfg)
    variables = _variables(jmodel, batch["image"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = {"batch_stats": variables["batch_stats"]}
    jcorrect, _ = jax_resnet.make_eval_fn(jmodel)(variables["params"], jstate, jbatch)
    jpred = jax_resnet.make_predict_fn(jmodel)(variables["params"], jstate, jbatch)
    module = convert.load_variables(resnet.ResNet(**cfg), variables).eval()
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    state = dict(module.named_buffers())
    tcorrect, count = resnet.make_eval_fn()(module, state, tbatch)
    np.testing.assert_array_equal(resnet.make_predict_fn()(module, state, tbatch).numpy(), np.asarray(jpred))
    assert int(tcorrect) == int(jcorrect) and count == 4


def test_flax_init_distribution_and_zero_residual_scale():
    def build():
        return resnet.ResNet((1, 1), (64, 128), generator=torch.Generator().manual_seed(0))

    module = build()
    w = module.stage1_block0.conv2.weight  # 128 x 128 x 3 x 3, fan_in 1152
    assert abs(float(w.std()) - (1 / 1152) ** 0.5) < 2e-3
    assert float(w.abs().max()) <= 2 * (1 / 1152) ** 0.5 / resnet._TRUNC_STD + 1e-6
    assert torch.all(module.stage0_block0.bn3.weight == 0)
    assert torch.all(module.stage0_block0.bn1.weight == 1)
    assert torch.all(module.head.bias == 0)
    assert torch.equal(build().stem.weight, module.stem.weight)


def test_converter_raises_on_unmatched_keys_and_shapes():
    cfg = dict(SMALL["basic_cifar"], num_classes=10)
    shapes = jax.eval_shape(
        lambda x: jax_resnet.ResNet(**cfg).init(jax.random.PRNGKey(0), x, train=False),
        jnp.zeros((1, 8, 8, 3)),
    )
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    module = resnet.ResNet(**cfg)
    extra = {"params": dict(variables["params"], stray={"kernel": np.zeros((3, 3))}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="stray"):
        convert.convert_variables(extra, module)
    params = dict(variables["params"])
    del params["head"]
    with pytest.raises(KeyError, match="head.weight"):
        convert.convert_variables({"params": params, "batch_stats": variables["batch_stats"]}, module)
    with pytest.raises(KeyError, match="no port counterpart"):
        convert.convert_variables({"params": {"embed": {"codebook": np.zeros((4, 2))}}})
    with pytest.raises(ValueError, match="shape"):
        convert.convert_variables(variables, resnet.ResNet(**dict(cfg, num_classes=7)))


@pytest.mark.parametrize("size,kernel,stride,pads", [
    (56, 3, 2, (0, 1)), (7, 3, 2, (1, 1)), (56, 3, 1, (1, 1)), (56, 1, 2, (0, 0)), (112, 4, 1, (1, 2)),
])
def test_same_padding_matches_xla(size, kernel, stride, pads):
    assert resnet._same_pads(size, kernel, stride) == pads


def test_plain_bn_refuses_data_parallel_worlds(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    module = resnet.ResNet(**dict(SMALL["basic_cifar"], num_classes=10)).train()
    with pytest.raises(NotImplementedError, match="sync-BN"):
        module(torch.zeros(2, 8, 8, 3))
