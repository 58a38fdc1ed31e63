"""The port's U-Net (``models/segmentation.py``) and the ConvTranspose rule
of ``convert.py`` against the JAX package, on the CPU.

Inputs come from numpy with a seed (the examples' ``synthetic_shapes`` for
training) and the JAX package's weights are converted by
``convert.load_variables``, at ``base_filters=8`` on 32 px, depth 2 and 3:

* float32 logits within 2e-5 of ``UNet.apply``;
* the loss and ``pixel_accuracy`` within 1e-6;
* five Adam 1e-3 steps on the example's batches of 8, the JAX package's
  ``SyncDataParallel`` on one CPU device against the port's: parameters
  within 1e-5;
* ``make_predict_fn`` equal to JAX's argmax wherever the top two logits
  differ by more than 1e-5;
* a bfloat16 forward (float32 parameters and logits) whose error against
  the float32 logits exceeds the JAX package's own bfloat16 forward's by at
  most 2^-7 as a norm;
* the traps of a flax → torch port: the ConvTranspose kernel must be
  flipped (an unflipped conversion fails the logits check), gelu is the
  tanh approximation, GroupNorm's epsilon is 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from tensorflowonspark_tpu import parallel
from tensorflowonspark_tpu.models import segmentation as jseg
from tensorflowonspark_tpu.train import SyncDataParallel as JaxSyncDataParallel
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.examples.segmentation.segmentation_spark import synthetic_shapes
from tensorflowonspark_tpu_torch.models import get_model, segmentation
from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

LOGIT_TOL = 2e-5
LOSS_TOL = 1e-6
PARAM_TOL = 1e-5
ARGMAX_GAP = 1e-5
BF16_NORM_TOL = 2.0 ** -7
SIZE, BASE, BATCH = 32, 8, 8


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module", params=[2, 3], ids=["depth2", "depth3"])
def models(request):
    """(depth, JAX module, its host variables, the port's module loaded
    with them)."""
    depth = request.param
    jmodel = jseg.create_model(num_classes=3, base_filters=BASE, depth=depth)
    variables = _np(jax.jit(jseg.make_init_fn(jmodel, image_size=SIZE))(jax.random.PRNGKey(0)))
    port = convert.load_variables(segmentation.create_model(num_classes=3, base_filters=BASE, depth=depth),
                                  variables)
    return depth, jmodel, variables, port


def _images(seed, n=4):
    return np.random.default_rng(seed).standard_normal((n, SIZE, SIZE, 3)).astype(np.float32)


def test_logits_match_the_jax_module(models):
    """Same weights (converted strictly), same NHWC inputs: SAME convs,
    GroupNorm, tanh gelu, VALID pools, the transposed convs and the skip
    concatenation agree."""
    _, jmodel, variables, port = models
    x = _images(1)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=LOGIT_TOL)
    assert np.abs(want).max() > 1.0  # logits of order 1


def test_loss_and_pixel_accuracy_match(models):
    _, jmodel, variables, port = models
    images, masks = synthetic_shapes(BATCH, SIZE, seed=3)
    jloss, jaux = jax.jit(jseg.make_loss_fn(jmodel))(variables["params"],
                                                      {"image": jnp.asarray(images), "mask": jnp.asarray(masks)})
    loss, aux = segmentation.make_loss_fn(port)(port, {"image": torch.from_numpy(images),
                                                       "mask": torch.from_numpy(masks)})
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_TOL
    assert abs(float(aux["pixel_accuracy"]) - float(jaux["pixel_accuracy"])) <= LOSS_TOL


def test_predict_matches_jax_argmax_where_decided(models):
    _, jmodel, variables, port = models
    images, _ = synthetic_shapes(BATCH, SIZE, seed=4)
    logits = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(images)))
    want = np.asarray(jseg.make_predict_fn(jmodel)(variables["params"], {"image": jnp.asarray(images)}))
    got = segmentation.make_predict_fn(port)(port, {"image": torch.from_numpy(images)}).numpy()
    top2 = np.sort(logits, -1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > ARGMAX_GAP
    assert got.shape == (BATCH, SIZE, SIZE) and decided.mean() > 0.99
    assert np.array_equal(got[decided], want[decided])


def test_adam_steps_match_the_jax_strategy():
    """Five ``adam(1e-3)`` steps at depth 2 through both packages'
    ``SyncDataParallel`` (the JAX one on one CPU device), on the example's
    own data and batches: ``synthetic_shapes(4 * 8, seed=0)`` taken 8 at a
    time, cycling. (Adam's first step is about ``sign(g)``: a 3×3 tap whose
    first gradient cancels to rounding noise, below Adam's epsilon, ends up
    to ~3e-5 apart; on 40 fresh images one of 29,643 weights did, and at
    depth 3 one of 121,195 read 1.3e-5.)"""
    jmodel = jseg.create_model(num_classes=3, base_filters=BASE, depth=2)
    variables = _np(jax.jit(jseg.make_init_fn(jmodel, image_size=SIZE))(jax.random.PRNGKey(0)))
    port = convert.load_variables(segmentation.create_model(num_classes=3, base_filters=BASE, depth=2), variables)
    jstrategy = JaxSyncDataParallel(parallel.build_mesh({"dp": 1}, devices=jax.devices()[:1]))
    tx = optax.adam(1e-3)
    jstate = jstrategy.create_state(lambda: variables, tx)
    jstep = jstrategy.compile_train_step(jseg.make_loss_fn(jmodel), tx, has_aux=True, donate=False)
    strategy = SyncDataParallel("cpu")
    optimizer = optim.adam(1e-3)
    state = strategy.create_state(lambda: port, optimizer)
    step = strategy.compile_train_step(segmentation.make_loss_fn(port), optimizer, has_aux=True)
    images, masks = synthetic_shapes(4 * BATCH, SIZE, seed=0)
    for i in range(5):
        sel = np.arange(i * BATCH, (i + 1) * BATCH) % len(images)
        batch = {"image": images[sel], "mask": masks[sel]}
        jstate, jmetrics = jstep(jstate, jstrategy.shard_batch(batch))
        state, metrics = step(state, strategy.shard_batch(batch))
        # relative, as the MNIST slice holds its training losses
        np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=LOSS_TOL)
    want = convert.convert_variables({"params": _np(jstate.params)}, port)
    for name, value in state.params.items():
        np.testing.assert_allclose(value.detach().numpy(), want[name].numpy(), atol=PARAM_TOL, err_msg=name)
    assert state.step == 5 and int(state.opt_state["count"]) == 5


def test_bf16_forward_keeps_f32_params_and_the_references_error():
    """``dtype=bfloat16``: float32 parameters and logits, and an error
    against the float32 logits no more than 2^-7 (as a norm) beyond the JAX
    package's own bfloat16 forward's. A whole bfloat16 U-Net is not held
    within 2^-7 of a reference directly: the JAX package's bfloat16 forward
    is itself ~1.3e-2 from its float32 one, and ~1.4e-2 from itself run
    eagerly instead of jitted."""
    jmodel = jseg.create_model(num_classes=3, base_filters=BASE, depth=2)
    variables = _np(jax.jit(jseg.make_init_fn(jmodel, image_size=SIZE))(jax.random.PRNGKey(0)))
    port = convert.load_variables(
        segmentation.create_model(num_classes=3, base_filters=BASE, depth=2, dtype=torch.bfloat16), variables)
    images, _ = synthetic_shapes(BATCH, SIZE, seed=5)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(images)))
    jbf16 = jseg.create_model(num_classes=3, base_filters=BASE, depth=2, dtype=jnp.bfloat16)
    ref = np.asarray(jax.jit(jbf16.apply)(variables, jnp.asarray(images)))
    got = port(torch.from_numpy(images))
    assert got.dtype == torch.float32 and all(p.dtype == torch.float32 for p in port.parameters())
    got = got.detach().numpy()

    def err(a):
        return float(np.linalg.norm(a - want) / np.linalg.norm(want))

    assert 0 < err(got) <= err(ref) + BF16_NORM_TOL


def test_conv_transpose_rule_flips_the_kernel(models):
    """``up<d>`` kernels ``[kh, kw, in, out]`` become ``[in, out, kh, kw]``
    flipped in both spatial axes; converted without the flip the logits
    miss the limit."""
    depth, jmodel, variables, port = models
    kernel = np.asarray(variables["params"]["up0"]["kernel"])
    weights = convert.convert_variables(variables, port)
    np.testing.assert_array_equal(weights["up0.weight"].numpy(), kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    unflipped = {k: v.clone() for k, v in weights.items()}
    for d in range(depth):
        k = np.asarray(variables["params"]["up{}".format(d)]["kernel"])
        unflipped["up{}.weight".format(d)] = torch.from_numpy(np.ascontiguousarray(k.transpose(2, 3, 0, 1)))
    wrong = segmentation.create_model(num_classes=3, base_filters=BASE, depth=depth)
    wrong.load_state_dict(unflipped)
    x = _images(2)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    assert np.abs(wrong(torch.from_numpy(x)).detach().numpy() - want).max() > 100 * LOGIT_TOL


def test_jax_variables_load_strictly(models):
    depth, _, variables, port = models
    assert set(convert.convert_variables(variables, port)) == set(port.state_dict())
    with pytest.raises(ValueError, match="shape"):
        convert.load_variables(segmentation.create_model(num_classes=3, base_filters=16, depth=depth), variables)


def test_gelu_is_the_tanh_approximation():
    """flax's ``nn.gelu`` defaults to the tanh form; torch's to erf, which
    reads ~4.7e-4 away."""
    x = np.linspace(-4, 4, 4001, dtype=np.float32)
    want = np.asarray(nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(F.gelu(torch.from_numpy(x), approximate="tanh").numpy(), want, atol=1e-6)
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4
    block = segmentation.ConvBlock(3, 8)
    x = torch.randn(2, 3, 6, 6, generator=torch.Generator().manual_seed(0))
    pre = F.group_norm(F.conv2d(x, block.Conv_0.weight, padding=1), 8, block.GroupNorm_0.weight,
                       block.GroupNorm_0.bias, 1e-6)
    got = block._layer(block.Conv_0, block.GroupNorm_0, x)
    assert torch.equal(got, F.gelu(pre, approximate="tanh"))
    assert not torch.allclose(got, F.gelu(pre), atol=1e-5)


def test_group_norm_eps_is_flax_default():
    """On activations whose group variance is near 1e-6, flax's epsilon
    (1e-6) and torch's default (1e-5) give visibly different outputs; the
    port's matches flax's."""
    x = (1e-3 * np.random.default_rng(6).standard_normal((2, 4, 4, 16))).astype(np.float32)
    gn = nn.GroupNorm(num_groups=8)
    variables = gn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(gn.apply(variables, jnp.asarray(x)))
    block = segmentation.ConvBlock(16, 16)
    assert block.GroupNorm_0.eps == segmentation.GROUP_EPS == 1e-6
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    def norm(eps):
        return F.group_norm(xt, 8, block.GroupNorm_0.weight, block.GroupNorm_0.bias, eps).permute(0, 2, 3, 1)

    np.testing.assert_allclose(norm(block.GroupNorm_0.eps).detach().numpy(), want, atol=1e-5)
    assert np.abs(norm(1e-5).detach().numpy() - want).max() > 1e-2


def test_registry_init_and_bundle(tmp_path):
    """``get_model("unet")``; flax's lecun-normal fan-in for convs and
    transposed convs alike; a bundle predicts what the module predicts."""
    from tensorflowonspark_tpu_torch.train import export

    model = get_model("unet", base_filters=BASE, depth=2)
    assert isinstance(model, segmentation.UNet)
    init = segmentation.make_init_fn(model, image_size=SIZE)
    a = {k: v.clone() for k, v in init(torch.Generator().manual_seed(0)).state_dict().items()}
    b = init(torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="channels"):
        segmentation.make_init_fn(model, channels=1)
    big = segmentation.UNet(base_filters=32, depth=4, generator=torch.Generator().manual_seed(1))
    assert float(big.enc3.Conv_1.weight.detach().std()) == pytest.approx(np.sqrt(1 / (9 * 256)), rel=0.05)
    # ConvTranspose2d [in, out, kh, kw]: fan-in is in x kh x kw
    assert float(big.up3.weight.detach().std()) == pytest.approx(np.sqrt(1 / (4 * 512)), rel=0.05)
    assert not big.up3.bias.any() and torch.equal(big.dec0.GroupNorm_1.weight, torch.ones(32))

    export.export_model(str(tmp_path), segmentation.bundle_builder(num_classes=3, base_filters=BASE, depth=2),
                        model.state_dict())
    predict_fn, params, model_state = export.load_model(str(tmp_path), device="cpu")
    images, _ = synthetic_shapes(3, SIZE, seed=7)
    out = predict_fn(params, model_state, {"image": images})
    want = segmentation.make_predict_fn(model)(model, {"image": torch.from_numpy(images)}).numpy()
    assert np.array_equal(out["mask"], want) and list(out["device"]) == ["cpu"] * 3
