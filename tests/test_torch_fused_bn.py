"""The port's fused BatchNorm (tensorflowonspark_tpu_torch.ops.fused_bn)
against the JAX package's Pallas kernels run in interpret mode.

Inputs come from numpy with a seed and go through both sides. On the CPU the
port's wrappers take their plain PyTorch versions; the Triton kernels
themselves are held against those plain versions on the card
(tests/test_torch_fused_bn_cuda.py and ``chip_smoke.py``). Tolerances are the JAX
package's own (tests/test_fused_bn.py): the two sides sum in a different
order, so statistics agree to float32 rounding, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from tensorflowonspark_tpu.ops import fused_bn as jax_bn
from tensorflowonspark_tpu_torch.ops import fused_bn


def _pair(arr, jdtype, tdtype):
    return jnp.asarray(arr, jnp.float32).astype(jdtype), torch.from_numpy(arr).to(tdtype)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("n_ch", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference_kernels(n_ch, dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 4, 4, n_ch)) * 2 + 1).astype(np.float32)
    gamma = rng.standard_normal(n_ch).astype(np.float32)
    beta = rng.standard_normal(n_ch).astype(np.float32)
    jx, tx = _pair(x, getattr(jnp, dtype), getattr(torch, dtype))

    jy, jmean, jvar = jax_bn.fused_batch_norm(
        jx, jnp.asarray(gamma), jnp.asarray(beta), block_r=16, interpret=True
    )
    ty, tmean, tvar = fused_bn.fused_batch_norm(tx, torch.from_numpy(gamma), torch.from_numpy(beta))
    assert ty.dtype == getattr(torch, dtype) and ty.shape == tx.shape
    # the reference's own tolerances (test_fused_bn.py:33-38): stats 5e-5 in
    # f32 and 5e-2 in bf16, y within 100x those
    tol = 5e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(tmean), np.asarray(jmean), atol=tol)
    np.testing.assert_allclose(_np(tvar), np.asarray(jvar), atol=tol)
    np.testing.assert_allclose(_np(ty), np.asarray(jy, np.float32), atol=tol * 100)


def test_gradients_match_reference_custom_vjp():
    """dx, dgamma, dbeta through the autograd.Function vs jax.grad through
    the reference's custom VJP, within 1e-4 (test_fused_bn.py:67)."""
    rng = np.random.default_rng(1)
    n_ch = 64
    x = rng.standard_normal((2, 4, 4, n_ch)).astype(np.float32)
    gamma = rng.standard_normal(n_ch).astype(np.float32)
    beta = rng.standard_normal(n_ch).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jax_loss(x, gamma, beta):
        y, _, _ = jax_bn.fused_batch_norm(x, gamma, beta, block_r=16, interpret=True)
        return jnp.sum(y * w)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta))
    y, mean, var = fused_bn.fused_batch_norm(tx, tg, tb)
    assert not mean.requires_grad and not var.requires_grad  # detached, as the reference
    (y * torch.from_numpy(w)).sum().backward()
    for got, ref, name in zip((tx.grad, tg.grad, tb.grad), want, ("dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-4, err_msg=name)


def _module_pair(x, n_ch):
    ref = jax_bn.FusedBatchNorm(momentum=0.9, interpret=True, block_r=32)
    rvars = ref.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False)
    port = fused_bn.FusedBatchNorm(n_ch, momentum=0.9, eps=1e-5)
    return ref, rvars, port


def test_module_matches_reference_module_and_running_stats():
    """y and the running statistics (momentum 0.9 on the biased variance)
    against the reference FusedBatchNorm: mean 1e-5, var 1e-4, eval 1e-4
    (test_fused_bn.py:83-102)."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 8, 8, 64)) + 0.5).astype(np.float32)
    ref, rvars, port = _module_pair(x, 64)
    ry, rmut = ref.apply(rvars, jnp.asarray(x), use_running_average=False, mutable=["batch_stats"])
    port.train()
    ty = port(torch.from_numpy(x))
    np.testing.assert_allclose(_np(ty), np.asarray(ry), atol=1e-4)
    np.testing.assert_allclose(_np(port.running_mean), np.asarray(rmut["batch_stats"]["mean"]), atol=1e-5)
    np.testing.assert_allclose(_np(port.running_var), np.asarray(rmut["batch_stats"]["var"]), atol=1e-4)

    re = ref.apply({"params": rvars["params"], "batch_stats": rmut["batch_stats"]},
                   jnp.asarray(x), use_running_average=True)
    port.eval()
    np.testing.assert_allclose(_np(port(torch.from_numpy(x))), np.asarray(re), atol=1e-4)


def test_odd_rows_match_reference_fallback_branch():
    """175 rows have no power-of-two block divisor: the reference falls back
    to plain XLA math; the port runs its usual path at any row count. Same
    forward and running stats (1e-4/1e-5) and gradients (1e-3) as the
    reference's fallback (test_fused_bn.py:127-150)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((7, 5, 5, 32)) * 1.5 + 0.25).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    ref = jax_bn.FusedBatchNorm(momentum=0.9, interpret=True, block_r=16)
    rvars = ref.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False)
    port = fused_bn.FusedBatchNorm(32).train()

    def ref_loss(params):
        y, mut = ref.apply({"params": params, "batch_stats": rvars["batch_stats"]},
                           jnp.asarray(x), use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut)

    (_, (ry, rmut)), rgrads = jax.value_and_grad(ref_loss, has_aux=True)(rvars["params"])
    ty = port(torch.from_numpy(x))
    (ty * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(ty), np.asarray(ry), atol=1e-4)
    np.testing.assert_allclose(_np(port.running_mean), np.asarray(rmut["batch_stats"]["mean"]), atol=1e-5)
    np.testing.assert_allclose(_np(port.running_var), np.asarray(rmut["batch_stats"]["var"]), atol=1e-4)
    np.testing.assert_allclose(_np(port.weight.grad), np.asarray(rgrads["scale"]), atol=1e-3)
    np.testing.assert_allclose(_np(port.bias.grad), np.asarray(rgrads["bias"]), atol=1e-3)


def test_plain_batchnorm_matches_flax_batchnorm():
    """bn_impl='flax' (autograd through the plain versions) against
    flax.linen.BatchNorm: forward, running stats and dx within 1e-4."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 4, 4, 16)) * 1.3 - 0.2).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    ref = nn.BatchNorm(momentum=0.9, epsilon=1e-5, use_running_average=False)
    rvars = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def ref_loss(x):
        y, mut = ref.apply(rvars, x, mutable=["batch_stats"])
        return jnp.sum(y * w), mut

    (_, rmut), rdx = jax.value_and_grad(ref_loss, has_aux=True)(jnp.asarray(x))
    port = fused_bn.BatchNorm(16).train()
    tx = torch.from_numpy(x).requires_grad_()
    (port(tx) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), np.asarray(rdx), atol=1e-4)
    np.testing.assert_allclose(_np(port.running_var), np.asarray(rmut["batch_stats"]["var"]), atol=1e-4)


def test_cpu_tensors_take_the_plain_versions_without_counting():
    fused_bn.reset_launch_counts()
    x = torch.randn(64, 16)
    y, _, _ = fused_bn.fused_batch_norm(x.requires_grad_(), torch.ones(16), torch.zeros(16))
    y.sum().backward()
    assert fused_bn.launch_counts() == {fn.__name__: 0 for fn in fused_bn.KERNELS}


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty(8, 4, device="meta")
    with pytest.raises(RuntimeError, match="run on CUDA"):
        fused_bn.bn_stats(x)


@pytest.mark.parametrize("rows", [1, 31, 175, 3136, 12544, 802816])
@pytest.mark.parametrize("n_ch", [3, 64, 1024, 2048])
def test_split_geometry_covers_every_row_once(rows, n_ch):
    """The split-row reductions' launch geometry: whole row tiles per split,
    and the splits tile [0, R) exactly."""
    block_r, block_c = fused_bn._blocks(n_ch)
    assert block_r * block_c == fused_bn._TILE and block_c >= min(n_ch, 16)
    n_splits, per = fused_bn._splits(rows, n_ch, block_r, block_c)
    assert per % block_r == 0
    assert (n_splits - 1) * per < rows <= n_splits * per
