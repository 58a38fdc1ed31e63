"""The port's fused BatchNorm (tensorflowonspark_tpu_torch.ops.fused_bn)
against the JAX package's Pallas kernels run in interpret mode.

Inputs come from numpy with a seed and go through both sides. On the CPU the
port's wrappers take their plain PyTorch versions; the Triton kernels
themselves are held against those plain versions on the card
(tests/test_torch_fused_bn_cuda.py and ``chip_smoke.py``). Tolerances are the JAX
package's own (tests/test_fused_bn.py): the two sides sum in a different
order, so statistics agree to float32 rounding, not bit for bit.
"""

import os

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_stats_gradient_is_the_f32_formula_without_an_f64_copy(dtype):
    """bn_stats_plain's gradient equals autograd's through the f32 formula
    (Σx/R, Σx²/R − mean²) within 1e-6 of its largest element, a clamped var
    passes none, and autograd keeps no f64 tensor for the backward."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal((300, 8)) * 1.5 + 0.3).astype(np.float32)).to(dtype)
    x[:, 5] = 0.75  # a constant channel: var is 0 in both
    g_mean, g_var = (torch.from_numpy(rng.standard_normal(8).astype(np.float32)) for _ in range(2))
    saved = []
    tx = x.clone().requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.dtype) or t, lambda t: t):
        mean, var = fused_bn.bn_stats_plain(tx)
    ((mean * g_mean).sum() + (var * g_var).sum()).backward()
    assert saved and torch.float64 not in saved
    rx = x.clone().requires_grad_()
    xf = rx.float()
    rmean = xf.sum(0) / 300.0
    rvar = torch.clamp_min(xf.square().sum(0) / 300.0 - rmean * rmean, 0.0)
    ((rmean * g_mean).sum() + (rvar * g_var).sum()).backward()
    want = rx.grad.float()
    np.testing.assert_allclose(_np(tx.grad.float()), _np(want), atol=1e-6 * float(want.abs().max()))
    np.testing.assert_allclose(_np(mean), _np(rmean.detach()), atol=1e-6)
    np.testing.assert_allclose(_np(var), _np(rvar.detach()), atol=1e-5)


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
    """The reductions' launch geometry, for each kernel (one or two inputs),
    dtype and load path: the strips cover the channels, every row lies in
    exactly one split (the last one ragged where R demands), each CTA reads
    at least the minimum unless one split holds every row, the grid is
    capped at two CTAs an SM, and the finisher's threads cover the strip."""
    for n_inputs in (1, 2):
        for elem_size, vec in ((2, True), (4, True), (2, False), (4, False)):
            g = fused_bn.reduce_geometry(rows, n_ch, elem_size, n_inputs, vec)
            assert g.per_thread == (16 // elem_size if vec else 1)
            assert g.lanes & (g.lanes - 1) == 0 and g.lanes <= (8 if vec else 32)
            assert g.width == g.lanes * g.per_thread and g.width * elem_size <= 128
            assert (g.strips - 1) * g.width < n_ch <= g.strips * g.width
            assert (g.splits - 1) * g.rows_per_split < rows <= g.splits * g.rows_per_split
            last = rows - (g.splits - 1) * g.rows_per_split
            assert (last == g.rows_per_split) == (rows % g.rows_per_split == 0)
            split_bytes = g.rows_per_split * min(g.width, n_ch) * elem_size * n_inputs
            assert g.splits == 1 or split_bytes >= fused_bn._MIN_CTA_BYTES
            assert g.splits == 1 or g.strips * g.splits <= 2 * fused_bn.H100_SMS
            assert g.splits <= 65535
            units = g.width // (2 if vec else 1)
            assert g.runs * units == fused_bn._THREADS


def _split_order_sum(a, geom):
    """A split-and-finish sum as the kernels form it: each split of ``geom``
    summed in f64, the partials added in the finisher's order, the total
    rounded to f32 once."""
    return fused_bn.finish_plain(fused_bn.split_sums_plain(a, geom), geom).float()


def _split_order_stats(x2d, geom):
    """A twin of ``bn_stats_kernel``'s arithmetic on the CPU: Σx and Σx² of
    each split of ``geom``, the partials added in the finisher's order, and
    the reference's formula."""
    xd = x2d.double()
    return fused_bn.stats_from_sums(_split_order_sum(xd, geom), _split_order_sum(xd * xd, geom),
                                    float(x2d.shape[0]))


def _split_order_bwd_reduce(x2d, dy2d, mean, var, eps, geom):
    """A twin of ``bn_bwd_reduce_kernel``'s arithmetic on the CPU:
    ``(dgamma, dbeta)`` of each split, added in the finisher's order."""
    dyf = dy2d.float()
    xhat = (x2d.float() - mean) * torch.rsqrt(var + eps)
    return _split_order_sum(dyf * xhat, geom), _split_order_sum(dyf, geom)


def _twin_geometry(rows, n_ch, n_inputs):
    """The geometry the kernels take for a 16-byte aligned f32 operand."""
    return fused_bn.reduce_geometry(rows, n_ch, 4, n_inputs, n_ch * 4 % 16 == 0)


@pytest.mark.parametrize("rows", [3136, 12544])
@pytest.mark.parametrize("n_ch", [3, 64])
def test_split_order_twin_matches_reference_kernels(rows, n_ch):
    """R that a power-of-two block divides: the twin of the reductions'
    split-and-finish order against ``_bn_stats`` and the ``_fused_bn_2d``
    backward in interpret mode, at the JAX package's own tolerances:
    statistics 5e-5, dgamma/dbeta 1e-4 (the reference's f32 sums of
    thousands of values against correctly rounded ones)."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((rows, n_ch)) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal((rows, n_ch)).astype(np.float32)
    gamma = rng.standard_normal(n_ch).astype(np.float32)
    beta = rng.standard_normal(n_ch).astype(np.float32)
    eps, block = 1e-5, jax_bn._pick_block(rows, jax_bn.DEFAULT_BLOCK_R)
    jmean, jvar = jax_bn._bn_stats(jnp.asarray(x), block, True)
    _, vjp = jax.vjp(lambda a, g, b: jax_bn._fused_bn_2d(a, g, b, eps, block, True)[0],
                     jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    _, jdgamma, jdbeta = vjp(jnp.asarray(dy))

    tx, tdy = torch.from_numpy(x), torch.from_numpy(dy)
    g1, g2 = _twin_geometry(rows, n_ch, 1), _twin_geometry(rows, n_ch, 2)
    assert n_ch == 3 or (g1.splits > 1 and g2.splits > 1)  # the split order is exercised
    mean, var = _split_order_stats(tx, g1)
    dgamma, dbeta = _split_order_bwd_reduce(tx, tdy, mean, var, eps, g2)
    for got, ref, tol in ((mean, jmean[0], 5e-5), (var, jvar[0], 5e-5),
                          (dgamma, jdgamma, 1e-4), (dbeta, jdbeta, 1e-4)):
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=tol)


@pytest.mark.parametrize("rows", [175, 3143])
@pytest.mark.parametrize("n_ch", [3, 64])
def test_split_order_twin_matches_reference_fallback_branch(rows, n_ch):
    """Ragged R, which no power-of-two block divides: Pallas would pad the
    last block with garbage, so the reference's module takes its plain XLA
    fallback; the twin of the reductions' order against that branch's
    running statistics (momentum 0.9 from mean 0 and var 1) and its
    scale/bias gradients, 5e-5 and 1e-4, as
    ``test_odd_rows_match_reference_fallback_branch`` holds the module."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((rows, 1, 1, n_ch)) * 1.5 + 0.25).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    ref = jax_bn.FusedBatchNorm(momentum=0.9, interpret=True, block_r=16)
    rvars = ref.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False)

    def ref_loss(params):
        y, mut = ref.apply({"params": params, "batch_stats": rvars["batch_stats"]},
                           jnp.asarray(x), use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * w), mut

    (_, rmut), rgrads = jax.value_and_grad(ref_loss, has_aux=True)(rvars["params"])
    tx, tdy = torch.from_numpy(x.reshape(rows, n_ch)), torch.from_numpy(w.reshape(rows, n_ch))
    g1, g2 = _twin_geometry(rows, n_ch, 1), _twin_geometry(rows, n_ch, 2)
    mean, var = _split_order_stats(tx, g1)
    dgamma, dbeta = _split_order_bwd_reduce(tx, tdy, mean, var, 1e-5, g2)
    pairs = ((0.1 * mean, rmut["batch_stats"]["mean"], 5e-5),
             (0.9 + 0.1 * var, rmut["batch_stats"]["var"], 5e-5),
             (dgamma, rgrads["scale"], 1e-4), (dbeta, rgrads["bias"], 1e-4))
    for got, want, tol in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=tol)


def test_finish_plain_adds_runs_of_splits_in_order():
    """The finisher's mirror on integers (exact in f64): every split counted
    once, whatever the number of runs."""
    for splits in (1, 5, 16, 17, 264):
        geom = fused_bn.reduce_geometry(splits * 4096, 64, 2, 1, True)._replace(splits=splits)
        partials = torch.arange(splits, dtype=torch.float64)[:, None].repeat(1, 3)
        assert fused_bn.finish_plain(partials, geom).tolist() == [splits * (splits - 1) / 2] * 3


def test_kernel_resources_reads_both_reductions_from_the_ptxas_log(tmp_path):
    """The build report's parser, on entry names as ``nvcc`` mangles the two
    reductions' instances (dtype, load path)."""
    log = tmp_path / "fused_bn.log"
    log.write_text(
        "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__4f1ff018_11_fused_bn_cu_0ada14cd15"
        "bn_stats_kernelI13__nv_bfloat16Lb1EEEvPKT_iiiiPdPjPfS6_' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 102 registers, used 1 barriers, 12289 bytes smem\n"
        "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__4f1ff018_11_fused_bn_cu_0ada14cd20"
        "bn_bwd_reduce_kernelI6__halfLb0EEEvPKT_S3_PKfS5_fiiiiPdPjPfS7_' for 'sm_90a'\n"
        "    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 1 barriers, 8196 bytes smem\n"
        "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__4f1ff018_11_fused_bn_cu_0ada14cd15"
        "bn_stats_kernelIfLb1EEEvPKT_iiiiPdPjPfS5_' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 76 registers, used 1 barriers, 12292 bytes smem\n"
    )
    assert fused_bn.kernel_resources(str(log)) == [
        {"kernel": "bn_stats_kernel", "dtype": "bfloat16", "vec": True, "registers": 102,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "bn_bwd_reduce_kernel", "dtype": "float16", "vec": False, "registers": 32,
         "spill_stores": 4, "spill_loads": 8},
        {"kernel": "bn_stats_kernel", "dtype": "float32", "vec": True, "registers": 76,
         "spill_stores": 0, "spill_loads": 0},
    ]


def test_each_cuda_source_builds_into_a_library_named_after_it(tmp_path):
    """``build/cuda/<stem>_<hash>.so``: the hash follows the source's bytes,
    so an edited source never loads a stale build."""
    from tensorflowonspark_tpu_torch.ops import cuda_build

    src = tmp_path / "fused_bn.cu"
    src.write_text("// one\n")
    first = cuda_build.library_path(str(src), str(tmp_path / "out"))
    assert first.startswith(str(tmp_path / "out" / "fused_bn_")) and first.endswith(".so")
    assert len(os.path.basename(first)) == len("fused_bn_") + 16 + len(".so")
    src.write_text("// two\n")
    assert cuda_build.library_path(str(src), str(tmp_path / "out")) != first
    assert cuda_build.library_path(fused_bn.SOURCE).startswith(
        os.path.join(cuda_build.BUILD_DIR, "fused_bn_"))


def test_vector_path_needs_16_byte_aligned_bases_and_rows():
    """The reductions take 16-byte loads only when every operand's base and
    row pitch are multiples of 16 bytes; anything else takes the scalar path."""
    x = torch.zeros(8, 64, dtype=torch.bfloat16)
    assert x.data_ptr() % 16 == 0 and fused_bn._vector_path(x)
    assert not fused_bn._vector_path(torch.zeros(8 * 37, dtype=torch.bfloat16).view(8, 37))
    assert not fused_bn._vector_path(x, torch.zeros(8 * 64 + 1, dtype=torch.bfloat16)[1:].view(8, 64))
    assert fused_bn._vector_path(torch.zeros(8, 4)) and not fused_bn._vector_path(torch.zeros(8, 3))
