"""Pipeline parallelism on the port, held against the JAX package's
``parallel/pipeline_parallel.py`` on the same numpy inputs.

The cases of the JAX package's ``tests/test_model_axes.py::TestPipeline1F1B``
and ``tests/test_parallel.py::TestPipelineParallel``:

* ``schedule_1f1b`` equal to the JAX package's, with the 1F1B stash bound,
  and the port's stash count read at runtime (``last_stats["stash_peak"]``);
* ``Pipeline1F1B`` on ``devices=["cpu"] * 4``, overlap on and off: loss
  within 1e-6 and per-stage gradients within 1e-5 of the JAX package's
  ``Pipeline1F1B`` (and of the sequential composition), on and off bitwise
  equal; the equal-weights case (one stage, M microbatches); stages of 2
  narrow LM ``Block``\\ s (plain attention) against the JAX pipeline of the
  same blocks, converted;
* ``pipeline_apply`` in a 4-rank gloo world (``tests/torch_world_util.py``)
  at ``{"pp": 4}`` and ``{"dp": 2, "pp": 2}`` (``batch_axis="dp"``):
  forward within 1e-6 and each stage's gradient within 1e-5 of the JAX
  package's ``pipeline_apply`` on a CPU mesh of as many devices; the
  one-process form (``pipeline_apply_local``) too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tensorflowonspark_tpu import parallel as jparallel
from tensorflowonspark_tpu.models import transformer as jtransformer
from tensorflowonspark_tpu.parallel.pipeline_parallel import Pipeline1F1B as JPipeline1F1B
from tensorflowonspark_tpu_torch import convert, obs
from tensorflowonspark_tpu_torch import parallel
from tensorflowonspark_tpu_torch.examples.sync_dp_check import pp_stage, stage_params
from tensorflowonspark_tpu_torch.models import transformer
from tensorflowonspark_tpu_torch.parallel import (Pipeline1F1B, module_stage, pipeline_apply_local,
                                                  schedule_1f1b, split_microbatches, stack_stage_params)

from torch_world_util import run_world, tanh_stage

LOSS_TOL, GRAD_TOL = 1e-6, 1e-5
FWD_TOL = 1e-6
#: the narrow LM whose blocks make the LM stages: 2 stages of 2 blocks
LM_CFG = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4, d_ff=64, dtype="float32", attention="plain")


def _tanh_params(n_stages=4, width=16, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((width, width)) / 4.0).astype(np.float32) for _ in range(n_stages)]


def _jstage(p, x):
    return jnp.tanh(x @ p["w"])


def _jloss(y, t):
    return jnp.mean((y - t) ** 2)


def _loss(y, t):
    return ((y - t) ** 2).mean()


@pytest.mark.parametrize("n_stages,n_micro", [(4, 6), (4, 8), (3, 2), (1, 4)])
def test_schedule_matches_the_jax_package_and_bounds_its_stash(n_stages, n_micro):
    from tensorflowonspark_tpu.parallel.pipeline_parallel import schedule_1f1b as jschedule

    for s in range(n_stages):
        ops = schedule_1f1b(s, n_stages, n_micro)
        assert ops == jschedule(s, n_stages, n_micro)
        assert [m for op, m in ops if op == "F"] == list(range(n_micro))
        assert [m for op, m in ops if op == "B"] == list(range(n_micro))
        for m in range(n_micro):
            assert ops.index(("F", m)) < ops.index(("B", m))
        depth = peak = 0
        for op, _m in ops:
            depth += 1 if op == "F" else -1
            peak = max(peak, depth)
        assert peak == min(n_stages - s, n_micro)


def _jax_1f1b(weights, x, t, n_micro, overlap):
    pipe = JPipeline1F1B(_jstage, [{"w": jnp.asarray(w)} for w in weights], _jloss, overlap=overlap)
    try:
        loss, grads = pipe.step(jparallel.split_microbatches(jnp.asarray(x), n_micro),
                                jparallel.split_microbatches(jnp.asarray(t), n_micro))
        return float(loss), [np.asarray(g["w"]) for g in grads]
    finally:
        pipe.close()


def _port_1f1b(weights, x, t, n_micro, overlap):
    pipe = Pipeline1F1B(tanh_stage, [{"w": torch.as_tensor(w)} for w in weights], _loss,
                        devices=["cpu"] * len(weights), overlap=overlap)
    try:
        loss, grads = pipe.step(split_microbatches(torch.as_tensor(x), n_micro),
                                split_microbatches(torch.as_tensor(t), n_micro))
        return loss, [g["w"] for g in grads], dict(pipe.last_stats)
    finally:
        pipe.close()


@pytest.fixture(scope="module")
def tanh_case():
    if jax.device_count() < 4:
        pytest.skip("needs 4 cpu devices")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, 16)).astype(np.float32)
    t = rng.standard_normal((32, 16)).astype(np.float32)
    return _tanh_params(), x, t


@pytest.mark.parametrize("overlap", [True, False])
def test_1f1b_loss_and_grads_match_the_jax_package(tanh_case, overlap):
    weights, x, t = tanh_case
    ref_loss, ref_grads = _jax_1f1b(weights, x, t, 8, overlap)
    loss, grads, stats = _port_1f1b(weights, x, t, 8, overlap)
    assert abs(float(loss) - ref_loss) <= LOSS_TOL
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), want, atol=GRAD_TOL)
    # the sequential composition under plain autograd
    ws = [torch.as_tensor(w).clone().requires_grad_() for w in weights]
    y = torch.as_tensor(x)
    for w in ws:
        y = tanh_stage({"w": w}, y)
    seq = _loss(y, torch.as_tensor(t))
    assert abs(float(loss) - float(seq.detach())) <= LOSS_TOL
    for got, want in zip(grads, torch.autograd.grad(seq, ws)):
        torch.testing.assert_close(got, want, atol=GRAD_TOL, rtol=0)
    assert stats["n_stages"] == 4 and stats["n_microbatches"] == 8
    assert 0.0 <= stats["bubble_fraction"] <= 1.0
    assert 0.0 <= stats["overlap_fraction"] <= 1.0
    assert stats["comm_busy_s"] > 0.0
    assert stats["bubble_fraction_theory"] == pytest.approx(3 / 19)
    # 1F1B's memory contract, counted at runtime: at most P - s stashed
    # inputs on stage s (the last stage fuses its pairs and stashes none)
    assert stats["stash_peak"] == [4, 3, 2, 0]
    assert obs.gauge("pipeline_bubble_fraction").value == pytest.approx(stats["bubble_fraction"])


def test_1f1b_overlap_on_and_off_are_bitwise(tanh_case):
    weights, x, t = tanh_case
    on = _port_1f1b(weights, x, t, 8, True)
    off = _port_1f1b(weights, x, t, 8, False)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(on[1], off[1]))


def test_grad_accumulation_weights_microbatches_equally():
    # 1 stage, M microbatches: grads equal grad(mean-of-means loss), as the
    # JAX package's pipeline gives them
    weights = _tanh_params(n_stages=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    t = rng.standard_normal((8, 16)).astype(np.float32)
    ref_loss, ref_grads = _jax_1f1b(weights, x, t, 4, False)
    loss, grads, stats = _port_1f1b(weights, x, t, 4, False)
    assert abs(float(loss) - ref_loss) <= LOSS_TOL
    np.testing.assert_allclose(grads[0].numpy(), ref_grads[0], atol=GRAD_TOL)
    assert stats["stash_peak"] == [0]


def test_lm_block_stages_match_the_jax_pipeline():
    """Stages of 2 narrow LM blocks (plain attention), the final norm, head
    and cross-entropy closing the last: the port's ``Pipeline1F1B`` against
    the JAX package's on the same weights (converted), overlap on."""
    model = jtransformer.create_model(**LM_CFG)
    params = jax.tree.map(np.asarray, jax.jit(jtransformer.make_init_fn(model, sample_len=16))(
        jax.random.PRNGKey(0))["params"])
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, 64, (4, 17)).astype(np.int32)
    x = params["embed"]["embedding"][tokens[:, :-1]].astype(np.float32)  # [4, 16, 32]
    targets = tokens[:, 1:]
    stages = [{"b0": params["layer_{}".format(2 * i)], "b1": params["layer_{}".format(2 * i + 1)]}
              for i in range(2)]
    cfg = model.cfg
    pos = jnp.broadcast_to(jnp.arange(16)[None], (2, 16))

    def jstage(p, h):
        for name in ("b0", "b1"):
            h = jtransformer.Block(cfg).apply({"params": p[name]}, h, pos)
        return h

    def jloss(h, t):
        import flax.linen as nn
        import optax

        h = nn.RMSNorm(dtype=cfg.compute_dtype).apply({"params": params["ln_f"]}, h)
        logits = (h @ params["lm_head"]["kernel"]).astype(jnp.float32)
        return optax.softmax_cross_entropy_with_integer_labels(logits, t).mean()

    jpipe = JPipeline1F1B(jstage, [jax.tree.map(jnp.asarray, s) for s in stages], jloss)
    try:
        jl, jg = jpipe.step(jparallel.split_microbatches(jnp.asarray(x), 2),
                            jparallel.split_microbatches(jnp.asarray(targets), 2))
    finally:
        jpipe.close()

    whole = convert.load_variables(transformer.create_model(**LM_CFG), {"params": params})
    stage_fn = module_stage(pp_stage(whole.cfg, 2))
    port_stages = [stage_params(whole, [2 * i, 2 * i + 1]) for i in range(2)]

    def loss_fn(h, t):
        logits = whole.lm_head(whole.ln_f(h)).float()
        return torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]), t.long().reshape(-1))

    pipe = Pipeline1F1B(stage_fn, port_stages, loss_fn, devices=["cpu"] * 2)
    try:
        loss, grads = pipe.step(split_microbatches(torch.as_tensor(x), 2),
                                split_microbatches(torch.as_tensor(targets), 2))
    finally:
        pipe.close()
    assert abs(float(loss) - float(jl)) <= LOSS_TOL
    for got, want in zip(grads, jg):
        want = convert.convert_variables({"params": jax.tree.map(np.asarray, want)})
        assert set(got) == set(want)
        for name in got:
            torch.testing.assert_close(got[name], want[name], atol=GRAD_TOL, rtol=0, msg=name)


# -- GPipe over pp ----------------------------------------------------------

PP_CASES = {"pp4": ({"pp": 4}, None), "dp2_pp2": ({"dp": 2, "pp": 2}, "dp")}


def _pp_inputs(n_stages, seed=0, d=8, rows=16):
    rng = np.random.default_rng(seed)
    w = np.stack([(rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32) for _ in range(n_stages)])
    x = rng.standard_normal((rows, d)).astype(np.float32)
    return w, x.reshape(8, rows // 8, d)


def _jax_gpipe(axes, batch_axis, w, mb):
    n = int(np.prod(list(axes.values())))
    if jax.device_count() < n:
        pytest.skip("needs {} cpu devices".format(n))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(tuple(axes.values())), tuple(axes))

    def loss(stacked):
        out = jparallel.pipeline_apply(_jstage, stacked, jnp.asarray(mb), mesh, batch_axis=batch_axis)
        return jnp.sum(out ** 2), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))({"w": jnp.asarray(w)})
    return np.asarray(out), np.asarray(g["w"])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = {}
    for name, (axes, batch_axis) in PP_CASES.items():
        w, mb = _pp_inputs(axes["pp"])
        cases[name] = (axes, batch_axis, w, mb)
    return run_world(tmp_path_factory.mktemp("pp"), {"pipeline": ("job_pipeline", dict(cases=cases))}), cases


@pytest.mark.parametrize("name", sorted(PP_CASES))
def test_pipeline_apply_matches_the_jax_package(world, name):
    results, cases = world
    axes, batch_axis, w, mb = cases[name]
    ref_out, ref_grad = _jax_gpipe(axes, batch_axis, w, mb)
    stages = set()
    for rank in results:
        got = rank["pipeline"][name]
        np.testing.assert_allclose(got["y"].numpy(), ref_out, atol=FWD_TOL)
        # each stage's gradient once: the JAX package's row, not x P or x 0
        np.testing.assert_allclose(got["grad_row"].numpy(), ref_grad[got["stage"]], atol=GRAD_TOL)
        assert got["other_rows_zero"]
        stages.add(got["stage"])
    assert stages == set(range(axes["pp"]))


def test_pipeline_apply_equals_the_sequential_composition(world):
    results, cases = world
    _, _, w, mb = cases["pp4"]
    y = torch.as_tensor(mb)
    ws = torch.as_tensor(w).clone().requires_grad_()
    for i in range(4):
        y = tanh_stage({"w": ws[i]}, y)
    (g,) = torch.autograd.grad((y ** 2).sum(), [ws])
    for rank in results:
        got = rank["pipeline"]["pp4"]
        torch.testing.assert_close(got["y"], y.detach(), atol=FWD_TOL, rtol=0)
        torch.testing.assert_close(got["grad_row"], g[got["stage"]], atol=GRAD_TOL, rtol=0)


def test_pipeline_apply_local_matches_the_jax_package():
    """The one-process form (all 4 members in order) against the JAX
    package's GPipe over a 4-device ``pp`` mesh."""
    w, mb = _pp_inputs(4, seed=5)
    ref_out, ref_grad = _jax_gpipe({"pp": 4}, None, w, mb)
    stacked = stack_stage_params([{"w": torch.as_tensor(wi)} for wi in w])
    stacked["w"].requires_grad_()
    out = pipeline_apply_local(tanh_stage, stacked, torch.as_tensor(mb))
    (g,) = torch.autograd.grad((out ** 2).sum(), [stacked["w"]])
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=FWD_TOL)
    np.testing.assert_allclose(g.numpy(), ref_grad, atol=GRAD_TOL)


def test_split_and_merge_microbatches_as_the_jax_package():
    x = np.arange(24, dtype=np.float32).reshape(12, 2)
    got = split_microbatches(torch.as_tensor(x), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jparallel.split_microbatches(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(parallel.merge_microbatches(got).numpy(), x)
    with pytest.raises(ValueError, match="not divisible into 5 microbatches"):
        split_microbatches(torch.as_tensor(x), 5)


def test_1f1b_needs_a_device_a_stage():
    with pytest.raises(ValueError, match="3 pipeline stages need 3 devices; have 2"):
        Pipeline1F1B(tanh_stage, [{"w": torch.zeros(2, 2)}] * 3, _loss, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="at least one pipeline stage"):
        Pipeline1F1B(tanh_stage, [], _loss, devices=["cpu"])


@pytest.mark.parametrize("name", ["HostAllReduceGroup", "pipeline_apply", "Pipeline1F1B", "schedule_1f1b",
                                  "stack_stage_params", "split_microbatches", "merge_microbatches"])
def test_formerly_refused_names_resolve(name):
    from tensorflowonspark_tpu_torch.parallel import hostreduce, pipeline_parallel

    got = getattr(parallel, name)
    assert got is getattr(hostreduce if name == "HostAllReduceGroup" else pipeline_parallel, name)
    assert name in dir(parallel)
