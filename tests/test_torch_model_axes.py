"""Tensor parallelism and rematerialization on the port: the cases of the
JAX package's ``tests/test_model_axes.py::TestTensorParallel`` in a gloo
world of the port on the CPU.

TP is a layout, not a different network. The JAX package's replicated
transformer (vocab 64, d_model 32, 2 layers, 4 heads, d_ff 64, f32) runs in
the test process; one 4-rank world (``testing.join_cpu_world``) builds the
port's model on meshes over its ranks (``create_model(mesh=...)`` from
the JAX model's weights, converted and cut to each rank's blocks) and
holds, against it: the packed batch's logits on ``{"dp": 2, "tp": 2}``,
``{"tp": 4}`` and ``{"dp": 1, "fsdp": 2, "tp": 2}`` (where the ZeRO-3
overlay shards what tp leaves) within 2e-5, the JAX test's tolerance; one
AdamW step's loss and parameters within 1e-5; the gradients of the
parameters no model axis splits bitwise equal on every rank; the
``tp_params_sharded`` gauge at 13. The same world saves checkpoints under
``dp × tp`` and ``dp`` and reshards each onto the other (and onto
``dp × fsdp × tp``), bitwise, and checks each gradient-carrying collective
against single-process autograd. The strategy's three errors and the
degrade of undersized dims need no world (plan meshes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu.models import transformer as jtransformer
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.models import transformer
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
from tensorflowonspark_tpu_torch.train import SyncDataParallel

from torch_world_util import run_world

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64, dtype="float32", attention="plain")
MESHES = {"dp2_tp2": ({"dp": 2, "tp": 2}, False), "tp4": ({"tp": 4}, False),
          "dp1_fsdp2_tp2": ({"dp": 1, "fsdp": 2, "tp": 2}, True)}


def _packed_batch(rows=8, l=24, seed=3):
    """The JAX test's packed ``[rows, l]`` batch: two sequences (ids 1, 2)
    plus a pad tail."""
    rng = np.random.default_rng(seed)
    s1 = rng.integers(3, 64, 11).astype(np.int32)
    s2 = rng.integers(3, 64, 7).astype(np.int32)
    tokens, seg, pos = (np.zeros((rows, l), np.int32) for _ in range(3))
    tokens[:, :11], seg[:, :11], pos[:, :11] = s1, 1, np.arange(11)
    tokens[:, 11:18], seg[:, 11:18], pos[:, 11:18] = s2, 2, np.arange(7)
    return {"tokens": tokens, "segment_ids": seg, "positions": pos}


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), jax.device_get(tree))


def _jax_params(**over):
    model = jtransformer.create_model(**dict(CFG, **over))
    return model, _np(jax.jit(jtransformer.make_init_fn(model, sample_len=16))(jax.random.PRNGKey(0))["params"])


def _jax_logits(model, params, batch):
    return np.asarray(jax.jit(lambda p, t, ps, sg: model.apply({"params": p}, t, positions=ps, segment_ids=sg))(
        params, jnp.asarray(batch["tokens"]), jnp.asarray(batch["positions"]), jnp.asarray(batch["segment_ids"])))


def _jax_step(model, params, batch, lr=1e-3):
    """One replicated AdamW step of the JAX package: loss and the new
    parameters under the port's names."""
    tx = optax.adamw(lr)
    (loss, _), grads = jax.jit(jax.value_and_grad(jtransformer.make_loss_fn(model), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    updates, _ = tx.update(grads, tx.init(params), params)
    return float(loss), convert.convert_variables({"params": _np(optax.apply_updates(params, updates))})


@pytest.fixture(scope="module")
def ref():
    model, params = _jax_params()
    heads2, params2 = _jax_params(n_heads=2)
    batch = _packed_batch()
    return {"model": model, "params": params, "batch": batch, "logits": _jax_logits(model, params, batch),
            "params2": params2, "logits2": _jax_logits(heads2, params2, batch),
            "step": _jax_step(model, params, batch)}


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("axes")
    a, b = str(tmp / "a"), str(tmp / "b")
    v, batch = ref["params"], ref["batch"]
    spec = {"logits_" + name: ("job_axes_logits", dict(variables=v, cfg=CFG, batch=batch, axes=axes, fsdp=fsdp))
            for name, (axes, fsdp) in MESHES.items()}
    spec.update({
        "logits_heads2": ("job_axes_logits", dict(variables=ref["params2"], cfg=dict(CFG, n_heads=2),
                                                  batch=batch, axes={"dp": 1, "tp": 4})),
        "step_dp2_tp2": ("job_axes_step", dict(variables=v, cfg=CFG, batches=[batch], axes=MESHES["dp2_tp2"][0])),
        "step_dp1_fsdp2_tp2": ("job_axes_step", dict(variables=v, cfg=CFG, batches=[batch],
                                                     axes=MESHES["dp1_fsdp2_tp2"][0], fsdp=True)),
        "save_tp": ("job_axes_save", dict(root=a, variables=v, cfg=CFG, batch=batch, axes={"dp": 2, "tp": 2},
                                          step_no=1)),
        "save_dp": ("job_axes_save", dict(root=b, variables=v, cfg=CFG, batch=batch, axes={"dp": 4}, step_no=1)),
        "tp_on_dp": ("job_axes_restore", dict(path=a + "/ckpt_1", variables=v, cfg=CFG, axes={"dp": 4})),
        "dp_on_tp": ("job_axes_restore", dict(path=b + "/ckpt_1", variables=v, cfg=CFG, axes={"dp": 2, "tp": 2})),
        "tp_on_fsdp_tp": ("job_axes_restore", dict(path=a + "/ckpt_1", variables=v, cfg=CFG,
                                                   axes={"dp": 1, "fsdp": 2, "tp": 2}, fsdp=True)),
        "regions": ("job_regions", dict(x=np.random.default_rng(5).standard_normal((4, 3, 2)).astype(np.float32),
                                        w=np.random.default_rng(6).standard_normal((4, 3, 2)).astype(np.float32))),
    })
    return run_world(tmp, spec)


def _axes(specs):
    return {a for s in specs.values() for e in s if e for a in ((e,) if isinstance(e, str) else e)}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_logits_match_the_replicated_jax_model(ref, world, name):
    for r, got in enumerate(world):
        np.testing.assert_allclose(got["logits_" + name]["logits"].numpy(), ref["logits"], atol=2e-5,
                                   err_msg="rank %d" % r)


def test_dp_tp_places_tp_only_and_the_gauge_reads_13(world):
    got = world[0]["logits_dp2_tp2"]
    assert _axes(got["specs"]) == {"tp"}
    # 2 layers x (q k v o + wi wo) + lm_head all carry a tp dim
    assert got["gauge"] == 13 == len(got["model_specs"])
    assert got["local_shapes"]["layer_0.attn.q.weight"] == (16, 32)  # 2 of 4 heads
    assert got["local_shapes"]["lm_head.weight"] == (32, 32)  # half the vocabulary
    assert got["local_shapes"]["embed.weight"] == (64, 32)  # embed stays whole


def test_dp_fsdp_tp_overlay_places_tp_and_fsdp(world):
    """The tp rule places first; the ZeRO-3 overlay shards the rest."""
    got = world[0]["logits_dp1_fsdp2_tp2"]
    assert {"tp", "fsdp"} <= _axes(got["specs"])
    assert got["fsdp_dims"] and "embed.weight" in got["fsdp_dims"]
    assert got["gauge"] == 13


def test_undersized_heads_run_replicated(ref, world):
    """n_heads=2 over tp=4: attention stays whole (no collective), the MLP
    and lm_head still split, and the logits still match."""
    got = world[0]["logits_heads2"]
    assert not any(".attn." in n for n in got["model_specs"])
    assert "layer_0.mlp.wi.weight" in got["model_specs"]
    for r in world:
        np.testing.assert_allclose(r["logits_heads2"]["logits"].numpy(), ref["logits2"], atol=2e-5)


def _plan(axes):
    n = int(np.prod(list(axes.values())))
    return mesh_lib.build_mesh(axes, devices=[mesh_lib.RankDevice(r, "h") for r in range(n)], device_type="cpu")


def test_undersized_dims_degrade_to_replicated():
    specs = transformer.param_specs(transformer.create_model(**dict(CFG, n_heads=2)), _plan({"dp": 2, "tp": 4}))
    assert specs["layer_0.attn.q.weight"] == (None, None)  # H=2 % 4 != 0: replicated
    assert "tp" in specs["layer_0.mlp.wi.weight"]  # d_ff=64 still shards


def test_tp_requires_mesh_axis():
    with pytest.raises(ValueError, match="'tp' axis"):
        SyncDataParallel(_plan({"dp": 8}), tp=transformer.param_specs)
    with pytest.raises(ValueError, match="'tp' axis"):
        SyncDataParallel("cpu", tp=transformer.param_specs)


def test_tp_requires_placement_rules():
    with pytest.raises(ValueError, match="placement rules"):
        SyncDataParallel(_plan({"dp": 2, "tp": 4}), tp=True)


def test_tp_rejects_two_different_rule_fns():
    with pytest.raises(ValueError, match="once"):
        SyncDataParallel(_plan({"dp": 2, "tp": 4}), tp=transformer.param_specs,
                         param_spec_fn=lambda p, m: p)


@pytest.mark.parametrize("name", ["step_dp2_tp2", "step_dp1_fsdp2_tp2"])
def test_one_adamw_step_matches_the_jax_package(ref, world, name):
    loss, params = ref["step"]
    for r, got in enumerate(world):
        np.testing.assert_allclose(got[name]["losses"], [loss], atol=1e-5, rtol=0)
        assert set(got[name]["params"]) == set(params)
        for key, want in params.items():
            np.testing.assert_allclose(got[name]["params"][key].numpy(), want.numpy(), atol=1e-5, rtol=0,
                                       err_msg="rank %d %s" % (r, key))


def test_replicated_gradients_are_equal_across_the_tp_group(world):
    """embed, the norms (and nothing split) get whole gradients on every
    rank: copy_to_region sums the blocks' partial input gradients."""
    grads = [r["step_dp2_tp2"]["replicated_grads"] for r in world]
    assert set(grads[0]) == {"embed.weight", "ln_f.weight"} | {
        "layer_{}.{}.weight".format(i, ln) for i in range(2) for ln in ("ln1", "ln2")}
    for g in grads[1:]:
        for key, value in grads[0].items():
            assert torch.equal(value, g[key]), key


def test_the_adam_state_of_split_arrays_is_split(world):
    """Adam's mu on a dp2×tp2 rank holds half of each tp-split array."""
    whole = sum(p.numel() for p in world[0]["step_dp2_tp2"]["params"].values())
    split = world[0]["logits_dp2_tp2"]["model_specs"]
    shapes = world[0]["logits_dp2_tp2"]["local_shapes"]
    assert world[0]["step_dp2_tp2"]["adam_elems"] == sum(int(np.prod(s)) for s in shapes.values()) < whole
    assert all(int(np.prod(shapes[n])) * 2 == world[0]["step_dp2_tp2"]["params"][n].numel() for n in split)


def test_checkpoints_under_dp_tp_and_dp_hold_the_same_full_tensors(world):
    tp, dp = world[0]["save_tp"], world[0]["save_dp"]
    assert tp["verified"] == dp["verified"] == (True, "verified") and tp["gathers"] and not dp["gathers"]
    for part in ("params", "opt_state"):
        a, b = tp["tree"][part], dp["tree"][part]
        flat_a = {k: v for k, v in _flat(a)}
        flat_b = {k: v for k, v in _flat(b)}
        assert set(flat_a) == set(flat_b)
        for k, v in flat_a.items():
            assert v.shape == flat_b[k].shape and v.dtype == flat_b[k].dtype, k
            np.testing.assert_allclose(v.numpy(), flat_b[k].numpy(), atol=1e-5, rtol=0, err_msg=k)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + "/" + str(k))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


@pytest.mark.parametrize("restored, saved", [("tp_on_dp", "save_tp"), ("dp_on_tp", "save_dp"),
                                             ("tp_on_fsdp_tp", "save_tp")])
def test_reshard_restore_moves_bytes_bitwise(world, restored, saved):
    for r in world:
        got, want = r[restored], world[0][saved]["tree"]
        assert got["step"] == want["step"] == 1
        for k, v in want["params"].items():
            assert torch.equal(got["params"][k], v), k
        for k, v in _flat(want["opt_state"]):
            assert torch.equal(dict(_flat(got["opt_state"]))[k], v), k


def test_a_rank_holds_its_blocks_after_a_reshard(world):
    local = world[1]["dp_on_tp"]["local"]  # dp2×tp2: rank 1 holds the second tp block
    full = world[0]["save_dp"]["tree"]["params"]
    assert torch.equal(local["layer_0.attn.q.weight"], full["layer_0.attn.q.weight"][16:])
    assert torch.equal(local["layer_0.attn.o.weight"], full["layer_0.attn.o.weight"][:, 16:])
    assert torch.equal(local["embed.weight"], full["embed.weight"])


@pytest.mark.parametrize("name", ["copy", "reduce", "gather", "global_sum"])
def test_region_collectives_backward_match_single_rank_autograd(world, name):
    """Each conjugate pair's backward is the transpose of its forward: the
    rank's gradient equals plain autograd of the whole computation (for
    ``copy_to_region`` the sum of the ranks' losses; for ``global_sum``
    too, each rank's loss using the sum)."""
    rng_x = np.random.default_rng(5).standard_normal((4, 3, 2)).astype(np.float32)
    w = torch.as_tensor(np.random.default_rng(6).standard_normal((4, 3, 2)).astype(np.float32))
    xs = [torch.as_tensor(rng_x[r]).clone().requires_grad_(True) for r in range(4)]
    if name == "copy":
        x0 = torch.as_tensor(rng_x[0]).clone().requires_grad_(True)
        values = [x0 * w[r] for r in range(4)]
        sum(v.sum() for v in values).backward()
        grads = [x0.grad] * 4
    elif name == "reduce":
        y = sum(xs) * w[0]
        y.sum().backward()
        values, grads = [y] * 4, [x.grad for x in xs]
    elif name == "gather":
        y = torch.cat(xs, dim=1) * torch.cat(list(w), dim=1)
        y.sum().backward()
        values, grads = [y] * 4, [x.grad for x in xs]
    else:
        s = sum(xs)
        y = torch.tanh(s) * w[0]
        (4 * y.sum()).backward()
        values, grads = [y] * 4, [x.grad for x in xs]
    for r, got in enumerate(world):
        np.testing.assert_allclose(got["regions"][name]["value"].numpy(), values[r].detach().numpy(),
                                   atol=1e-6, err_msg="rank %d" % r)
        np.testing.assert_allclose(got["regions"][name]["grad"].numpy(), grads[r].numpy(), atol=1e-6,
                                   err_msg="rank %d" % r)


# -- rematerialization ----------------------------------------------------------


def _port_grads(module, batch):
    module.zero_grad()
    loss, metrics = transformer.make_loss_fn(module)(module, {k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in module.named_parameters()}


@pytest.mark.parametrize("moe", [0, 4])
def test_remat_is_bitwise_no_remat_and_matches_jax_remat(ref, moe):
    """``remat=True`` recomputes each block in the backward: loss and
    gradients bitwise those of ``remat=False``, and within 1e-5 of the JAX
    package's ``remat=True``."""
    over = dict(moe_experts=moe, moe_group_size=8) if moe else {}
    jmodel, jparams = _jax_params(remat=True, **over)
    batch = ref["batch"]
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jtransformer.make_loss_fn(jmodel), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = convert.convert_variables({"params": _np(jgrads)})
    got = {}
    for remat in (False, True):
        module = transformer.create_model(**dict(CFG, remat=remat, **over))
        convert.load_variables(module, {"params": jparams})
        got[remat] = _port_grads(module, batch)
    assert torch.equal(got[True][0], got[False][0])
    for n, g in got[False][1].items():
        assert torch.equal(got[True][1][n], g), n
        np.testing.assert_allclose(g.numpy(), jgrads[n].numpy(), atol=1e-5, rtol=0, err_msg=n)
    np.testing.assert_allclose(float(got[True][0]), float(jloss), atol=1e-5, rtol=0)


# -- the slice's checks, rehearsed at a small size ------------------------------


def test_sync_dp_check_tp_ep_rehearsal():
    """``sync_dp_check --tp --ep`` on 4 CPU ranks at the small size: every
    tp and ep leg within 1e-5 (f32) of its data-parallel leg, every rank's
    gathered parameters equal (the arrays no model axis splits equal on
    every rank of a group), the loop bitwise the eager steps; the Adam
    state of a rank smaller on every split leg."""
    import json
    import os
    import subprocess
    import sys

    from torch_world_util import REPO

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "tensorflowonspark_tpu_torch.examples.sync_dp_check", "--platform", "cpu",
         "--world", "4", "--size", "small", "--steps", "2", "--pairs", "0", "--models", "", "--tp", "--ep"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    assert [(x["model"], x["leg"]) for x in lines] == [
        ("transformer_tp", leg) for leg in ("dp", "dp2_tp2", "tp4", "dp1_fsdp2_tp2")] + [
        ("transformer_moe", leg) for leg in ("dp", "ep4", "dp2_ep2")]
    dp = {}
    for x in lines:
        assert x["tensors_off_rank0"] == 0 and not x["loop_vs_eager_mismatches"]
        assert len(set(x["losses_by_rank"])) == 1
        if x["leg"] == "dp":
            dp[x["model"]] = x
            continue
        assert x["params_split"] > 0 and x["loss_rel_gap_to_dp"] <= 1e-5
        assert x["optimizer_state_bytes_per_rank"] < dp[x["model"]]["optimizer_state_bytes_per_rank"]


@pytest.mark.parametrize("axes, want", [
    ({"dp": 2, "tp": 2}, [(0, 2), (0, 2), (1, 2), (1, 2)]),
    ({"dp": 1, "ep": 4}, [(0, 1)] * 4),
    ({"dp": 2, "fsdp": 2, "tp": 2}, [(0, 4), (0, 4), (1, 4), (1, 4), (2, 4), (2, 4), (3, 4), (3, 4)]),
    ({"tp": 4}, [(0, 1)] * 4),
])
def test_data_shard_reads_the_data_coordinate_from_a_plan(axes, want):
    """The ranks of a tp or ep group get the same share of the data; the
    data axes' coordinate is read from a plan of the mesh (no world)."""
    from tensorflowonspark_tpu_torch.parallel import sharding

    plan = _plan(axes)
    assert [sharding.data_shard(plan, r) for r in range(len(want))] == want
