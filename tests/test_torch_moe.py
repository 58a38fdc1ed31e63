"""Mixture of experts on the port: the cases of the JAX package's
``tests/test_models.py::TestMoE``, held to the JAX package's ``MoeMlp`` and
its MoE transformer on the CPU.

Without a world: one expert is the dense FFN and its balancing loss is
exactly 1; the capacity drops overflow tokens; the port's ``MoeMlp``
matches the JAX one on the same weights (forward and balancing loss,
2e-5); ``param_specs`` puts the experts on ``ep``. In a 4-rank gloo world
(``testing.join_cpu_world``): one train step of the JAX test's MoE
transformer (4 experts) on ``{"dp": 1, "ep": 4}``, ``{"dp": 2, "ep":
2}`` and ``{"dp": 1, "tp": 2, "ep": 2}`` (each expert's hidden dim split
over ``tp`` too) against the replicated JAX model (loss and ``moe_aux`` within 1e-5,
``moe_aux >= 0.99``; every gradient, gathered over ``ep`` and averaged
over ``dp``, within 1e-6), and a checkpoint saved on
``ep`` (gathered to full tensors) resharded onto ``dp`` and ``dp × ep``,
bitwise.

``moe_group_size`` is 16 in the world's model: the port forms its groups
from a rank's own tokens (2 rows of 16 under ``dp = 2``), the JAX package
from the global batch's; with 16 both cut the same groups.

On a sequence split over ``sp`` a rank routes its block alone where the
groups allow it (the local route): the MoE transformer with groups of 8 on
``{"dp": 2, "sp": 2}`` and ``{"sp": 2}`` (a world of 2 ranks), and with
groups of 2 on ``{"sp": 4}`` over 30 inputs a row (the last block holds 6
real tokens and 2 of padding, which stay out of the balancing loss), at
the same limits. Groups that span two blocks or a row end take the
gathered route (every rank routes the whole sequence and keeps its block):
groups of 16 on blocks of 8 and groups of 4 on a last block of 6 real
tokens on ``{"sp": 4}``, and groups of 16 (a whole row) on blocks of 8 on
``{"dp": 2, "sp": 2}``, at the same limits. The route is picked once an
input shape and row length: two batches of rows of 30 and 29 inputs, cut
to the same blocks, each route their own real tokens (logits and loss
within 1e-5 of the JAX model's whole-sequence forward).

The step is held by its gradients, not by AdamW's first update: that
update is about ``lr * sign(g)``, and an expert weight that few tokens
reach has a gradient near Adam's epsilon, where the update turns on the
gradient's last bits (one element of 8,192 moved 1.04e-5 apart from the
JAX package's while its gradient agreed within 1e-8; ROADMAP §C C8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tensorflowonspark_tpu.models import transformer as jtransformer
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.models import transformer
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib

from torch_world_util import run_world

LM = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_seq_len=32, moe_experts=4,
          moe_group_size=16, dtype="float32", attention="plain")
EP = {"ep4": {"dp": 1, "ep": 4}, "dp2_ep2": {"dp": 2, "ep": 2}, "tp2_ep2": {"dp": 1, "tp": 2, "ep": 2}}
#: sp meshes of the MoE transformer: (axes, moe_group_size, tokens a row);
#: ``sp2`` runs in a world of 2 ranks. The ``span`` cases take the gathered
#: route: groups of 16 on blocks of 8 (the JAX package shrinks them to 15,
#: a divisor of its 120 tokens), groups of 4 across the end of rows of 30,
#: and groups of a whole row on dp2 x sp2
SP = {"dp2_sp2": ({"dp": 2, "sp": 2}, 8, 17), "sp2": ({"sp": 2}, 8, 17), "sp4_pad": ({"sp": 4}, 2, 31),
      "sp4_span_blocks": ({"sp": 4}, 16, 31), "sp4_span_row_end": ({"sp": 4}, 4, 31),
      "dp2_sp2_span": ({"dp": 2, "sp": 2}, 16, 17)}
#: rows of 30 then 29 inputs, both cut to blocks of 8 on sp4, with groups of
#: 16 (wider than a block: the gathered route)
ROW_LENGTHS, ROW_LENGTHS_GROUP = (30, 29), 16
#: the route each sp case takes (the real tokens of a row where gathered)
ROUTES = {"dp2_sp2": None, "sp2": None, "sp4_pad": None, "sp4_span_blocks": 30, "sp4_span_row_end": 30,
          "dp2_sp2_span": 16}


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), jax.device_get(tree))


def _moe_pair(x, **cfg):
    """The JAX ``MoeMlp`` (its params, output, balancing loss) and the
    port's on the same weights."""
    jcfg = jtransformer.TransformerConfig(**cfg)
    jm = jtransformer.MoeMlp(jcfg)
    params = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    y, mods = jm.apply({"params": params}, jnp.asarray(x), mutable=["losses"])
    (aux,) = jax.tree.leaves(mods["losses"])
    port = transformer.MoeMlp(transformer.TransformerConfig(**cfg))
    weights = convert.convert_variables({"params": {"moe": params}})
    port.load_state_dict({k[len("moe."):]: v for k, v in weights.items()})
    return params, np.asarray(y), float(aux), port


def test_single_expert_equals_dense_ffn():
    cfg = dict(vocab_size=64, d_model=16, n_layers=1, n_heads=2, d_ff=32, moe_experts=1, moe_capacity_factor=4.0)
    x = np.random.default_rng(0).standard_normal((2, 8, 16)).astype(np.float32)
    params, jy, jaux, port = _moe_pair(x, **cfg)
    y = port(torch.as_tensor(x))
    dense = F.gelu(torch.as_tensor(x).reshape(-1, 16) @ port.wi[0], approximate="tanh") @ port.wo[0]
    np.testing.assert_allclose(y.detach().numpy().reshape(-1, 16), dense.detach().numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=2e-5, atol=2e-5)
    # one expert takes every token: the balancing loss is exactly E * 1 * 1 = 1
    assert float(port.aux.detach()) == 1.0 == pytest.approx(jaux)


def test_capacity_drops_overflow_tokens():
    port = transformer.MoeMlp(transformer.TransformerConfig(
        vocab_size=64, d_model=8, n_layers=1, n_heads=2, d_ff=16, moe_experts=2, moe_capacity_factor=0.25))
    port.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((1, 16, 8)).astype(np.float32))
    y = port(x).detach().numpy().reshape(16, 8)
    # capacity = 0.25 * 16 / 2 = 2 per expert -> at most 4 tokens routed;
    # dropped tokens contribute exactly zero output
    assert np.count_nonzero(np.abs(y).sum(-1) > 1e-7) <= 4


def test_moe_mlp_matches_the_jax_package():
    """4 experts, groups of 8 over 16 tokens a row, capacity 2 a group:
    overflow drops too. Forward and balancing loss within 2e-5."""
    cfg = dict(vocab_size=64, d_model=16, n_layers=1, n_heads=2, d_ff=32, moe_experts=4, moe_group_size=8)
    x = np.random.default_rng(2).standard_normal((2, 16, 16)).astype(np.float32)
    _, jy, jaux, port = _moe_pair(x, **cfg)
    y = port(torch.as_tensor(x))
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(port.aux.detach()), jaux, rtol=2e-5, atol=2e-5)


def test_param_specs_put_the_experts_on_ep():
    mesh = mesh_lib.build_mesh({"dp": 2, "ep": 4}, devices=[mesh_lib.RankDevice(r, "h") for r in range(8)],
                               device_type="cpu")
    specs = transformer.param_specs(transformer.create_model(**LM), mesh)
    assert specs["layer_0.moe.wi"] == ("ep", None, None)
    assert specs["layer_0.moe.wo"] == ("ep", None, None)
    assert specs["layer_0.moe.router.weight"] == (None, None)


def _jax_step(params, tokens, **cfg):
    model = jtransformer.create_model(**cfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(jtransformer.make_loss_fn(model), has_aux=True))(
        params, {"tokens": jnp.asarray(tokens)})
    return {"batch": {"tokens": tokens}, "loss": float(loss), "moe_aux": float(metrics["moe_aux"]),
            "grads": convert.convert_variables({"params": _np(grads)})}


@pytest.fixture(scope="module")
def ref():
    model = jtransformer.create_model(**LM)
    params = _np(jax.jit(jtransformer.make_init_fn(model, sample_len=8))(jax.random.PRNGKey(0))["params"])
    out = dict(_jax_step(params, np.random.default_rng(0).integers(0, 128, (4, 17)).astype(np.int32), **LM),
               params=params)
    out["sp"] = {name: _jax_step(params, np.random.default_rng(1).integers(0, 128, (4, n)).astype(np.int32),
                                 **dict(LM, moe_group_size=g))
                 for name, (_, g, n) in SP.items()}
    model = jtransformer.create_model(**dict(LM, moe_group_size=ROW_LENGTHS_GROUP))
    out["row_lengths"] = []
    for n in ROW_LENGTHS:
        tokens = np.random.default_rng(n).integers(0, 128, (4, n + 1)).astype(np.int32)
        logits, _ = jax.jit(lambda p, t: model.apply({"params": p}, t, mutable=["losses"]))(
            params, jnp.asarray(tokens[:, :-1]))
        out["row_lengths"].append(dict(_jax_step(params, tokens, **dict(LM, moe_group_size=ROW_LENGTHS_GROUP)),
                                       logits=np.asarray(logits)))
    return out


def _sp_spec(ref, names):
    return {"sp_" + name: ("job_axes_step", dict(variables=ref["params"], cfg=dict(LM, moe_group_size=SP[name][1]),
                                                 batches=[ref["sp"][name]["batch"]], axes=SP[name][0]))
            for name in names}


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    root = str(tmp / "ckpt")
    v, batch = ref["params"], ref["batch"]
    spec = {"step_" + name: ("job_axes_step", dict(variables=v, cfg=LM, batches=[batch], axes=axes))
            for name, axes in EP.items()}
    spec.update(_sp_spec(ref, sorted(set(SP) - {"sp2"})))
    pad = ref["sp"]["sp4_pad"]["batch"]
    spec["row_lengths"] = ("job_sp_batches", dict(
        variables=v, cfg=dict(LM, moe_group_size=ROW_LENGTHS_GROUP), axes={"sp": 4},
        batches=[want["batch"] for want in ref["row_lengths"]]))
    spec["checks"] = ("job_sp_routing_checks", dict(
        variables=v, cfg=dict(LM, moe_group_size=4), axes={"sp": 4},
        batches=[pad, pad, pad, {"tokens": pad["tokens"][:, :-14]}, pad]))
    spec.update({
        "save_ep": ("job_axes_save", dict(root=root, variables=v, cfg=LM, batch=batch, axes=EP["ep4"], step_no=1)),
        "ep_on_dp": ("job_axes_restore", dict(path=root + "/ckpt_1", variables=v, cfg=LM, axes={"dp": 4})),
        "ep_on_dp_ep": ("job_axes_restore", dict(path=root + "/ckpt_1", variables=v, cfg=LM, axes=EP["dp2_ep2"])),
    })
    return run_world(tmp, spec)


@pytest.fixture(scope="module")
def world2(ref, tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("moe_sp2"), _sp_spec(ref, ("sp2",)), world=2)


@pytest.mark.parametrize("name", sorted(SP))
def test_sp_train_step_matches_the_jax_model(ref, world, world2, name):
    """The MoE transformer with its sequence split over sp: each rank
    routes its block's groups (the local route), or the whole sequence's
    where a group spans two blocks or a row end (the gathered route); the
    balancing loss sums its counts and probabilities over dp and sp
    (``sp4_pad``: without the last block's padding). Loss and ``moe_aux``
    within 1e-5, every gradient within 1e-6."""
    want = ref["sp"][name]
    for r, got in enumerate(world2 if name == "sp2" else world):
        step = got["sp_" + name]
        assert step["sp_real"] == ROUTES[name], "rank %d" % r
        np.testing.assert_allclose(step["losses"], [want["loss"]], atol=1e-5, rtol=0, err_msg="rank %d" % r)
        np.testing.assert_allclose(step["metrics"]["moe_aux"], want["moe_aux"], atol=1e-5, rtol=0)
        assert step["metrics"]["moe_aux"] >= 0.99
        assert set(step["grads"]) == set(want["grads"])
        for key, g in want["grads"].items():
            np.testing.assert_allclose(step["grads"][key].numpy(), g.numpy(), atol=1e-6, rtol=0,
                                       err_msg="rank %d %s" % (r, key))


def test_sp_routing_is_checked_once_an_input_shape(world):
    """The routing check (on the host, from the row length) runs for a new
    input shape or row length only, and picks the route: with groups of 4, three
    batches of blocks of 8 whose last holds 6 real tokens (gathered: 30
    real tokens a row), one of four whole blocks of 4 (local), then blocks
    of 8 again."""
    gathered = "gathered 30"
    for got in world:
        assert got["checks"] == [[1, gathered], [1, gathered], [1, gathered], [2, "local"], [3, gathered]]


def test_sp_route_follows_each_batch_row_length(ref, world):
    """Two batches whose rows hold 30 and then 29 inputs, both cut to
    blocks of 8 on sp4 (the same input shape), with groups of 16 (a group
    spans blocks: the gathered route): each batch routes its own real
    tokens (``row_length`` rides with the batch from
    ``sharding.sequence_chunk``), so each one's logits and loss are the
    JAX model's whole-sequence forward on the same weights (1e-5). A route
    kept from the first batch would route one padding token a row of the
    second."""
    for r, got in enumerate(world):
        for n, want, step in zip(ROW_LENGTHS, ref["row_lengths"], got["row_lengths"]):
            assert step["sp_real"] == n, "rank %d" % r
            i, block = step["sp_index"], step["logits"].shape[1]
            real = max(0, min(block, n - i * block))
            np.testing.assert_allclose(step["logits"][:, :real].numpy(), want["logits"][:, i * block:i * block + real],
                                       atol=1e-5, rtol=0, err_msg="rank %d, rows of %d" % (r, n))
            np.testing.assert_allclose(step["loss"], want["loss"], atol=1e-5, rtol=0,
                                       err_msg="rank %d, rows of %d" % (r, n))


def test_sp_group_size_names_the_group_and_the_block():
    """The local route's group: ``moe_group_size`` where it divides the
    block and every block's real tokens; None (the gathered route) where a
    group would span two blocks, a row end, or every token."""
    assert transformer.sp_group_size(8, 16) == 8
    assert transformer.sp_group_size(2, 8, [8, 8, 8, 6]) == 2
    assert transformer.sp_group_size(6, 16) is None
    assert transformer.sp_group_size(16, 8) is None
    assert transformer.sp_group_size(4, 8, [8, 8, 8, 6]) is None
    assert transformer.sp_group_size(0, 16) is None


@pytest.mark.parametrize("name", sorted(EP))
def test_ep_train_step_matches_the_replicated_jax_model(ref, world, name):
    for r, got in enumerate(world):
        step = got["step_" + name]
        np.testing.assert_allclose(step["losses"], [ref["loss"]], atol=1e-5, rtol=0, err_msg="rank %d" % r)
        np.testing.assert_allclose(step["metrics"]["moe_aux"], ref["moe_aux"], atol=1e-5, rtol=0)
        # the balancing loss is >= 1 by Cauchy-Schwarz (perfect balance: exactly 1)
        assert step["metrics"]["moe_aux"] >= 0.99
        assert set(step["grads"]) == set(ref["grads"])
        for key, want in ref["grads"].items():
            np.testing.assert_allclose(step["grads"][key].numpy(), want.numpy(), atol=1e-6, rtol=0,
                                       err_msg="rank %d %s" % (r, key))


def test_ep_ranks_hold_a_quarter_of_the_experts(world):
    """On ep4 each rank's Adam state holds E/4 experts of each expert
    array; the router and everything else whole and equal on every rank."""
    got = world[0]["step_ep4"]
    expert = sum(p.numel() for k, p in got["params"].items() if k.endswith(("moe.wi", "moe.wo")))
    rest = sum(p.numel() for k, p in got["params"].items() if not k.endswith(("moe.wi", "moe.wo")))
    assert got["adam_elems"] == rest + expert // 4
    for r in world[1:]:
        for key, value in got["replicated_grads"].items():
            assert torch.equal(value, r["step_ep4"]["replicated_grads"][key]), key
    assert "layer_0.moe.router.weight" in got["replicated_grads"]


@pytest.mark.parametrize("name", ["ep_on_dp", "ep_on_dp_ep"])
def test_a_checkpoint_saved_on_ep_restores_on_other_meshes(world, name):
    saved = world[0]["save_ep"]
    assert saved["verified"] == (True, "verified") and saved["gathers"]
    assert saved["tree"]["params"]["layer_0.moe.wi"].shape == (4, 32, 64)  # full, gathered over ep
    for r in world:
        got = r[name]
        assert got["step"] == 1
        for key, value in saved["tree"]["params"].items():
            assert torch.equal(got["params"][key], value), key
        for key in ("mu", "nu"):
            for n, value in saved["tree"]["opt_state"][key].items():
                assert torch.equal(got["opt_state"][key][n], value), (key, n)


def test_axes_check_rehearsal(tmp_path):
    """The slice's check at a small size on the CPU, through
    ``TFCluster.run``: dp×tp at one rank bitwise dp (eager, the loop, a
    checkpoint resharded onto dp); the 8-expert LM on ``ep`` eager and
    looped bitwise, its loss finite and falling, ``moe_aux >= 0.99``;
    remat bitwise the plain step and its own loop."""
    from tensorflowonspark_tpu_torch.examples.transformer import axes_check, transformer_spark

    data_dir = str(tmp_path / "corpus")
    transformer_spark.make_text_corpus(data_dir, num_shards=2, records_per_shard=40)
    out = axes_check.main(["--platform", "cpu", "--size", "small", "--eager_steps", "2", "--steps_per_loop", "2",
                           "--pairs", "1", "--moe_steps", "4", "--data_dir", data_dir,
                           "--work_dir", str(tmp_path / "work")])
    assert axes_check.failures(out) == []
    # the small LM: 2 layers x (q k v o wi wo) + lm_head split over tp
    assert out["tp"]["params_split"] == 13 and out["dp"]["params_split"] == 0
    assert out["tp"]["losses"] == out["dp"]["losses"] and len(out["tp"]["losses"]) == 2 + 2 + 2
    assert out["moe"]["experts"] == 8 and len(out["moe"]["losses"]) == 4 and out["moe_compare"] is None
    assert out["remat"]["loss_bitwise"] and not out["remat"]["grad_mismatches"]
