"""The port's device meshes, sharding rules and collectives against the JAX
package's, on the CPU.

* Meshes: the JAX package's ``test_parallel.py::TestMesh`` and
  ``test_multichip.py``'s hybrid-placement cases, on fake ranks grouped by
  host (a TPU device's ``slice_index`` becomes a rank's ``host``); the
  builders return placement-plan ``DeviceMesh``es (no world is up here).
* Specs: ``fsdp_param_specs`` / ``overlay_fsdp_specs`` shard the same
  logical dimension as the JAX package's rules on the same models' shapes
  (the multichip MLP, a small transformer, a small ResNet), read through
  ``convert.flax_layouts``.
* Collectives: a 4-rank gloo world (``testing.join_cpu_world``) against
  ``shard_map`` on 4 virtual CPU devices, every output within 1e-6 (f32).
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from tensorflowonspark_tpu import parallel as jparallel
from tensorflowonspark_tpu.models import resnet as jresnet
from tensorflowonspark_tpu.models import transformer as jtransformer
from tensorflowonspark_tpu.parallel import collectives as jcollectives
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.models import resnet, transformer
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_mod
from tensorflowonspark_tpu_torch.parallel import sharding

from torch_world_util import run_world

TOL = 1e-6


class _FakeRank:
    """Stands in for a rank: its number and a host tag, nothing else."""

    def __init__(self, i, host=None):
        self.rank = i
        if host is not None:
            self.host = host

    def __repr__(self):
        return "R{}h{}".format(self.rank, getattr(self, "host", "-"))


def _two_hosts(per_host=4):
    return [_FakeRank(i, i // per_host) for i in range(2 * per_host)]


def _hosts(m, row):
    return {d.host for d in np.asarray(m.devices)[row].ravel()}


class TestMesh:
    def test_default_is_pure_dp(self):
        m = mesh_mod.build_mesh(devices=list(range(8)))
        assert mesh_mod.mesh_shape(m) == {"dp": 8}

    def test_fill_axis(self):
        m = mesh_mod.build_mesh({"dp": -1, "tp": 2}, devices=list(range(8)))
        assert mesh_mod.mesh_shape(m) == {"dp": 4, "tp": 2}

    def test_axis_order_is_canonical(self):
        m = mesh_mod.build_mesh({"sp": 2, "dp": 2, "tp": 2}, devices=list(range(8)))
        assert m.mesh_dim_names == ("dp", "tp", "sp")

    def test_custom_axis_appended(self):
        m = mesh_mod.build_mesh({"dp": 4, "stage": 2}, devices=list(range(8)))
        assert m.mesh_dim_names == ("dp", "stage")

    def test_bad_product_raises(self):
        with pytest.raises(ValueError):
            mesh_mod.build_mesh({"dp": 3}, devices=list(range(8)))

    def test_two_fills_raise(self):
        with pytest.raises(ValueError):
            mesh_mod.build_mesh({"dp": -1, "tp": -1}, devices=list(range(8)))

    def test_ranks_rise_along_every_axis(self):
        m = mesh_mod.build_mesh({"dp": 2, "fsdp": 4}, devices=list(range(8)))
        assert m.mesh.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]


class TestHybridFactors:
    def test_sequence_gives_whole_factor_to_first_fit(self):
        f = mesh_mod._hybrid_factors({"dp": 4, "fsdp": 2}, 2, ("dp",))
        assert f == {"dp": 2, "fsdp": 1}

    def test_sequence_skips_non_dividing_axis(self):
        f = mesh_mod._hybrid_factors({"dp": 3, "fsdp": 4}, 2, ("dp", "fsdp"))
        assert f == {"dp": 1, "fsdp": 2}

    def test_no_axis_can_absorb_raises(self):
        with pytest.raises(ValueError, match="absorb the DCN dimension"):
            mesh_mod._hybrid_factors({"tp": 3}, 2, ("dp",))

    def test_dict_split_validated(self):
        f = mesh_mod._hybrid_factors({"dp": 4, "fsdp": 4}, 4, {"dp": 2, "fsdp": 2})
        assert f == {"dp": 2, "fsdp": 2}
        with pytest.raises(ValueError, match="does not divide"):
            mesh_mod._hybrid_factors({"dp": 3}, 2, {"dp": 2})
        with pytest.raises(ValueError, match="multiply to the slice count"):
            mesh_mod._hybrid_factors({"dp": 4, "fsdp": 4}, 4, {"dp": 2})


class TestHybridDeviceGrid:
    def test_host_major_within_split_axis(self):
        # dp=4 split 2 (across hosts) x 2 (within): dp rows 0,1 on host 0,
        # rows 2,3 on host 1 — walking dp crosses hosts exactly once
        grid = mesh_mod._hybrid_device_grid(
            {"dp": 4, "fsdp": 2}, {"dp": 2, "fsdp": 1}, mesh_mod._slice_groups(_two_hosts(4)))
        assert grid.shape == (4, 2)
        for j in range(4):
            assert {d.host for d in grid[j]} == {j // 2}, grid

    def test_unsplit_axis_stays_inside_a_host(self):
        grid = mesh_mod._hybrid_device_grid(
            {"dp": 2, "fsdp": 4}, {"dp": 2, "fsdp": 1}, mesh_mod._slice_groups(_two_hosts(4)))
        for j in range(2):
            assert {d.host for d in grid[j]} == {j}

    def test_unequal_hosts_raise(self):
        devs = [_FakeRank(0, 0), _FakeRank(1, 0), _FakeRank(2, 1)]
        with pytest.raises(ValueError, match="devices; hybrid mesh needs"):
            mesh_mod._hybrid_device_grid({"dp": 3}, {"dp": 1}, mesh_mod._slice_groups(devs))


class TestBuildHybridMesh:
    def test_default_axes_dp_over_hosts_fsdp_within(self):
        m = mesh_mod.build_hybrid_mesh(devices=_two_hosts(4))
        assert mesh_mod.mesh_shape(m) == {"dp": 2, "fsdp": 4}
        for j in range(2):
            assert _hosts(m, j) == {j}

    def test_explicit_axes_split_dp(self):
        m = mesh_mod.build_hybrid_mesh({"dp": 4, "fsdp": 2}, devices=_two_hosts(4))
        assert mesh_mod.mesh_shape(m) == {"dp": 4, "fsdp": 2}
        for j in range(4):
            assert _hosts(m, j) == {j // 2}
        assert m.mesh.tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]

    def test_single_host_delegates_to_flat_build(self):
        m = mesh_mod.build_hybrid_mesh({"dp": -1}, devices=[_FakeRank(i, 0) for i in range(4)])
        assert mesh_mod.mesh_shape(m) == {"dp": 4}

    def test_drop_trivial_keeps_cross_host_axes(self):
        m = mesh_mod.build_hybrid_mesh({"dp": 2, "fsdp": 1}, devices=_two_hosts(1), drop_trivial=True)
        assert mesh_mod.mesh_shape(m) == {"dp": 2}


class TestBuildMeshDelegation:
    def test_multi_host_delegates_silently(self, caplog):
        with caplog.at_level(logging.WARNING, logger=mesh_mod.__name__):
            m = mesh_mod.build_mesh({"dp": 2, "fsdp": 4}, devices=_two_hosts(4))
        assert not caplog.records
        assert mesh_mod.mesh_shape(m) == {"dp": 2, "fsdp": 4}
        for j in range(2):
            assert _hosts(m, j) == {j}

    def test_unplaceable_falls_back_to_flat_with_warning(self, caplog):
        devs = [_FakeRank(i, i // 3) for i in range(6)]
        with caplog.at_level(logging.WARNING, logger=mesh_mod.__name__):
            m = mesh_mod.build_mesh({"dp": 3, "tp": 2}, devices=devs)
        assert any("flat reshape" in r.getMessage() for r in caplog.records)
        assert mesh_mod.mesh_shape(m) == {"dp": 3, "tp": 2}


# -- specs: the same logical dimension as the JAX package's rules ------------

SMALL_LM = dict(vocab_size=300, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=64)
SMALL_RESNET = dict(stage_sizes=(1, 1), filters=(8, 16), bottleneck=False, stem="cifar", num_classes=10)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@functools.lru_cache(maxsize=None)
def _jax_port_models():
    """``(name, JAX params, port module, port name of a JAX path)`` of the
    three models whose placement is compared."""
    rng = np.random.default_rng(0)
    mlp = {"w1": rng.standard_normal((64, 64)).astype(np.float32),
           "w2": rng.standard_normal((64, 8)).astype(np.float32)}
    jlm = jtransformer.create_model(dtype="float32", attention="plain", **SMALL_LM)
    lm = jax.tree.map(np.asarray, jax.jit(jtransformer.make_init_fn(jlm, sample_len=8))(
        jax.random.PRNGKey(0))["params"])
    jres = jresnet.ResNet(**SMALL_RESNET)
    res = jax.tree.map(np.asarray, jax.jit(lambda x: jres.init(jax.random.PRNGKey(0), x, train=False))(
        jnp.zeros((2, 8, 8, 3)))["params"])
    weights = lambda p: ".".join(p[:-1] + ({"kernel": "weight", "scale": "weight", "bias": "bias",  # noqa: E731
                                             "embedding": "weight"}[p[-1]],))
    return [
        ("mlp", mlp, {n: _t(v) for n, v in mlp.items()}, lambda p: p[0]),
        ("transformer", lm, transformer.create_model(dtype="float32", attention="plain", **SMALL_LM), weights),
        ("resnet", res, resnet.ResNet(**SMALL_RESNET), weights),
    ]


def _t(a):
    import torch

    return torch.as_tensor(a)


def _fsdp_dim(spec):
    """The dim a spec (JAX ``PartitionSpec`` or the port's tuple) splits
    along ``fsdp``, or None."""
    return next((i for i, e in enumerate(tuple(spec)) if e == "fsdp"), None)


def _expected_fsdp_dim(layouts, name, jdim):
    return None if jdim is None else layouts[name][1][jdim]


@pytest.mark.parametrize("fsdp", [2, 4, 8])
@pytest.mark.parametrize("min_weight_size", [2 ** 14, 1024, 16])
def test_fsdp_param_specs_shard_the_jax_packages_dimension(fsdp, min_weight_size):
    """For every parameter of the three models, the port shards the port
    dimension that holds the flax dimension the JAX rule picks, or none
    where the JAX rule replicates; the counts (the gauge's) are equal."""
    jmesh = jparallel.build_mesh({"fsdp": fsdp}, devices=jax.devices()[:fsdp])
    pmesh = mesh_mod.build_mesh({"fsdp": fsdp}, devices=list(range(fsdp)))
    for name, jparams, module, port_name in _jax_port_models():
        jspecs = jparallel.fsdp_param_specs(jparams, jmesh, min_weight_size=min_weight_size)
        specs = sharding.fsdp_param_specs(module, pmesh, min_weight_size=min_weight_size)
        layouts = sharding._layouts(module)
        got_sharded = 0
        for path, jspec in _flat(jspecs):
            pname = port_name(path)
            want = _expected_fsdp_dim(layouts, pname, _fsdp_dim(jspec))
            assert _fsdp_dim(specs[pname]) == want, (name, pname, jspec, specs[pname])
            got_sharded += want is not None
        assert got_sharded == sum(1 for s in specs.values() if "fsdp" in s), name
        assert len(specs) == len(list(_flat(jspecs))), name


def test_overlay_keeps_claimed_specs_and_completes_the_rest():
    """A model rule that already shards ``fsdp`` wins; every other array
    gets the JAX overlay's dimension (on an all-replicated tree: the plain
    rule's)."""
    jmesh = jparallel.build_mesh({"dp": 2, "fsdp": 2}, devices=jax.devices()[:4])
    pmesh = mesh_mod.build_mesh({"dp": 2, "fsdp": 2}, devices=list(range(4)))
    _, jparams, module, port_name = _jax_port_models()[1]
    jspecs = jparallel.overlay_fsdp_specs(jparams, jax.tree.map(lambda _: P(), jparams), jmesh, 1024)
    claimed = {n: ((None, "fsdp") if n == "embed.weight" else ()) for n, _ in module.named_parameters()}
    specs = sharding.overlay_fsdp_specs(module, claimed, pmesh, 1024)
    plain = sharding.overlay_fsdp_specs(module, {n: () for n in claimed}, pmesh, 1024)
    layouts = sharding._layouts(module)
    assert specs["embed.weight"] == (None, "fsdp")
    for path, jspec in _flat(jspecs):
        pname = port_name(path)
        want = _expected_fsdp_dim(layouts, pname, _fsdp_dim(jspec))
        assert _fsdp_dim(plain[pname]) == want, pname
        if pname != "embed.weight":
            assert specs[pname] == plain[pname], pname
    assert sharding.overlay_fsdp_specs(module, claimed, mesh_mod.build_mesh({"dp": 4}, devices=list(range(4)))) \
        == claimed


def test_flax_layouts_follow_the_converter():
    """The layout of each parameter is its flax counterpart's shape."""
    _, jparams, module, port_name = _jax_port_models()[1]
    layouts = convert.flax_layouts(module)
    for path, value in _flat(jparams):
        assert layouts[port_name(path)][0] == value.shape, path
    _, jparams, module, port_name = _jax_port_models()[2]
    layouts = convert.flax_layouts(module)
    for path, value in _flat(jparams):
        assert layouts[port_name(path)][0] == value.shape, path


def test_batch_spec_and_replicated():
    pmesh = mesh_mod.build_mesh({"dp": 2, "fsdp": 4}, devices=list(range(8)))
    assert sharding.batch_spec(pmesh) == (("dp", "fsdp"),)
    assert sharding.batch_spec(mesh_mod.build_mesh({"dp": 8}, devices=list(range(8)))) == ("dp",)
    assert sharding.replicated(pmesh).spec == ()
    assert sharding.data_axes(mesh_mod.build_mesh({"dp": 4, "tp": 2}, devices=list(range(8)))) == ("dp",)
    cpu = mesh_mod.build_mesh({"dp": 2}, devices=[0, 1], device_type="cpu")
    placed = sharding.shard_batch({"x": np.ones((2, 3), np.float32)}, cpu)["x"]
    assert placed.device.type == "cpu" and placed.shape == (2, 3)


# -- collectives: a 4-rank world against shard_map on 4 devices -------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    x = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    ranks = run_world(tmp_path_factory.mktemp("collectives"), {"c": ("job_collectives", {"x": x})})
    return x, [r["c"] for r in ranks], _jax_collectives(x)


def _jax_collectives(x):
    mesh = jparallel.build_mesh({"dp": 4}, devices=jax.devices()[:4])
    c = jcollectives

    def f(b):
        return {
            "psum": c.psum(b, "dp"), "pmean": c.pmean(b, "dp"),
            "all_gather": c.all_gather(b, "dp"), "all_gather_1": c.all_gather(b, "dp", axis=1),
            "all_gather_stack": c.all_gather(b, "dp", tiled=False),
            "reduce_scatter": c.reduce_scatter(b, "dp"),
            "reduce_scatter_1": c.reduce_scatter(b, "dp", scatter_dimension=1),
            "ring_shift": c.ring_shift(b, "dp"), "ring_shift_back": c.ring_shift(b, "dp", shift=-1),
            "all_to_all": c.all_to_all(b, "dp", split_axis=1, concat_axis=0),
            "axis_index": jnp.reshape(c.axis_index("dp"), (1,)),
        }

    out = jcollectives.shard_map(f, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"), check_vma=False)(
        jnp.asarray(x))
    return {k: np.split(np.asarray(v), 4) for k, v in out.items()}


COLLECTIVES = ["psum", "pmean", "all_gather", "all_gather_1", "all_gather_stack", "reduce_scatter",
               "reduce_scatter_1", "ring_shift", "ring_shift_back", "all_to_all"]


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_matches_shard_map(world, name):
    _, ranks, jax_out = world
    want = jax_out[name]
    for r, got in enumerate(ranks):
        assert tuple(got[name].shape) == want[r].shape, (name, r)
        np.testing.assert_allclose(got[name].numpy(), want[r], atol=TOL, rtol=0, err_msg="rank %d" % r)
        assert got["input_intact"]


def test_axis_index_and_size(world):
    _, ranks, jax_out = world
    want = jax_out["axis_index"]
    assert [r["axis_index"] for r in ranks] == [int(w[0]) for w in want] == [0, 1, 2, 3]
    assert {r["axis_size"] for r in ranks} == {4}


def test_multi_axis_and_sub_axis_sums(world):
    """``psum`` over ``("dp", "fsdp")`` of a 2x2 mesh is the whole world's
    sum; over ``fsdp`` alone, the sum of the two ranks of a dp row."""
    x, ranks, _ = world
    blocks = np.split(x, 4)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["psum_data"].numpy(), sum(blocks), atol=TOL, rtol=0)
        row = r // 2
        np.testing.assert_allclose(got["psum_fsdp"].numpy(), blocks[2 * row] + blocks[2 * row + 1],
                                   atol=TOL, rtol=0)
