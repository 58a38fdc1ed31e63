"""Resharded restore on the port: a checkpoint saved on one mesh lands on
another — the cases of the JAX package's ``test_ckpt_reshard.py`` in gloo
worlds of the port on the CPU.

A checkpoint holds full tensors whatever the placement it was saved from,
so resharding moves bytes and never recomputes them: every value is held
bitwise. One 4-rank world (``testing.join_cpu_world``) runs, in order: a
state trained a step on ``{"dp": 4}`` and committed by the async engine;
its restore onto ``{"dp": 2, "fsdp": 2}`` with the parameters and the
optimizer state sharded (the placement the new strategy's ``create_state``
derives), saved again from there (every rank gathers, rank 0 writes) and
restored back onto ``{"dp": 4}``; a fully sharded ``{"dp": 2, "fsdp": 2}``
state committed by the engine (every rank's engine gathers, rank 0's
writes); and the bare-pytree cases. A 2-rank world then restores the
sharded checkpoint onto the smaller ``{"dp": 1, "fsdp": 2}`` mesh (the
elastic shrink)."""

import pytest
import torch

from torch_world_util import run_world

HYBRID = {"dp": 2, "fsdp": 2}


def _assert_bitwise(saved, back, where=""):
    if isinstance(saved, torch.Tensor):
        assert torch.equal(saved, back), where
    elif isinstance(saved, dict):
        assert set(saved) == set(back), where
        for k in saved:
            _assert_bitwise(saved[k], back[k], "{}/{}".format(where, k))
    else:
        assert saved == back, where


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reshard")
    a, b, c, d = (str(tmp / x) for x in "abcd")
    four = run_world(tmp, {
        "save_dp": ("job_save", dict(root=a, axes={"dp": 4}, fsdp=False, step_no=1)),
        "on_hybrid": ("job_restore", dict(path=a + "/ckpt_1", axes=HYBRID, fsdp=True, save_to=b + "/ckpt_2")),
        "back_on_dp": ("job_restore", dict(path=b + "/ckpt_2", axes={"dp": 4}, fsdp=False)),
        "save_full": ("job_save", dict(root=c, axes=HYBRID, fsdp=True, step_no=3)),
        "bare": ("job_bare", dict(root=d)),
    })
    shrink_dir = tmp / "shrink"
    shrink_dir.mkdir()
    two = run_world(shrink_dir, {
        "shrunk": ("job_restore", dict(path=c + "/ckpt_3", axes={"dp": 1, "fsdp": 2}, fsdp=True)),
    }, world=2)
    return four, two


def test_engine_commits_a_verified_checkpoint(worlds):
    four, _ = worlds
    for r in four:
        assert r["save_dp"]["verified"] == (True, "verified")
        assert r["save_full"]["verified"] == (True, "verified")


def test_restore_onto_fsdp_mesh_bitwise_equal(worlds):
    """The dp checkpoint on the 2x2 mesh: every parameter and optimizer
    slot bitwise the saved one after gathering, the step carried, and the
    placement the new strategy's: parameters split along fsdp, each rank
    holding its block of the saved tensor."""
    four, _ = worlds
    saved = four[0]["save_dp"]["host"]
    for rank, r in enumerate(four):
        got = r["on_hybrid"]
        assert got["mesh"] == HYBRID and got["step"] == 1
        _assert_bitwise(saved, got["host"])
        dims = got["local"]["dims"]
        assert dims and set(dims) == set(saved["params"])  # min_weight_size=1: every array splits
        fsdp_index = rank % 2
        for name, d in dims.items():
            block = saved["params"][name].chunk(2, d)[fsdp_index]
            assert torch.equal(got["local"]["shards"][name], block), name
            trace = saved["opt_state"]["trace"][name].chunk(2, d)[fsdp_index]
            assert torch.equal(got["local"]["opt_state"]["trace"][name], trace), name


def test_state_shardings_match_create_state_placement(worlds):
    """The placement ``state_shardings`` derives is the one the new
    strategy's ``create_state`` produced: parameters and their momentum
    alike."""
    four, _ = worlds
    for r in four:
        got = r["on_hybrid"]
        dims = got["local"]["dims"]
        for name, spec in got["derived"]["params"].items():
            assert spec.index("fsdp") == dims[name]
        assert got["derived"]["trace"] == got["derived"]["params"]


def test_round_trip_dp_to_hybrid_and_back(worlds):
    """Saved FROM the sharded placement (every rank gathers, rank 0
    writes) and landed back on the dp mesh: the bytes never change, only
    the placement does."""
    four, _ = worlds
    saved = four[0]["save_dp"]["host"]
    for r in four:
        back = r["back_on_dp"]
        _assert_bitwise(saved, back["host"])
        assert back["local"]["dims"] == {} and back["mesh"] == {"dp": 4}


def test_elastic_shrink_onto_smaller_hybrid_mesh(worlds):
    """A fully sharded 2x2 state, committed by the engine, resumed by a
    world of half the ranks on ``{"dp": 1, "fsdp": 2}``."""
    four, two = worlds
    saved = four[0]["save_full"]["host"]
    for r in four[1:]:
        _assert_bitwise(saved, r["save_full"]["host"])  # every rank saw the same gathered state
    for r in two:
        got = r["shrunk"]
        assert got["mesh"] == {"dp": 1, "fsdp": 2} and got["step"] == 1
        _assert_bitwise(saved, got["host"])
        assert got["local"]["dims"]


def test_explicit_shardings_override(worlds):
    four, _ = worlds
    for rank, r in enumerate(four):
        placed = r["bare"]["explicit"]
        assert placed["step"] == 4
        assert torch.equal(placed["w"], torch.arange(32, dtype=torch.float32)[8 * rank:8 * (rank + 1)])


def test_strategy_replicates_bare_pytree(worlds):
    four, _ = worlds
    for r in four:
        placed = r["bare"]["by_strategy"]
        assert placed["step"] == 4 and torch.equal(placed["w"], torch.arange(32, dtype=torch.float32))


def test_shard_params_keeps_this_ranks_block(worlds):
    """``shard_params`` with a spec splitting the columns along ``fsdp``:
    each rank of a dp row holds its half of the columns."""
    four, _ = worlds
    w = torch.arange(32, dtype=torch.float32).view(4, 8)
    for rank, r in enumerate(four):
        assert torch.equal(r["bare"]["shard_params"], w[:, 4 * (rank % 2):4 * (rank % 2) + 4])


def test_requires_strategy_or_shardings(tmp_path):
    from tensorflowonspark_tpu_torch.ckpt.reshard import reshard_restore

    with pytest.raises(ValueError, match="strategy or explicit shardings"):
        reshard_restore(str(tmp_path / "ckpt_4"))
