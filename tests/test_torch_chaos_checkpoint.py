"""Chaos: checkpoint faults and the resume contract.

``checkpoint.corrupt_write`` leaves the newest checkpoint torn on disk (the
shape a mid-write host crash produces); ``checkpoint.restore_fail`` makes a
restore raise once. :func:`checkpoint.restore_latest` must fall back to the
newest *restorable* checkpoint instead of dying — the "recovery relaunches
past a poisoned checkpoint" half of the chaos acceptance bar. Also covers
the `latest_checkpoint` prefix-mismatch warning."""

import logging
import os

import pytest

from tensorflowonspark_tpu_torch import chaos
from tensorflowonspark_tpu_torch.train import checkpoint

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.uninstall()
    yield
    chaos.uninstall()


def _save_steps(model_dir, steps):
    for step in steps:
        checkpoint.save_checkpoint(
            os.path.join(model_dir, "ckpt_{}".format(step)),
            {"step": step, "w": [float(step)] * 4},
        )


class TestRestoreLatestFallback:
    def test_corrupt_newest_falls_back_to_previous(self, tmp_path):
        model_dir = str(tmp_path)
        _save_steps(model_dir, [1, 2])
        # corrupt the NEWEST save only
        chaos.install(
            chaos.ChaosPlan(seed=0).site("checkpoint.corrupt_write", probability=1.0,
                                         max_count=1),
            propagate=False,
        )
        _save_steps(model_dir, [3])
        chaos.uninstall()

        state, path = checkpoint.restore_latest(model_dir)
        assert os.path.basename(path) == "ckpt_2"
        assert state["step"] == 2

    def test_restore_fail_once_falls_back_then_heals(self, tmp_path):
        model_dir = str(tmp_path)
        _save_steps(model_dir, [1, 2])
        plan = chaos.ChaosPlan(seed=0).site(
            "checkpoint.restore_fail", probability=1.0, max_count=1
        )
        chaos.install(plan, propagate=False)
        state, path = checkpoint.restore_latest(model_dir)
        # the injected failure hit ckpt_2; the fallback restored ckpt_1
        assert plan.fired("checkpoint.restore_fail") == 1
        assert os.path.basename(path) == "ckpt_1"
        assert state["step"] == 1
        # fault budget spent: the next resume sees the newest again
        state, path = checkpoint.restore_latest(model_dir)
        assert os.path.basename(path) == "ckpt_2"

    def test_every_checkpoint_corrupt_raises(self, tmp_path):
        model_dir = str(tmp_path)
        _save_steps(model_dir, [1])
        chaos.install(
            chaos.ChaosPlan(seed=0).site("checkpoint.restore_fail", probability=1.0),
            propagate=False,
        )
        with pytest.raises(IOError):
            checkpoint.restore_latest(model_dir)

    def test_empty_dir_is_clean_fresh_start(self, tmp_path):
        assert checkpoint.restore_latest(str(tmp_path)) == (None, None)

    def test_restore_latest_with_train_state_target(self, tmp_path):
        """The fallback path preserves the targeted-restore contract used by
        the training examples (structure/shardings from a fresh state)."""
        import torch

        from tensorflowonspark_tpu_torch.models import mnist
        from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

        model_dir = str(tmp_path)
        strategy = SyncDataParallel("cpu")

        def fresh_state(seed):
            model = mnist.create_model("mlp", hidden=8)
            return strategy.create_state(
                mnist.make_init_fn(model), optim.sgd(0.1), torch.Generator().manual_seed(seed)
            )

        host_state = fresh_state(0)
        saved = {k: v.detach().clone() for k, v in host_state.params.items()}
        checkpoint.save_checkpoint(os.path.join(model_dir, "ckpt_5"), host_state)
        chaos.install(
            chaos.ChaosPlan(seed=0).site("checkpoint.corrupt_write", probability=1.0),
            propagate=False,
        )
        checkpoint.save_checkpoint(os.path.join(model_dir, "ckpt_9"), host_state)
        chaos.uninstall()

        # a target from another seed: the restore, not the init, must
        # supply the saved tensors
        restored, path = checkpoint.restore_latest(model_dir, target=fresh_state(1))
        assert os.path.basename(path) == "ckpt_5"
        for name, want in saved.items():
            assert torch.equal(restored.params[name], want), name


class TestPrefixMismatchWarning:
    def test_warns_when_numbered_dirs_miss_the_prefix(self, tmp_path, caplog):
        os.makedirs(str(tmp_path / "model_3"))
        os.makedirs(str(tmp_path / "model_7"))
        with caplog.at_level(logging.WARNING, logger="tensorflowonspark_tpu_torch.train.checkpoint"):
            assert checkpoint.latest_checkpoint(str(tmp_path)) is None
        joined = " ".join(r.getMessage() for r in caplog.records)
        assert "none match" in joined and 'prefix=""' in joined and "model_7" in joined

    def test_no_warning_for_empty_or_matching_dirs(self, tmp_path, caplog):
        with caplog.at_level(logging.WARNING, logger="tensorflowonspark_tpu_torch.train.checkpoint"):
            assert checkpoint.latest_checkpoint(str(tmp_path)) is None  # empty: quiet
            os.makedirs(str(tmp_path / "ckpt_4"))
            assert checkpoint.latest_checkpoint(str(tmp_path)).endswith("ckpt_4")
        assert not caplog.records

    def test_prefix_escape_hatch_accepts_any_layout(self, tmp_path):
        os.makedirs(str(tmp_path / "model_3"))
        assert checkpoint.latest_checkpoint(str(tmp_path), prefix="").endswith("model_3")
