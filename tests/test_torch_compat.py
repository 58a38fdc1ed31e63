"""The port's ``compat.py`` shims, as ``tests/test_dfutil.py``'s
``TestCompat`` holds the JAX package's, on the CPU."""

import numpy as np

from tensorflowonspark_tpu_torch import compat, gpu_info
from tensorflowonspark_tpu_torch.train import checkpoint


class TestCompat:
    def test_shims(self, tmp_path):
        compat.disable_auto_shard(None)
        # every process exports, chief or not: is_chief is source-compat only
        path = compat.export_saved_model({"w": np.zeros((2,))}, str(tmp_path / "exp"), is_chief=False)
        assert path and (tmp_path / "exp").exists()
        assert isinstance(compat.is_tpu_available(), bool)

    def test_export_restores_and_device_probes(self, tmp_path, monkeypatch):
        """The export is a checkpoint that restores what was written; the
        port never runs on a TPU, and sees a card when ``gpu_info`` does."""
        path = compat.export_saved_model({"w": np.arange(3.0)}, str(tmp_path / "exp"))
        np.testing.assert_array_equal(checkpoint.restore_checkpoint(path)["w"].numpy(), np.arange(3.0))
        assert compat.is_tpu_available() is False
        assert compat.is_gpu_available() is (gpu_info.detect_local_chips() > 0)
        monkeypatch.setenv(gpu_info.ENV_DEVICE_COUNT, "2")
        assert compat.is_gpu_available() is True
        monkeypatch.setenv(gpu_info.ENV_DEVICE_COUNT, "0")
        assert compat.is_gpu_available() is False
