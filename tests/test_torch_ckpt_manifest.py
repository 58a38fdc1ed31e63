"""The manifest commit marker: write-last, cheap-verify, reject-with-reason.

Unit coverage for :mod:`tensorflowonspark_tpu_torch.ckpt.manifest` — the
integrity half of the async engine's atomic commit protocol. Every
rejection reason asserted here is a string ``restore_latest`` surfaces in
its skip log, so the shapes are pinned."""

import json
import os

from tensorflowonspark_tpu_torch.ckpt import manifest


def _make_ckpt(root, files):
    os.makedirs(root, exist_ok=True)
    for rel, payload in files.items():
        sub = os.path.join(root, rel)
        os.makedirs(os.path.dirname(sub), exist_ok=True)
        with open(sub, "wb") as f:
            f.write(payload)


class TestWriteManifest:
    def test_roundtrip_verifies(self, tmp_path):
        root = str(tmp_path / "ckpt_1")
        _make_ckpt(root, {"a.bin": b"hello", "sub/b.bin": b"world" * 100})
        m = manifest.write_manifest(root, step=1)
        assert set(m["files"]) == {"a.bin", os.path.join("sub", "b.bin")}
        assert m["files"]["a.bin"]["size"] == 5
        assert manifest.verify(root) == (True, "verified")

    def test_manifest_excludes_itself_and_leaves_no_temp(self, tmp_path):
        root = str(tmp_path / "ckpt_2")
        _make_ckpt(root, {"a.bin": b"x"})
        manifest.write_manifest(root, step=2)
        manifest.write_manifest(root, step=2)  # idempotent rewrite
        names = os.listdir(root)
        assert manifest.MANIFEST_NAME in names
        assert not any(n.endswith(".tmp") for n in names)
        assert set(manifest.read_manifest(root)["files"]) == {"a.bin"}

    def test_step_and_extra_recorded(self, tmp_path):
        root = str(tmp_path / "ckpt_3")
        _make_ckpt(root, {"a.bin": b"x"})
        manifest.write_manifest(root, step=3, extra={"mesh": "dp=8"})
        m = manifest.read_manifest(root)
        assert m["step"] == 3 and m["extra"] == {"mesh": "dp=8"}


class TestVerifyRejections:
    def _committed(self, tmp_path):
        root = str(tmp_path / "ckpt_9")
        _make_ckpt(root, {"a.bin": b"A" * 64, "b.bin": b"B" * 64})
        manifest.write_manifest(root, step=9)
        return root

    def test_no_manifest_is_legacy_ok(self, tmp_path):
        root = str(tmp_path / "old")
        _make_ckpt(root, {"a.bin": b"x"})
        assert manifest.verify(root) == (True, "no manifest")
        assert manifest.read_manifest(root) is None

    def test_missing_file(self, tmp_path):
        root = self._committed(tmp_path)
        os.remove(os.path.join(root, "b.bin"))
        ok, reason = manifest.verify(root)
        assert not ok and "missing file b.bin" in reason

    def test_size_mismatch(self, tmp_path):
        root = self._committed(tmp_path)
        with open(os.path.join(root, "a.bin"), "ab") as f:
            f.write(b"tail")
        ok, reason = manifest.verify(root)
        assert not ok and "size mismatch on a.bin" in reason

    def test_checksum_mismatch_same_size(self, tmp_path):
        root = self._committed(tmp_path)
        with open(os.path.join(root, "a.bin"), "r+b") as f:
            f.write(b"Z")  # flip bytes, keep the size
        ok, reason = manifest.verify(root)
        assert not ok and "checksum mismatch on a.bin" in reason

    def test_torn_manifest_json(self, tmp_path):
        root = self._committed(tmp_path)
        mpath = os.path.join(root, manifest.MANIFEST_NAME)
        with open(mpath, "r+b") as f:
            f.truncate(os.path.getsize(mpath) // 2)
        ok, reason = manifest.verify(root)
        assert not ok and "torn manifest" in reason

    def test_manifest_without_file_table(self, tmp_path):
        root = self._committed(tmp_path)
        with open(os.path.join(root, manifest.MANIFEST_NAME), "w") as f:
            json.dump({"version": 1}, f)
        ok, reason = manifest.verify(root)
        assert not ok and "no file table" in reason
