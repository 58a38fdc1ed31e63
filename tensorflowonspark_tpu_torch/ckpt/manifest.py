"""The atomic-commit manifest: per-file sizes + checksums, written last.

A checkpoint directory is *published* in three ordered steps (the engine's
commit protocol, :mod:`tensorflowonspark_tpu_torch.ckpt.engine`):

1. shards land in a staging dir (``tmp.ckpt_<step>``),
2. ``MANIFEST.json`` — every file's size and CRC32 — is written last,
3. one ``os.rename`` moves the staging dir to its final ``ckpt_<step>`` name.

Because the manifest is written after every shard and the rename is atomic
on a POSIX filesystem, a crash at any point leaves either (a) a staging dir
with no manifest (never considered by restore) or (b) a fully-described
published checkpoint. ``verify`` then lets ``restore_latest`` *cheap-check*
integrity — stat + checksum instead of attempting a full orbax restore and
catching whatever it throws (the pre-manifest fallback path, which still
covers legacy manifest-less checkpoints).
"""

import json
import logging
import os
import zlib

from tensorflowonspark_tpu_torch import durable

logger = logging.getLogger(__name__)

#: the commit marker file, written last inside the staging dir
MANIFEST_NAME = "MANIFEST.json"
#: manifest format version (bump on incompatible layout changes)
VERSION = 1
#: checksum read chunk (checkpoint shards can be GBs; never slurp them)
_CHUNK = 1 << 20


def _file_crc32(path):
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _walk_files(root):
    """Relative paths of every regular file under ``root`` except the
    manifest itself, sorted for deterministic manifests."""
    out = []
    for base, _dirs, names in os.walk(root):
        for name in names:
            rel = os.path.relpath(os.path.join(base, name), root)
            if rel != MANIFEST_NAME:
                out.append(rel)
    return sorted(out)


def write_manifest(path, step=None, extra=None):
    """Write ``MANIFEST.json`` describing every file currently under
    ``path``. MUST be the last write before the publishing rename — the
    manifest's presence is the commit marker. The manifest itself is
    written via a same-directory temp file + rename so a torn manifest
    write can never masquerade as a complete one. Returns the manifest
    dict."""
    path = os.path.abspath(os.path.expanduser(path))
    files = {}
    for rel in _walk_files(path):
        sub = os.path.join(path, rel)
        files[rel] = {"size": os.path.getsize(sub), "crc32": _file_crc32(sub)}
    manifest = {"version": VERSION, "step": step, "files": files}
    if extra:
        manifest["extra"] = dict(extra)
    tmp = os.path.join(path, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, os.path.join(path, MANIFEST_NAME))
    # the rename is only durable once the directory entry is: a power cut
    # after fsync(file) but before fsync(dir) can replay the directory
    # without MANIFEST.json even though its bytes hit the platter
    durable.fsync_dir(path)
    return manifest


def read_manifest(path):
    """Parse ``path``'s manifest; returns the dict, or None when absent
    (legacy checkpoints saved before the async engine)."""
    mpath = os.path.join(os.path.abspath(os.path.expanduser(path)), MANIFEST_NAME)
    if not os.path.isfile(mpath):
        return None
    with open(mpath) as f:
        return json.load(f)


def verify(path):
    """Cheap integrity check of a published checkpoint against its manifest.

    Returns ``(ok, reason)``: ``(True, "verified")`` when every listed file
    exists with the recorded size and CRC32, ``(True, "no manifest")`` for
    legacy checkpoints (caller falls back to attempt-the-restore), and
    ``(False, reason)`` naming the first failure — torn manifest JSON,
    missing file, size mismatch, checksum mismatch — so ``restore_latest``
    can log *why* a candidate was skipped."""
    path = os.path.abspath(os.path.expanduser(path))
    try:
        manifest = read_manifest(path)
    except (ValueError, OSError) as e:
        return False, "torn manifest ({})".format(e)
    if manifest is None:
        return True, "no manifest"
    if not isinstance(manifest.get("files"), dict):
        return False, "torn manifest (no file table)"
    for rel, meta in sorted(manifest["files"].items()):
        sub = os.path.join(path, rel)
        try:
            size = os.path.getsize(sub)
        except OSError:
            return False, "missing file {}".format(rel)
        if size != meta.get("size"):
            return False, "size mismatch on {} ({} != {})".format(
                rel, size, meta.get("size")
            )
        if _file_crc32(sub) != meta.get("crc32"):
            return False, "checksum mismatch on {}".format(rel)
    return True, "verified"
