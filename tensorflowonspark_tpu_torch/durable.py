"""Shared crash-consistency primitives for the tmp+fsync+rename idiom.

Every durable commit point in the tree (checkpoint manifests, registry
journal/manifest, slab-cache generations, model pointers, flight-recorder
segments, executor bootstrap state) publishes by renaming a fully-written
staging path onto its final name. The rename makes the publish *atomic*;
it does not make it *durable* — after a power cut the filesystem may
replay the directory without the new entry even though both files'
contents were fsynced. Durability needs the parent directory's entry
fsynced too, which is what these helpers centralize (and what the
``commit-discipline`` rule of ``python -m tosa`` enforces at every
publish site; see the "Durable commit points" table in
docs/architecture.md).

This module is a leaf on purpose: no intra-package imports, so ckpt/,
obs/ and the registry can all use it without cycles.
"""

import errno
import logging
import os

logger = logging.getLogger(__name__)


def fsync_dir(path):
    """fsync a directory's entry table so renames/creates inside it
    survive a power cut. Best-effort: some filesystems (and all of
    Windows) refuse O_RDONLY fsync on directories — losing the *entry*
    durability there is strictly no worse than not trying."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return False
    try:
        os.fsync(fd)
        return True
    except OSError as e:
        if e.errno not in (errno.EINVAL, errno.EBADF, errno.ENOTSUP):
            logger.debug("directory fsync of %s failed: %s", path, e)
        return False
    finally:
        os.close(fd)


def fsync_file(path):
    """fsync an already-written file by path (for writers like np.savez
    that own the file handle internally). Best-effort like fsync_dir."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return False
    try:
        os.fsync(fd)
        return True
    except OSError:
        return False
    finally:
        os.close(fd)
