"""``nvcc`` at first use for the package's CUDA sources (``csrc/*.cu``).

Each source is compiled on its own into a shared library with a plain C
interface, named after the source and a hash of its bytes and the flags
(``build/cuda/<stem>_<hash>.so`` in the checkout, so a stale build is never
loaded), and bound with ``ctypes`` by the ops module that owns it. The
``-Xptxas -v`` report lands beside the library (``.log``).
"""

import hashlib
import os
import re
import shutil
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(ROOT, "tensorflowonspark_tpu_torch", "csrc")
BUILD_DIR = os.path.join(ROOT, "build", "cuda")
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc():
    for path in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def library_path(source, build_dir=BUILD_DIR):
    """Where the build of ``source`` lives: ``<build_dir>/<stem>_<hash>.so``,
    the hash over the source and the flags."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(build_dir, "{}_{}.so".format(stem, digest))


def build(source, build_dir=BUILD_DIR):
    """Compile ``source`` if it has no build yet (``nvcc`` writes to a
    private name, renamed into place, so concurrent processes never load a
    half-written library); returns the path of the library."""
    path = library_path(source, build_dir)
    if os.path.isfile(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    tmp = "{}.{}.tmp".format(path, os.getpid())
    out = subprocess.run([_nvcc()] + NVCC_FLAGS + ["-o", tmp, source],
                         capture_output=True, text=True, timeout=600)
    with open(path[:-3] + ".log", "w") as f:
        f.write(out.stdout + out.stderr)
    if out.returncode != 0:
        raise RuntimeError("nvcc failed to build {}:\n{}".format(source, out.stderr[-4000:]))
    os.replace(tmp, path)
    return path


def ptxas_report(log_path):
    """Registers and spill bytes of each entry function in an ``nvcc
    -Xptxas -v`` log: ``[{"entry": mangled name, "registers",
    "spill_stores", "spill_loads"}, ...]`` in the log's order."""
    with open(log_path) as f:
        text = f.read()
    out, current = [], None
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            current = {"entry": entry.group(1)}
            out.append(current)
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            current["spill_stores"], current["spill_loads"] = map(int, spill.groups())
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            current["registers"] = int(regs.group(1))
    return out
