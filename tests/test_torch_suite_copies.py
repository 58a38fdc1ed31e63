"""The port's copies of the JAX package's control- and checkpoint-plane suites keep every
assertion of the reference.

Each suite below was copied with the package name rewritten; a copy whose
child ran JAX was rewritten on torch. This guard reads both files as text
(it imports neither): every ``assert`` statement of the reference, unparsed
and with the package name rewritten, must stand in the copy as it is, as
many times as in the reference, and every test function of the reference
must exist there. The few statements a copy had to restate are listed in
``RESTATED`` beside their port form, which must then stand in the copy
instead, as often; the renamed tests are in ``RENAMED``.
"""

import ast
import collections
import os
import re

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))

#: reference suite → its port copy
SUITES = {
    "test_{}.py".format(name): "test_torch_{}.py".format(name)
    for name in (
        "TFCluster", "TFNode", "backends_context", "chaos_cluster", "chaos_control", "chaos_feed",
        "chaos_plan", "chaos_reservation", "chaos_text", "control", "local_backend", "obs_cluster",
        "obs_registry", "pyspark_compat", "registry", "reservation", "resilience", "shm", "streaming",
        "tracing", "watchdog", "trace_smoke", "pipeline_pyspark_ml", "ckpt_engine", "ckpt_manifest",
        "ckpt_chaos", "chaos_checkpoint",
    )
}
SUITES["test_jax_distributed.py"] = "test_torch_distributed.py"

#: reference statement → the copy's, where the reference's names a JAX API
#: or a JAX-only count
RESTATED = {
    "test_jax_distributed.py": {
        # jax.process_count() / jax.device_count(): the world's ranks and
        # devices, read from torch.distributed in the child
        "assert jax.process_count() == num_procs, jax.process_count()":
            "assert process_count == num_procs, process_count",
        # each JAX process held 2 virtual CPU devices; a torch rank holds 1
        "assert jax.device_count() == 2 * num_procs, jax.device_count()":
            "assert device_count == num_procs, device_count",
        "assert all((r['device_count'] == 4 for r in reports)), reports":
            "assert all((r['device_count'] == 2 for r in reports)), reports",
    },
    # the port names its trainer child's process (and flight shard)
    # trainer-<job>-<index>, the JAX package jax-<job>-<index>
    "test_trace_smoke.py": {
        "assert any((p.startswith('jax-') for p in procs))":
            "assert any((p.startswith('trainer-') for p in procs))",
    },
    # the same child's name in an assertion's message
    "test_ckpt_chaos.py": {
        "assert _chaos.active, 'chaos plan did not reach the jax child'":
            "assert _chaos.active, 'chaos plan did not reach the trainer child'",
    },
}

#: reference test → the copy's, where the name said JAX
RENAMED = {
    "test_TFCluster.py": {"test_inference_roundtrip_jax": "test_inference_roundtrip_torch"},
}


def _port(text):
    return re.sub(r"\btensorflowonspark_tpu\b", "tensorflowonspark_tpu_torch", text)


def _parse(name):
    with open(os.path.join(TESTS, name)) as f:
        return ast.parse(f.read(), filename=name)


def _asserts(tree):
    return collections.Counter(ast.unparse(node) for node in ast.walk(tree) if isinstance(node, ast.Assert))


def _tests(tree):
    return {node.name for node in ast.walk(tree)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name.startswith("test")}


@pytest.mark.parametrize("reference", sorted(SUITES))
def test_copy_keeps_every_reference_assertion(reference):
    ref, copy = _parse(reference), _parse(SUITES[reference])
    restated = RESTATED.get(reference, {})
    have = _asserts(copy)
    want = collections.Counter({_port(stmt): n for stmt, n in _asserts(ref).items()})
    assert not set(restated) - set(want), "RESTATED names statements the reference no longer holds"
    for stmt, port in restated.items():
        have[stmt] += have[port]  # the restated form stands for the reference's
    missing = sorted((want - have).elements())
    assert not missing, "{} drops or changes {} assertion(s) of {}: {}".format(
        SUITES[reference], len(missing), reference, missing)
    renamed = RENAMED.get(reference, {})
    lost = sorted(renamed.get(name, name) for name in _tests(ref) if renamed.get(name, name) not in _tests(copy))
    assert not lost, "{} lacks tests of {}: {}".format(SUITES[reference], reference, lost)
