"""JAX-package variables → the port's ``state_dict``.

Takes the flax variables of a JAX-package model as host numpy
(``{"params": ..., "batch_stats": ...}``, nested dicts keyed by submodule
name) and returns the tensors the port's module of the same architecture
loads, name for name:

* conv ``kernel`` HWIO → ``weight`` OIHW;
* Dense ``kernel`` ``[in, out]`` → ``weight`` ``[out, in]``;
* BatchNorm ``scale`` / ``bias`` → ``weight`` / ``bias``;
* ``batch_stats`` ``mean`` / ``var`` → ``running_mean`` / ``running_var``.

Any key left unmatched on either side raises, as does a shape mismatch:
a silently partial load would train a different model.
"""

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _convert_leaf(collection, path, value):
    leaves = _PARAM_LEAVES if collection == "params" else _STAT_LEAVES
    leaf = path[-1]
    if leaf not in leaves:
        raise KeyError("no port counterpart for {}/{}".format(collection, "/".join(path)))
    arr = np.asarray(value, dtype=np.float32)
    if leaf == "kernel":
        if arr.ndim == 4:  # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:  # [in, out] -> [out, in]
            arr = arr.T
        else:
            raise ValueError("kernel {} has unexpected rank {}".format("/".join(path), arr.ndim))
    name = ".".join(path[:-1] + (leaves[leaf],))
    return name, torch.from_numpy(np.ascontiguousarray(arr))


def convert_variables(variables, module=None):
    """``variables`` (``{"params": ..., "batch_stats": ...}``, numpy leaves)
    → ``{name: tensor}``. With ``module``, every one of its ``state_dict``
    entries must be produced with the same shape, and nothing else."""
    out = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise KeyError("unknown variable collection {!r}".format(collection))
        for path, value in _flatten(tree):
            name, tensor = _convert_leaf(collection, path, value)
            out[name] = tensor
    if module is not None:
        expected = module.state_dict()
        missing = sorted(set(expected) - set(out))
        extra = sorted(set(out) - set(expected))
        if missing or extra:
            raise KeyError(
                "unmatched keys converting JAX variables: missing in JAX {}, "
                "no port counterpart for {}".format(missing, extra)
            )
        for name, tensor in out.items():
            if tuple(tensor.shape) != tuple(expected[name].shape):
                raise ValueError("{}: JAX shape {} vs port shape {}".format(
                    name, tuple(tensor.shape), tuple(expected[name].shape)))
    return out


def load_variables(module, variables):
    """Convert ``variables`` and load them into ``module`` (strict)."""
    module.load_state_dict(convert_variables(variables, module), strict=True)
    return module
