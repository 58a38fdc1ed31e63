"""JAX-package variables → the port's ``state_dict``.

Takes the flax variables of a JAX-package model as host numpy
(``{"params": ..., "batch_stats": ...}``, nested dicts keyed by submodule
name) and returns the tensors the port's module of the same architecture
loads, name for name:

* conv ``kernel`` HWIO → ``weight`` OIHW;
* Dense ``kernel`` ``[in, out]`` → ``weight`` ``[out, in]``;
* attention ``q``/``k``/``v`` ``kernel`` ``[d_model, H, D]`` → ``weight``
  ``[H·D, d_model]``, ``o`` ``kernel`` ``[H, D, d_model]`` → ``weight``
  ``[d_model, H·D]``;
* Embed ``embedding`` ``[vocab, d_model]`` → ``weight`` (as it is);
* BatchNorm and RMSNorm ``scale`` / ``bias`` → ``weight`` / ``bias``;
* ``batch_stats`` ``mean`` / ``var`` → ``running_mean`` / ``running_var``.

Any key left unmatched on either side raises, as does a shape mismatch:
a silently partial load would train a different model.

:func:`convert_train_state` carries a whole JAX-package ``TrainState``
(``step``, ``params``, ``batch_stats`` and the optax state) onto the port's
:class:`~tensorflowonspark_tpu_torch.train.strategy.TrainState`, so a run
checkpointed by the JAX package continues in the port.
"""

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight"}
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
        elif arr.ndim == 3 and path[-2] == "o":  # [H, D, out] -> [out, H*D]
            arr = arr.reshape(-1, arr.shape[2]).T
        elif arr.ndim == 3:  # DenseGeneral [in, H, D] -> [H*D, in]
            arr = arr.reshape(arr.shape[0], -1).T
        else:
            raise ValueError("kernel {} has unexpected rank {}".format("/".join(path), arr.ndim))
    name = ".".join(path[:-1] + (leaves[leaf],))
    return name, torch.from_numpy(np.array(arr, order="C"))  # a writable copy


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


def _optax_parts(opt_state):
    """The parts of an optax state that hold something, by kind: ``trace``
    (``TraceState``), ``adam`` (``ScaleByAdamState``: count, mu, nu),
    ``count`` (``ScaleByScheduleState``). optax states are named tuples,
    read by their fields (the port imports no optax); a chain is a plain
    tuple of them. Any other state that holds arrays raises."""
    parts = {}
    pending = [opt_state]
    while pending:
        node = pending.pop(0)
        fields = getattr(node, "_fields", None)
        if fields is None and isinstance(node, (tuple, list)):
            pending.extend(node)
            continue
        fields = tuple(fields or ())
        if fields == ():
            continue  # EmptyState and the like
        if fields == ("trace",):
            kind = "trace"
        elif fields == ("count", "mu", "nu"):
            kind = "adam"
        elif fields == ("count",):
            kind = "count"
        else:
            raise KeyError("no port counterpart for optax state {} {}".format(
                type(node).__name__, fields))
        if kind in parts:
            raise KeyError("optax state holds two {} states".format(kind))
        parts[kind] = node
    return parts


def _param_tree(tree, module, what):
    """A params-shaped tree (numpy leaves) → ``{name: tensor}`` under the
    module's parameter names, with every name matched and shapes equal."""
    out = dict(_convert_leaf("params", path, value) for path, value in _flatten(tree))
    expected = dict(module.named_parameters())
    missing, extra = sorted(set(expected) - set(out)), sorted(set(out) - set(expected))
    if missing or extra:
        raise KeyError("unmatched {} leaves: missing in JAX {}, no port counterpart for {}".format(
            what, missing, extra))
    for name, tensor in out.items():
        if tuple(tensor.shape) != tuple(expected[name].shape):
            raise ValueError("{} {}: JAX shape {} vs port shape {}".format(
                what, name, tuple(tensor.shape), tuple(expected[name].shape)))
    return out


@torch.no_grad()
def convert_train_state(jax_state, state):
    """Carry a JAX-package ``TrainState`` (host numpy leaves, e.g. from
    ``jax.device_get`` or a restored orbax checkpoint) onto the port's
    ``state`` in place: ``step``, the parameters and ``batch_stats`` (as
    :func:`load_variables`), and the optimizer state of the optimizers the
    examples use, leaf for leaf with the parameters' layout rules:

    * ``optax.sgd(lr, momentum)``: ``TraceState.trace`` → ``opt_state["trace"]``;
    * ``optax.adamw``: ``ScaleByAdamState.mu`` / ``nu`` → ``opt_state["mu"]`` /
      ``["nu"]``.

    The port's ``count`` comes from the state that owns it (Adam's, else the
    learning-rate schedule's); an optax state with no count (a constant
    learning rate) has taken ``step`` updates. Every leaf must find its
    counterpart on both sides, or this raises before anything is copied.
    Returns ``state``."""
    variables = {"params": jax_state.params}
    model_state = getattr(jax_state, "model_state", None) or {}
    if model_state:
        if set(model_state) != {"batch_stats"}:
            raise KeyError("unknown model_state collections {}".format(sorted(model_state)))
        variables["batch_stats"] = model_state["batch_stats"]
    weights = convert_variables(variables, state.module)
    parts = _optax_parts(jax_state.opt_state)
    opt = state.opt_state
    slots = {}  # port opt_state key -> converted tree
    if "trace" in parts:
        slots["trace"] = _param_tree(parts["trace"].trace, state.module, "trace")
    if "adam" in parts:
        slots["mu"] = _param_tree(parts["adam"].mu, state.module, "mu")
        slots["nu"] = _param_tree(parts["adam"].nu, state.module, "nu")
    want = {k for k, v in opt.items() if k != "count" and v is not None}
    if set(slots) != want:
        raise KeyError("optax state holds {} where the port's optimizer holds {}".format(
            sorted(slots), sorted(want)))
    owner = parts.get("adam") or parts.get("count")
    count = int(np.asarray(owner.count)) if owner is not None else int(np.asarray(jax_state.step))
    state.module.load_state_dict(weights, strict=True)
    for key, tree in slots.items():
        for name, tensor in tree.items():
            opt[key][name].copy_(tensor)
    opt["count"].fill_(count)
    state.step = int(np.asarray(jax_state.step))
    return state
