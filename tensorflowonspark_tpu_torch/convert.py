"""JAX-package variables → the port's ``state_dict``.

Takes the flax variables of a JAX-package model as host numpy
(``{"params": ..., "batch_stats": ...}``, nested dicts keyed by submodule
name) and returns the tensors the port's module of the same architecture
loads, name for name:

* conv ``kernel`` HWIO → ``weight`` OIHW;
* ConvTranspose ``kernel`` (the U-Net's ``up<d>`` layers) ``[kh, kw, in,
  out]`` → ``weight`` ``[in, out, kh, kw]``, flipped in both spatial axes:
  flax's ``nn.ConvTranspose`` (``transpose_kernel=False``) runs its kernel
  over the stride-dilated input as it is, where ``ConvTranspose2d``, the
  gradient of a conv, runs it flipped;
* Dense ``kernel`` ``[in, out]`` → ``weight`` ``[out, in]``;
* attention ``q``/``k``/``v`` ``kernel`` ``[d_model, H, D]`` → ``weight``
  ``[H·D, d_model]``, ``o`` ``kernel`` ``[H, D, d_model]`` → ``weight``
  ``[d_model, H·D]``;
* Embed ``embedding`` ``[vocab, d_model]`` → ``weight`` (as it is);
* a mixture of experts' ``moe/wi`` ``[E, d_model, d_ff]`` and ``moe/wo``
  ``[E, d_ff, d_model]`` as they are (the port keeps the flax layout), its
  ``router`` as a Dense;
* BatchNorm, GroupNorm and RMSNorm ``scale`` / ``bias`` → ``weight`` /
  ``bias``;
* ``batch_stats`` ``mean`` / ``var`` → ``running_mean`` / ``running_var``.

Any key left unmatched on either side raises, as does a shape mismatch:
a silently partial load would train a different model. A module built on a
mesh (``models.transformer.create_model(mesh=...)``) holds this rank's
blocks of the tensors its ``model_specs`` split over ``tp`` or ``ep``: the
full tensors are converted, checked against its ``full_shapes`` and cut to
those blocks (:func:`local_blocks`).

:func:`convert_train_state` carries a whole JAX-package ``TrainState``
(``step``, ``params``, ``batch_stats`` and the optax state) onto the port's
:class:`~tensorflowonspark_tpu_torch.train.strategy.TrainState`, so a run
checkpointed by the JAX package continues in the port.
"""

import re

import numpy as np
import torch

#: module names of flax ``nn.ConvTranspose`` layers (the U-Net's upsamplers)
_CONV_TRANSPOSE = re.compile(r"up\d+$")
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
    if collection == "params" and len(path) > 1 and path[-2] == "moe" and leaf in ("wi", "wo"):
        return ".".join(path), torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
    if leaf not in leaves:
        raise KeyError("no port counterpart for {}/{}".format(collection, "/".join(path)))
    arr = np.asarray(value, dtype=np.float32)
    if leaf == "kernel":
        if arr.ndim == 4 and _CONV_TRANSPOSE.match(path[-2]):  # [kh, kw, in, out] -> [in, out, kh, kw]
            arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        elif arr.ndim == 4:  # HWIO -> OIHW
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
        expected = _full_shapes(module)
        missing = sorted(set(expected) - set(out))
        extra = sorted(set(out) - set(expected))
        if missing or extra:
            raise KeyError(
                "unmatched keys converting JAX variables: missing in JAX {}, "
                "no port counterpart for {}".format(missing, extra)
            )
        for name, tensor in out.items():
            if tuple(tensor.shape) != expected[name]:
                raise ValueError("{}: JAX shape {} vs port shape {}".format(
                    name, tuple(tensor.shape), expected[name]))
        out = local_blocks(out, module)
    return out


def _full_shapes(module):
    """``{name: shape}`` of the module's whole state: its ``state_dict``'s,
    with each block of a model on a mesh at its full shape."""
    full = getattr(module, "full_shapes", {})
    return {n: tuple(full.get(n, t.shape)) for n, t in module.state_dict().items()}


def local_blocks(tensors, module):
    """``{name: full tensor}`` → the same with each tensor the module holds
    a block of (its ``model_specs``: a model built on a mesh) cut to this
    rank's block; the others as they are."""
    from tensorflowonspark_tpu_torch.parallel.sharding import block

    out = dict(tensors)
    for name, spec in getattr(module, "model_specs", {}).items():
        if name in out:
            out[name] = block(out[name], spec, module.mesh).contiguous().clone()
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
    shapes = _full_shapes(module)
    expected = {n: shapes[n] for n, _ in module.named_parameters()}
    missing, extra = sorted(set(expected) - set(out)), sorted(set(out) - set(expected))
    if missing or extra:
        raise KeyError("unmatched {} leaves: missing in JAX {}, no port counterpart for {}".format(
            what, missing, extra))
    for name, tensor in out.items():
        if tuple(tensor.shape) != expected[name]:
            raise ValueError("{} {}: JAX shape {} vs port shape {}".format(
                what, name, tuple(tensor.shape), expected[name]))
    return local_blocks(out, module)


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


def flax_layouts(module):
    """``{name: (flax_shape, dims)}`` for each of ``module``'s parameters:
    the shape its JAX-package counterpart has (the converter's rules above,
    read backwards), and for each flax dimension the port's dimension it
    lands in (``dims[i]``). A fused port dimension takes several flax ones
    (an attention projection's heads and head dim), major first. The
    sharding rules (``parallel/sharding.py``) pick a dimension on the flax
    shape, as the JAX package does, and shard the port's ``dims[i]``. A
    module built on a mesh reports its whole tensors' layouts (its
    ``full_shapes``)."""
    modules = dict(module.named_modules())
    full = getattr(module, "full_shapes", {})
    out = {}
    for name, p in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = modules[owner_name]
        parent = modules.get(owner_name.rpartition(".")[0]) if owner_name else None
        cfg = getattr(parent, "cfg", None)
        attn = owner_name.rpartition(".")[2] if cfg is not None and hasattr(cfg, "n_heads") else None
        s = tuple(full.get(name, p.shape))
        if leaf != "weight" or len(s) < 2 or isinstance(owner, torch.nn.Embedding):
            layout = (s, tuple(range(len(s))))
        elif len(s) == 4 and isinstance(owner, torch.nn.ConvTranspose2d):  # [in, out, kh, kw]
            layout = ((s[2], s[3], s[0], s[1]), (2, 3, 0, 1))
        elif len(s) == 4:  # OIHW <- HWIO
            layout = ((s[2], s[3], s[1], s[0]), (2, 3, 1, 0))
        elif attn in ("q", "k", "v"):  # [H*D, d_model] <- [d_model, H, D]
            layout = ((s[1], cfg.n_heads, s[0] // cfg.n_heads), (1, 0, 0))
        elif attn == "o":  # [d_model, H*D] <- [H, D, d_model]
            layout = ((cfg.n_heads, s[1] // cfg.n_heads, s[0]), (1, 1, 0))
        else:  # Dense [out, in] <- [in, out]
            layout = ((s[1], s[0]), (1, 0))
        out[name] = layout
    return out


def flax_names(module):
    """``{name: flax path}`` of each of ``module``'s parameters (the
    converter's names read backwards): a 2-D or larger ``weight`` is a
    ``kernel`` (an Embedding's an ``embedding``), a 1-D one a norm's
    ``scale``, and any other leaf keeps its name."""
    modules = dict(module.named_modules())
    out = {}
    for name, p in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        if leaf == "weight":
            if isinstance(modules[owner_name], torch.nn.Embedding):
                leaf = "embedding"
            else:
                leaf = "scale" if p.dim() == 1 else "kernel"
        out[name] = "/".join(owner_name.split(".") + [leaf]) if owner_name else leaf
    return out
