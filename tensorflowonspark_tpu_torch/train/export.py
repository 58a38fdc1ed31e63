"""Model export bundles — the port of the JAX package's ``train/export.py``.

A bundle is gathered final weights plus a cloudpickled **predict-fn
builder**: code and weights, restorable on any host without knowing the
architecture in advance. The bundle's layout and its weights file are the
JAX package's: ``predict_builder.pkl`` and ``weights.npz`` (flattened
``/``-joined tree paths → plain arrays), or ``weights.pkl`` for a state
that is not nested dicts of arrays.

The weights are gathered to host numpy here (``detach().cpu().numpy()``):
a ``{name: tensor}`` tree (a module's ``state_dict``, ``state.params``)
lands in the npz lane as plain arrays. A dtype numpy lacks (``bfloat16``)
is stored as its bytes with the dtype's name tagged in the key, as the JAX
package stores ml_dtypes leaves, and comes back as a CPU torch tensor.

Written by the chief alone, not through the collective checkpoint path
(``train/checkpoint.py``): a bundle is the serving artifact.

The builder is called at load time, so torch sets up the device only in
the serving process. A builder may take a ``device`` argument: then
:func:`load_model`'s ``device`` reaches it, and a builder builds its model on
the card unless the caller asks for the CPU (``device="cpu"``).

**Trust boundary.** A bundle is a *trusted artifact*: ``predict_builder.pkl``
is cloudpickled CODE, executed on load. Only load bundles you produced or
vetted. The safe lane: weights are written as ``weights.npz`` (loaded with
``allow_pickle=False``) whenever the tree is nested dicts of arrays, and
``load_model(export_dir, trusted_builder=...)`` takes the builder from YOUR
code (a callable or ``"module:attr"`` string), so nothing from the bundle
directory is ever unpickled.

Bundles of the JAX package's orbax era (a ``checkpoint/`` directory and no
weights file) do not load here.
"""

import importlib
import inspect
import logging
import os

import cloudpickle

from tensorflowonspark_tpu_torch import durable

logger = logging.getLogger(__name__)

_BUILDER_FILE = "predict_builder.pkl"
_WEIGHTS_FILE = "weights.pkl"  # fallback for non-dict-tree states
_WEIGHTS_NPZ = "weights.npz"  # safe lane: plain arrays, no pickle on load
_CKPT_DIR = "checkpoint"  # the JAX package's orbax-era lane, removed on export
#: npz key separator for flattened tree paths
_SEP = "/"
#: npz key suffix marking a leaf stored as bytes (a dtype numpy lacks)
_DTYPE_TAG = "::dtype="


def _torch_only_dtypes():
    import torch

    return {torch.bfloat16: "bfloat16"}


def _to_host(tree):
    """Tensors → host numpy (a dtype numpy lacks stays a CPU tensor);
    containers are rebuilt, other leaves pass through."""
    import torch

    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t if t.dtype in _torch_only_dtypes() else t.numpy()
    return tree


def export_model(export_dir, predict_builder, params, model_state=None):
    """Write a self-contained inference bundle.

    ``predict_builder`` is a picklable callable returning
    ``predict_fn(params, model_state, batch_arrays) -> outputs`` (a dict of
    named arrays or a single array); it may take a ``device`` argument (see
    :func:`load_model`). ``params``/``model_state`` are trees of tensors
    (gathered to host here) or of numpy arrays.
    """
    import numpy as np

    export_dir = os.path.abspath(os.path.expanduser(export_dir))
    os.makedirs(export_dir, exist_ok=True)
    state = _to_host({"params": params, "model_state": model_state or {}})
    # an empty model_state is omitted from the npz (load_model reconstructs
    # absent model_state as {}); an empty params tree has no such default and
    # rides the pickle fallback via _flatten_dict_tree's empty-dict rejection
    npz_tree = {k: v for k, v in state.items() if k != "model_state" or v}
    flat = _flatten_dict_tree(npz_tree)
    if flat is not None:
        tmp = os.path.join(export_dir, _WEIGHTS_NPZ + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(export_dir, _WEIGHTS_NPZ))
        durable.fsync_dir(export_dir)
        _remove_stale(export_dir, _WEIGHTS_FILE)
    else:
        logger.warning(
            "state tree is not nested dicts of arrays; falling back to "
            "pickled weights (the npz safe-load lane will be unavailable)"
        )
        tmp = os.path.join(export_dir, _WEIGHTS_FILE + ".tmp")
        with open(tmp, "wb") as f:
            cloudpickle.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(export_dir, _WEIGHTS_FILE))
        durable.fsync_dir(export_dir)
        _remove_stale(export_dir, _WEIGHTS_NPZ)
    # a re-export into an orbax-era bundle dir must not leave the old
    # checkpoint behind either
    _remove_stale(export_dir, _CKPT_DIR)
    with open(os.path.join(export_dir, _BUILDER_FILE), "wb") as f:
        cloudpickle.dump(predict_builder, f)
    logger.info("exported model bundle to %s", export_dir)
    return export_dir


def _remove_stale(export_dir, name):
    """Drop the OTHER weight lane's leftover so load_model can never pair
    this export's builder with a previous export's params."""
    import shutil

    path = os.path.join(export_dir, name)
    try:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
    except OSError as e:
        logger.warning("could not remove stale %s: %s", path, e)


def _flatten_dict_tree(tree):
    """Nested dicts of array-likes → {path: ndarray}, or None when the tree
    has non-dict containers / non-string / separator-bearing keys / object
    leaves (those fall back to the pickle lane)."""
    import numpy as np
    import torch

    out = {}
    tagged = _torch_only_dtypes()

    def _walk(prefix, node):
        if isinstance(node, dict):
            if not node:
                # npz cannot represent an empty subtree; a reload would drop
                # it and change the structure — pickle lane instead
                raise ValueError(prefix)
            for k, v in node.items():
                if not isinstance(k, str) or _SEP in k or _DTYPE_TAG in k:
                    raise ValueError(k)
                _walk(prefix + (k,), v)
        elif isinstance(node, (list, tuple)):
            # np.asarray would stack these into one ndarray, silently
            # changing the tree's structure on reload — pickle lane instead
            raise ValueError(prefix)
        elif isinstance(node, torch.Tensor) and node.dtype in tagged:
            # the JAX package's byte layout for an ml_dtypes leaf: the
            # element's bytes on a trailing axis
            raw = node.contiguous().reshape(tuple(node.shape) + (1,)).view(torch.uint8)
            out[_SEP.join(prefix) + _DTYPE_TAG + tagged[node.dtype]] = raw.numpy()
        else:
            arr = np.asarray(node)
            if arr.dtype.kind not in "biufcSUMm":
                raise ValueError(prefix)  # object leaves: pickle lane
            out[_SEP.join(prefix)] = arr

    try:
        _walk((), tree)
    except ValueError:
        return None
    return out


def _unflatten_dict_tree(flat):
    import torch

    by_name = {name: dtype for dtype, name in _torch_only_dtypes().items()}
    root = {}
    for path, arr in flat.items():
        if _DTYPE_TAG in path:
            path, name = path.rsplit(_DTYPE_TAG, 1)
            if name not in by_name:
                raise ValueError("bundle leaf {} has dtype {!r}, which the port cannot "
                                 "read".format(path, name))
            v = torch.from_numpy(arr.copy()).view(by_name[name])  # byte view → (..., 1)
            arr = v.reshape(v.shape[:-1])  # drop the trailing axis
        parts = path.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return root


def resolve_builder(spec):
    """``"module:attr"`` (or dotted ``module.attr``) → the builder callable;
    callables pass through."""
    if callable(spec):
        return spec
    mod, sep, attr = spec.partition(":")
    if not sep:
        mod, _, attr = spec.rpartition(".")
    if not mod or not attr:
        raise ValueError(
            "trusted_builder must be callable or 'module:attr', got {!r}".format(spec)
        )
    return getattr(importlib.import_module(mod), attr)


def _takes_device(builder):
    try:
        return "device" in inspect.signature(builder).parameters
    except (TypeError, ValueError):
        return False


def load_model(export_dir, trusted_builder=None, device=None):
    """Load a bundle: returns ``(predict_fn, params, model_state)``.

    ``device`` goes to a builder that takes a ``device`` argument (the
    port's builders build on the card when it is None, and raise without
    one); pass ``"cpu"`` to predict on the CPU. A builder without that
    argument with ``device`` given raises.

    ``trusted_builder`` (callable or ``"module:attr"``) supplies the
    predict-fn builder from the CALLER'S code instead of unpickling
    ``predict_builder.pkl`` — combined with the npz weights lane
    (``allow_pickle=False``) nothing from ``export_dir`` is ever unpickled,
    so a tampered bundle can corrupt predictions but cannot execute code.
    Without it, loading a bundle executes pickled code: treat the bundle as
    a trusted artifact (see module docstring).
    """
    import numpy as np

    export_dir = os.path.abspath(os.path.expanduser(export_dir))
    if trusted_builder is not None:
        predict_builder = resolve_builder(trusted_builder)
    else:
        with open(os.path.join(export_dir, _BUILDER_FILE), "rb") as f:
            predict_builder = cloudpickle.load(f)
    npz = os.path.join(export_dir, _WEIGHTS_NPZ)
    weights = os.path.join(export_dir, _WEIGHTS_FILE)
    if os.path.isfile(npz):
        with np.load(npz, allow_pickle=False) as z:
            state = _unflatten_dict_tree({k: z[k] for k in z.files})
    elif os.path.isfile(weights):
        if trusted_builder is not None:
            raise ValueError(
                "bundle {} has pickled weights ({}) — the trusted_builder "
                "safe-load lane requires npz weights (re-export with a "
                "dict-tree state)".format(export_dir, _WEIGHTS_FILE)
            )
        with open(weights, "rb") as f:
            state = cloudpickle.load(f)
    else:
        raise FileNotFoundError(
            "bundle {} has no {} or {} (a bundle of the JAX package's orbax era "
            "does not load in the port; re-export it)".format(export_dir, _WEIGHTS_NPZ, _WEIGHTS_FILE)
        )
    if device is not None:
        if not _takes_device(predict_builder):
            raise TypeError("the bundle's predict_builder takes no device argument; "
                            "load it with device=None")
        predict_fn = predict_builder(device=device)
    else:
        predict_fn = predict_builder()
    return predict_fn, state["params"], state.get("model_state") or {}


def is_model_bundle(path):
    return os.path.isfile(os.path.join(path, _BUILDER_FILE))
