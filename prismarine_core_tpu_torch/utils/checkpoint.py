"""Checkpoint / resume.

The counterpart of ``prismarine_core_tpu.utils.checkpoint``, on ``.npz``
files: ``save_pytree`` / ``load_pytree`` round-trip a nested dict of
tensors (or numpy arrays and scalars), keyed by their ``/``-joined path;
``save_renderer`` / ``load_renderer`` persist a ProgressiveRenderer's
accumulator, weights, frame count and generator state, so a resumed
render continues with the same samples it would have drawn.
"""

from __future__ import annotations

import numpy as np
import torch

_SEP = "/"


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if _SEP in str(k):
                raise ValueError(f"checkpoint key {k!r} holds {_SEP!r}")
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
        return out
    return {prefix[:-len(_SEP)]: tree}


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_pytree(path: str, tree: dict) -> None:
    """Save a nested dict of tensors / arrays / scalars to ``path``
    (``.npz`` appended when missing)."""
    flat = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in _flatten(tree).items()}
    np.savez(_npz(path), **flat)


def load_pytree(path: str, like: dict) -> dict:
    """Load a checkpoint saved by ``save_pytree``.  ``like`` gives the
    structure: a tensor leaf comes back as a tensor of its dtype on its
    device, any other leaf as a numpy array.  Raises KeyError for a leaf
    missing from the file and ValueError for a shape that differs."""
    with np.load(_npz(path)) as data:
        def leaf(key, ref):
            arr = data[key]
            if np.shape(ref) != arr.shape:
                raise ValueError(f"checkpoint leaf {key!r} has shape "
                                 f"{arr.shape}, expected {np.shape(ref)}")
            if isinstance(ref, torch.Tensor):
                return torch.as_tensor(arr, dtype=ref.dtype,
                                       device=ref.device)
            return arr

        def build(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: build(v, f"{prefix}{k}{_SEP}")
                        for k, v in tree.items()}
            return leaf(prefix[:-len(_SEP)], tree)

        return build(like)


# -- progressive renderer state --------------------------------------------

def _renderer_state(renderer) -> dict:
    return {"accum": renderer._accum, "weight": renderer._weight,
            "n_frames": np.int64(renderer._n_frames),
            "generator": renderer._generator.get_state()}


def save_renderer(path: str, renderer) -> None:
    """Persist a ProgressiveRenderer's accumulation state and its
    generator's state."""
    save_pytree(path, _renderer_state(renderer))


def load_renderer(path: str, renderer) -> None:
    """Restore state saved by ``save_renderer`` into ``renderer``, in
    place, on the renderer's device."""
    state = load_pytree(path, _renderer_state(renderer))
    renderer._accum = state["accum"]
    renderer._weight = state["weight"]
    renderer._n_frames = int(state["n_frames"])
    renderer._generator.set_state(state["generator"])
