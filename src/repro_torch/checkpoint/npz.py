"""Flat-tree .npz checkpoints, the port of ``repro.checkpoint.npz``.

Leaves are addressed by their tree path string ("layers/0/mixer/wq"),
with the reference's keys (``params/...``, ``opt/mu/...``, ``opt/step``,
``meta/step``, ``extra/...``) and its dict-key order, so a checkpoint
written by either package loads into the other.  A bf16 leaf is stored as
the reference's numpy writes its ``ml_dtypes.bfloat16`` arrays, raw
2-byte voids, and restored bit for bit into a bf16 template.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix=()):
    """(path, leaf) pairs in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(arr: np.ndarray, like: torch.Tensor, key: str) -> torch.Tensor:
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint {key} has shape {arr.shape}, expected "
                         f"{tuple(like.shape)}")
    if like.dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2 or arr.dtype.kind != "V":
            raise TypeError(f"checkpoint {key} has dtype {arr.dtype}, expected bfloat16")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
        if t.dtype != like.dtype:
            raise TypeError(f"checkpoint {key} has dtype {t.dtype}, expected {like.dtype}")
    return t.to(like.device)


def tree_to_flat_dict(tree) -> Dict[str, np.ndarray]:
    return {path: _to_numpy(leaf) for path, leaf in _flatten(tree)}


def save_checkpoint(path: str, params, opt_state: Optional[dict] = None,
                    step: int = 0, extra: Optional[dict] = None) -> None:
    flat = {f"params/{k}": v for k, v in tree_to_flat_dict(params).items()}
    if opt_state is not None:
        flat.update({f"opt/{k}": v for k, v in tree_to_flat_dict(opt_state).items()})
    flat["meta/step"] = np.asarray(step)
    for k, v in (extra or {}).items():
        flat[f"extra/{k}"] = np.asarray(v)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(tmp, **flat)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_checkpoint(path: str, params_template,
                    opt_template: Optional[dict] = None) -> Tuple[Any, Optional[dict], int]:
    """Restore into the SAME structure as the given templates, each leaf
    on its template leaf's device with its dtype and shape (a mismatch
    raises)."""
    with np.load(path) as z:
        def restore(template, prefix):
            vals = {}
            for k, like in _flatten(template):
                key = f"{prefix}/{k}"
                if key not in z:
                    raise KeyError(f"checkpoint missing {key}")
                vals[k] = _to_tensor(z[key], torch.as_tensor(like), key)
            return _rebuild(template, vals, ())

        params = restore(params_template, "params")
        opt = restore(opt_template, "opt") if opt_template is not None else None
        step = int(z["meta/step"])
    return params, opt, step


def _rebuild(tree, vals: dict, prefix):
    if isinstance(tree, dict):
        return {k: _rebuild(v, vals, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, vals, prefix + (str(i),)) for i, v in enumerate(tree))
    return vals["/".join(prefix)]
