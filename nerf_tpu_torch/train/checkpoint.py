"""Checkpoint save / restore / auto-resume, in the JAX package's file format.

Counterpart of ``nerf_tpu/train/checkpoint.py``. Two kinds of ``.npz``:

- params-only archives keyed by ``jax.tree_util.keystr`` paths such as
  ``['fine']['trunk'][4]['w']`` (``results/convergence/final_params.npz``),
  read by ``restore_bare_params`` and written by ``save_bare_params``;
- trainer checkpoints: one self-contained file holding both networks'
  params, the optimizer state, and a JSON header (config, loss history,
  step) under ``__meta__``, named ``checkpoint_epoch_{N}.npz``; resume picks
  the highest epoch. The keys are the JAX trainer's own, the flattened path
  of its ``TrainState(params, opt_state, step)`` with optax's chain state:
  ``a:params//d:coarse//d:trunk//s:0//d:w``,
  ``a:opt_state//s:2//a:mu//...`` and ``...//a:nu//...`` (Adam's first and
  second moments), ``a:opt_state//s:2//a:count`` and
  ``a:opt_state//s:3//a:count`` (Adam's and the schedule's step counts),
  ``a:step``. So either package reads the other's file.

The port rebuilds the nesting from the keys themselves, so it needs neither
JAX nor a template. Here a trainer state is a plain nested dict of numpy
arrays: ``{"params": ..., "mu": ..., "nu": ..., "count": int, "step": int}``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from nerf_tpu_torch.utils.tree import tree_from_leaves, tree_leaves

SEP = "//"  # path separator inside a trainer checkpoint's keys
_ADAM = f"a:opt_state{SEP}s:2{SEP}"       # optax chain: clip, decay, adam, schedule
_SCHEDULE_COUNT = f"a:opt_state{SEP}s:3{SEP}a:count"

_KEY_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def parse_keystr(key: str) -> list:
    """``"['fine']['trunk'][4]['w']"`` -> ``['fine', 'trunk', 4, 'w']``."""
    parts, pos = [], 0
    for m in _KEY_PART.finditer(key):
        if m.start() != pos:
            raise ValueError(f"not a keystr path: {key!r}")
        parts.append(m.group(1) if m.group(2) is None else int(m.group(2)))
        pos = m.end()
    if pos != len(key) or not parts:
        raise ValueError(f"not a keystr path: {key!r}")
    return parts


def unflatten_keystr(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Nest a flat ``{keystr: leaf}`` mapping. Integer path parts become
    list positions, so ``['trunk'][0]`` .. ``['trunk'][7]`` is a list."""
    return tree_from_leaves([parse_keystr(key) for key in flat], list(flat.values()))


def has_checkpoint_meta(path: str) -> bool:
    with np.load(path) as data:
        return "__meta__" in data


def restore_bare_params(path: str) -> Dict[str, Any]:
    """Load a keystr ``.npz`` as nested dicts/lists of numpy arrays."""
    with np.load(path) as data:
        return unflatten_keystr({k: data[k] for k in data.files})


def keystr(path: tuple) -> str:
    """``('fine', 'trunk', 4, 'w')`` -> ``"['fine']['trunk'][4]['w']"``, as
    ``jax.tree_util.keystr`` writes a path of dict keys and list indices."""
    return "".join(f"[{p!r}]" if isinstance(p, str) else f"[{p}]" for p in path)


def save_bare_params(path: str, params) -> None:
    """A params tree (leaves array-like on the host) as a compressed keystr
    ``.npz``, the format of ``results/convergence/final_params.npz``."""
    np.savez_compressed(path, **{keystr(tpath): np.asarray(leaf)
                                 for tpath, leaf in tree_leaves(params)})


def _path_key(path: tuple) -> str:
    return SEP.join(f"d:{p}" if isinstance(p, str) else f"s:{p}" for p in path)


def _key_path(key: str) -> tuple:
    parts = []
    for part in key.split(SEP):
        kind, _, name = part.partition(":")
        if kind not in ("d", "s"):
            raise ValueError(f"unexpected path element {part!r} in checkpoint key")
        parts.append(name if kind == "d" else int(name))
    return tuple(parts)


def save_checkpoint(path: str, state: Mapping[str, Any],
                    meta: Optional[Dict[str, Any]] = None) -> None:
    """Save a trainer state (``{"params", "mu", "nu", "count", "step"}``,
    leaves array-like on the host) and JSON-serializable metadata to
    ``path``: written to a temporary file and moved into place, so a run cut
    mid-write leaves no torn checkpoint."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = {}
    for prefix, name in (("a:params", "params"), (_ADAM + "a:mu", "mu"), (_ADAM + "a:nu", "nu")):
        for tpath, leaf in tree_leaves(state[name]):
            flat[prefix + SEP + _path_key(tpath)] = np.asarray(leaf)
    flat[_ADAM + "a:count"] = np.asarray(state["count"], np.int32)
    flat[_SCHEDULE_COUNT] = np.asarray(state["count"], np.int32)
    flat["a:step"] = np.asarray(state["step"], np.int32)
    flat["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode("utf-8"), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def restore_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(state, meta)`` of a trainer checkpoint written by either package:
    the state as ``save_checkpoint`` takes it, with numpy leaves."""
    with np.load(path) as data:
        if "__meta__" not in data:
            raise KeyError(f"{path} has no __meta__ header: not a trainer checkpoint")
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode("utf-8"))
        state: Dict[str, Any] = {}
        for prefix, name in (("a:params", "params"), (_ADAM + "a:mu", "mu"),
                             (_ADAM + "a:nu", "nu")):
            keys = [k for k in data.files if k.startswith(prefix + SEP)]
            if not keys:
                raise KeyError(f"checkpoint {path} has no {prefix} leaves")
            state[name] = tree_from_leaves([_key_path(k[len(prefix) + len(SEP):]) for k in keys],
                                           [data[k] for k in keys])
        for key, name in ((_ADAM + "a:count", "count"), ("a:step", "step")):
            if key not in data:
                raise KeyError(f"checkpoint {path} missing leaf {key}")
            state[name] = int(data[key])
    return state, meta


_CKPT_RE = re.compile(r"checkpoint_epoch_(\d+)\.npz$")


def checkpoint_path(checkpoint_dir: str, epoch: int) -> str:
    return os.path.join(checkpoint_dir, f"checkpoint_epoch_{epoch}.npz")


def find_latest_checkpoint(checkpoint_dir: str, exclude=()) -> Optional[str]:
    """The ``checkpoint_epoch_*.npz`` of the highest epoch in the directory.
    ``exclude`` paths are skipped (resume uses it to step past unreadable
    files)."""
    if not os.path.isdir(checkpoint_dir):
        return None
    best: Tuple[int, Optional[str]] = (-1, None)
    for name in os.listdir(checkpoint_dir):
        m = _CKPT_RE.match(name)
        path = os.path.join(checkpoint_dir, name)
        if m and path not in exclude and int(m.group(1)) > best[0]:
            best = (int(m.group(1)), path)
    return best[1]
