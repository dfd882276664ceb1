"""Reader for params-only ``.npz`` archives.

Counterpart of ``restore_bare_params`` in ``nerf_tpu/train/checkpoint.py``:
the archive is keyed by ``jax.tree_util.keystr`` paths such as
``['fine']['trunk'][4]['w']`` (``results/convergence/final_params.npz``).
The port rebuilds the nesting from the keys themselves (a regex over the
path), so it needs neither JAX nor a template. Trainer checkpoints
(``d:...//s:...`` keys with a ``__meta__`` header) wait for the training
slice.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np

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
    root: Dict[Any, Any] = {}
    for key, leaf in flat.items():
        parts = parse_keystr(key)
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return _lists(root)


def _lists(node):
    """Turn the int-keyed dicts left by ``setdefault`` into ordered lists."""
    if isinstance(node, dict):
        if node and all(isinstance(k, int) for k in node):
            if sorted(node) != list(range(len(node))):
                raise ValueError(f"sparse list indices {sorted(node)}")
            return [_lists(node[i]) for i in range(len(node))]
        return {k: _lists(v) for k, v in node.items()}
    return node


def has_checkpoint_meta(path: str) -> bool:
    with np.load(path) as data:
        return "__meta__" in data


def restore_bare_params(path: str) -> Dict[str, Any]:
    """Load a keystr ``.npz`` as nested dicts/lists of numpy arrays."""
    with np.load(path) as data:
        return unflatten_keystr({k: data[k] for k in data.files})
