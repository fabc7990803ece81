"""Flat .npz loading of ActorCritic params, and the flax -> torch weight
mapping.

`load_params_npz` is a copy of the JAX package's numpy-only loader
(`acas2d_tpu/utils/params_io.py`): keys are the flax tree paths joined by
"//" (`params//pi_tower//dense_0//kernel`, ...), so the committed
`artifacts/*.npz` policies load unchanged.  `from_jax_params` turns such a
tree into the port's `state_dict`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_SEP = "//"

# torch module prefix -> flax tree path
_LAYERS = {
    "pi_tower.dense_0": ("pi_tower", "dense_0"),
    "pi_tower.dense_1": ("pi_tower", "dense_1"),
    "action_head": ("action_head",),
    "vf_tower.dense_0": ("vf_tower", "dense_0"),
    "vf_tower.dense_1": ("vf_tower", "dense_1"),
    "value_head": ("value_head",),
}


def load_params_npz(path: str) -> Dict[str, Any]:
    flat = np.load(path)
    tree: Dict[str, Any] = {}
    for key in flat.files:
        node = tree
        parts = key.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return tree


def from_jax_params(tree: Dict[str, Any],
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Flax ActorCritic param tree (numpy leaves) -> ActorCritic state_dict.
    A flax `Dense.kernel` is (in, out) and `nn.Linear.weight` is (out, in),
    so kernels are transposed."""
    pr = tree["params"]
    sd = {}
    for prefix, path in _LAYERS.items():
        node = pr
        for k in path:
            node = node[k]
        sd[f"{prefix}.weight"] = torch.tensor(np.asarray(node["kernel"]).T,
                                              dtype=dtype)
        sd[f"{prefix}.bias"] = torch.tensor(np.asarray(node["bias"]),
                                            dtype=dtype)
    sd["log_std"] = torch.tensor(np.asarray(pr["log_std"]), dtype=dtype)
    return sd
