"""Flat .npz (de)serialization of ActorCritic params, and the mapping between
the flax param tree and the port's flat parameter vector.

`load_params_npz` and `save_params_npz` are copies of the JAX package's
numpy-only reader and writer (`acas2d_tpu/utils/params_io.py`): keys are the
flax tree paths joined by "//" (`params//pi_tower//dense_0//kernel`, ...),
so the committed `artifacts/*.npz` policies load unchanged, and what the
port writes loads unchanged in the JAX `eval.py` and
`scripts/best_selection.py`.

`from_jax_params` / `to_jax_params` map a flax tree to the port's
`state_dict` and back; `tree_to_flat` / `flat_to_tree` map it to the flat
(..., N_PARAMS) vector in kernel order (`models/actor_critic.py`), with any
leading axes (a population's members, a tracker's snapshots).
`load_flat_params` reads an npz into flat vectors, stacked artifacts
(`top_snapshots.npz`, marked by `__stack_n__`) into (n, N_PARAMS).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from acas2d_tpu_torch.models.actor_critic import HIDDEN, N_PARAMS, OBS_DIM

_SEP = "//"
STACK_KEY = "__stack_n__"

# torch module prefix -> flax tree path
_LAYERS = {
    "pi_tower.dense_0": ("pi_tower", "dense_0"),
    "pi_tower.dense_1": ("pi_tower", "dense_1"),
    "action_head": ("action_head",),
    "vf_tower.dense_0": ("vf_tower", "dense_0"),
    "vf_tower.dense_1": ("vf_tower", "dense_1"),
    "value_head": ("value_head",),
}
# the flat vector's blocks in kernel order: (torch module prefix, (out, in))
_FLAT_LAYOUT = (("pi_tower.dense_0", (HIDDEN, OBS_DIM)),
                ("pi_tower.dense_1", (HIDDEN, HIDDEN)),
                ("action_head", (1, HIDDEN)),
                ("vf_tower.dense_0", (HIDDEN, OBS_DIM)),
                ("vf_tower.dense_1", (HIDDEN, HIDDEN)),
                ("value_head", (1, HIDDEN)))


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else k))
    else:
        out[prefix] = np.asarray(tree)
    return out


def save_params_npz(path: str, params: Any) -> None:
    np.savez(path, **_flatten(params))


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


def _node(tree: Dict[str, Any], path) -> Dict[str, Any]:
    node = tree["params"]
    for k in path:
        node = node[k]
    return node


def from_jax_params(tree: Dict[str, Any],
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Flax ActorCritic param tree (numpy leaves) -> ActorCritic state_dict.
    A flax `Dense.kernel` is (in, out) and `nn.Linear.weight` is (out, in),
    so kernels are transposed."""
    sd = {}
    for prefix, path in _LAYERS.items():
        node = _node(tree, path)
        sd[f"{prefix}.weight"] = torch.tensor(np.asarray(node["kernel"]).T,
                                              dtype=dtype)
        sd[f"{prefix}.bias"] = torch.tensor(np.asarray(node["bias"]),
                                            dtype=dtype)
    sd["log_std"] = torch.tensor(np.asarray(tree["params"]["log_std"]),
                                 dtype=dtype)
    return sd


def to_jax_params(sd: Dict[str, torch.Tensor],
                  dtype=np.float32) -> Dict[str, Any]:
    """ActorCritic state_dict -> flax param tree with numpy leaves of
    `dtype` (the inverse of `from_jax_params`)."""
    def leaf(t):
        return t.detach().cpu().numpy().astype(dtype)

    pr: Dict[str, Any] = {}
    for prefix, path in _LAYERS.items():
        node = pr
        for k in path:
            node = node.setdefault(k, {})
        node["kernel"] = np.ascontiguousarray(leaf(sd[f"{prefix}.weight"]).T)
        node["bias"] = leaf(sd[f"{prefix}.bias"])
    pr["log_std"] = leaf(sd["log_std"])
    return {"params": pr}


def flat_to_tree(flat) -> Dict[str, Any]:
    """Flat (..., N_PARAMS) vectors -> flax tree whose leaves carry the same
    leading axes (kernels (..., in, out), biases (..., out), log_std
    (..., 1)), float32 numpy."""
    x = np.asarray(flat.detach().cpu() if torch.is_tensor(flat) else flat,
                   dtype=np.float32)
    if x.shape[-1] != N_PARAMS:
        raise ValueError(f"expected (..., {N_PARAMS}) flat params, got "
                         f"{x.shape}")
    lead = x.shape[:-1]
    pr: Dict[str, Any] = {}
    i = 0
    for prefix, (n_out, n_in) in _FLAT_LAYOUT:
        w = x[..., i:i + n_out * n_in].reshape(lead + (n_out, n_in))
        i += n_out * n_in
        b = x[..., i:i + n_out]
        i += n_out
        node = pr
        for k in _LAYERS[prefix]:
            node = node.setdefault(k, {})
        node["kernel"] = np.ascontiguousarray(np.swapaxes(w, -1, -2))
        node["bias"] = np.ascontiguousarray(b)
    pr["log_std"] = np.ascontiguousarray(x[..., i:i + 1])
    return {"params": pr}


def tree_to_flat(tree: Dict[str, Any], n_lead: int = 0) -> torch.Tensor:
    """Flax tree (numpy leaves with `n_lead` leading axes) -> flat
    (*lead, N_PARAMS) float32 tensor in kernel order."""
    parts = []
    lead = None
    for prefix, (n_out, n_in) in _FLAT_LAYOUT:
        node = _node(tree, _LAYERS[prefix])
        k = np.asarray(node["kernel"], np.float32)
        lead = k.shape[:n_lead]
        parts += [np.swapaxes(k, -1, -2).reshape(lead + (-1,)),
                  np.asarray(node["bias"], np.float32).reshape(lead + (-1,))]
    parts.append(np.asarray(tree["params"]["log_std"],
                            np.float32).reshape(lead + (1,)))
    return torch.from_numpy(np.concatenate(parts, axis=-1))


def load_flat_params(path: str) -> Tuple[torch.Tensor, Optional[int]]:
    """A params npz as flat float32 vectors: ((N_PARAMS,), None) for a
    single policy, ((n, N_PARAMS), n) for a stacked artifact."""
    tree = load_params_npz(path)
    stack_n = tree.pop(STACK_KEY, None)
    if stack_n is None:
        return tree_to_flat(tree), None
    return tree_to_flat(tree, n_lead=1), int(np.asarray(stack_n))


# ------------------------------------ the JAX packed-update parameter tree

def packed_to_flat(packed: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX packed-update 7-leaf tree (`pallas_update.pack_params_tree`:
    w1c (128, 8), b1c (128, 1), w2c (128, 128) block-diagonal, b2c, w3c
    (8, 128) heads in rows 0/1, b3c (8, 1), log_std), with any leading
    axes -> (flat (..., N_PARAMS) in kernel order, the off-diagonal packing
    entries (..., n) that the flat layout has no place for)."""
    g = {k: np.asarray(v, np.float32) for k, v in packed.items()}
    lead = g["w1c"].shape[:-2]
    H = HIDDEN

    def rows(x):
        return x.reshape(lead + (-1,))

    towers = []
    for t in range(2):
        s = slice(t * H, (t + 1) * H)
        towers += [rows(g["w1c"][..., s, :]), rows(g["b1c"][..., s, 0]),
                   rows(g["w2c"][..., s, s]), rows(g["b2c"][..., s, 0]),
                   rows(g["w3c"][..., t, s]), rows(g["b3c"][..., t, 0])]
    flat = np.concatenate(towers + [rows(g["log_std"])], axis=-1)
    off = np.concatenate([rows(g["w2c"][..., :H, H:]),
                          rows(g["w2c"][..., H:, :H]),
                          rows(g["w3c"][..., 0, H:]),
                          rows(g["w3c"][..., 1, :H]),
                          rows(g["w3c"][..., 2:, :]),
                          rows(g["b3c"][..., 2:, :])], axis=-1)
    return flat, off
