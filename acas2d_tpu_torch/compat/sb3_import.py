"""Import stable-baselines3 PPO policies into the port's ActorCritic.

Counterpart of `acas2d_tpu/compat/sb3_import.py:25-70`.  An SB3 `MlpPolicy`
zip holds `policy.pth`, a state dict of tensors: the `mlp_extractor`'s
policy and value towers, the action and value heads and `log_std`.  SB3's
layers are `nn.Linear` as the port's are, weights (out, in), so the import
renames them (and casts to the dtype asked for) and transposes nothing:

    mlp_extractor.policy_net.0 -> pi_tower.dense_0
    mlp_extractor.policy_net.2 -> pi_tower.dense_1
    mlp_extractor.value_net.0  -> vf_tower.dense_0
    mlp_extractor.value_net.2  -> vf_tower.dense_1
    action_net                 -> action_head
    value_net                  -> value_head
    log_std                    -> log_std

`load_sb3_policy` also gives the flax-shaped tree (`utils/params_io.
to_jax_params`), which `save_params_npz` writes as the `.npz` that `python
-m acas2d_tpu_torch.eval --params-npz` and the JAX package read:

    sd, tree = load_sb3_policy("best_model.zip")
    save_params_npz("best_model.npz", tree)

The zip is read with `torch.load(weights_only=True)`, where the JAX
package passes `weights_only=False`: a state dict of tensors loses
nothing, and a zip cannot run code on load.  No SB3 dependency.
"""

from __future__ import annotations

import io
import zipfile
from typing import Any, Dict, Tuple

import torch

from acas2d_tpu_torch.utils.params_io import to_jax_params

# SB3 MlpPolicy layer -> the port's ActorCritic module
SB3_LAYERS = {
    "mlp_extractor.policy_net.0": "pi_tower.dense_0",
    "mlp_extractor.policy_net.2": "pi_tower.dense_1",
    "mlp_extractor.value_net.0": "vf_tower.dense_0",
    "mlp_extractor.value_net.2": "vf_tower.dense_1",
    "action_net": "action_head",
    "value_net": "value_head",
}


def load_sb3_state_dict(zip_path: str) -> Dict[str, torch.Tensor]:
    """Read `policy.pth` out of an SB3 model zip: its tensors, on the
    CPU."""
    with zipfile.ZipFile(zip_path) as z:
        return dict(torch.load(io.BytesIO(z.read("policy.pth")),
                               map_location="cpu", weights_only=True))


def sb3_to_state_dict(sd: Dict[str, torch.Tensor],
                      dtype: torch.dtype = torch.float32
                      ) -> Dict[str, torch.Tensor]:
    """The SB3 MlpPolicy state dict as the port's ActorCritic state dict,
    in `dtype`.  A missing SB3 key raises KeyError."""
    out = {}
    for sb3, port in SB3_LAYERS.items():
        for leaf in ("weight", "bias"):
            out[f"{port}.{leaf}"] = sd[f"{sb3}.{leaf}"].to(dtype)
    out["log_std"] = sd["log_std"].to(dtype)
    return out


def load_sb3_policy(zip_path: str, dtype: torch.dtype = torch.float32
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """One-call import: an SB3 zip -> (the port's ActorCritic state dict,
    the flax-shaped param tree with numpy leaves), both in `dtype`."""
    sd = sb3_to_state_dict(load_sb3_state_dict(zip_path), dtype)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    return sd, to_jax_params(sd, np_dtype)
