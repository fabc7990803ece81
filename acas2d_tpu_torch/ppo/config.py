"""PPO hyperparameters (a copy of `acas2d_tpu/ppo/config.py`).

Defaults replicate the reference's recorded configuration (SB3 defaults +
seed, training_main.py:44-52): n_steps 2048, batch 64, 10 epochs, gamma 0.99,
GAE lambda 0.95, clip 0.2, ent_coef 0, vf_coef 0.5, max_grad_norm 0.5,
Adam(3e-4, eps=1e-5).  `tpu_default` is the scaled configuration of the
flagship policy: the same optimisation semantics, 2048 envs x 128 steps per
iteration.

Every field of the JAX package's `PPOConfig` is kept, with the same default,
so that one configuration means the same run in both packages.  The port's
trainer implements the subset that its first slice needs and rejects the
rest (`acas2d_tpu_torch/train.py`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    # Rollout sizing
    n_envs: int = 1
    n_steps: int = 2048              # settings.py:10 N_STEPS
    total_timesteps: int = 2048 * 512  # settings.py:11 TOTAL_STEPS

    # Optimization (training_main.py:44-48 + SB3 defaults)
    minibatch_size: int = 64
    n_epochs: int = 10
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_range: float = 0.2
    ent_coef: float = 0.0
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    learning_rate: float = 3e-4
    adam_eps: float = 1e-5
    normalize_advantage: bool = True
    # Epoch-shuffle granularity: rows are shuffled in contiguous blocks of
    # this many samples.  1 = exact SB3 row-level shuffle.  0 = auto: 512
    # for minibatches of at least 2^15 rows, else 1.
    shuffle_block_size: int = 0
    # Linear LR decay to 0 over the run.
    anneal_lr: bool = False
    # Collect the rollout with the fused policy-in-kernel rollout
    # (ops/policy_rollout.py), fused_chunk steps per launch.
    fused_rollout: bool = False
    fused_chunk: int = 16
    # Compute each minibatch's PPO-loss gradient with the fused
    # forward+backward kernel (ops/ppo_grads.py).
    fused_update: bool = False
    # bf16 operands in the gradient kernel's products, float32 sums.
    fused_update_bf16: bool = False
    # The JAX package's packed-parameter loop (the fused update itself in
    # the port) and the chunk width of the TPU grid.  Kept so the two
    # configurations compare field by field.
    fused_update_packed: bool = False
    fused_update_chunk: int = 4096
    update_remat: bool = False

    seed: int = 13                   # settings.py:28

    # Evaluation cadence (training_main.py:31-35; settings.py:12)
    eval_every_steps: int = 2048 * 512 // 32   # EVAL_STEPS = 32768
    eval_episodes: int = 10                     # EVAL_EPISODES

    @property
    def batch_size(self) -> int:
        return self.n_envs * self.n_steps

    @property
    def shuffle_block(self) -> int:
        """Resolved shuffle block size (see shuffle_block_size)."""
        b = self.shuffle_block_size
        if b == 0:
            b = 512 if (self.minibatch_size >= 1 << 15
                        and self.minibatch_size % 512 == 0) else 1
        if self.minibatch_size % b or self.batch_size % b:
            raise ValueError(
                f"shuffle block {b} must divide minibatch "
                f"{self.minibatch_size} and buffer {self.batch_size}")
        return b

    @property
    def n_minibatches(self) -> int:
        if self.batch_size % self.minibatch_size:
            raise ValueError(
                f"buffer {self.batch_size} not divisible by minibatch "
                f"{self.minibatch_size}")
        return self.batch_size // self.minibatch_size

    @property
    def n_iterations(self) -> int:
        return self.total_timesteps // self.batch_size


def reference_config() -> PPOConfig:
    """The exact single-env configuration of record."""
    return PPOConfig()


def tpu_default(n_envs: int = 2048, n_steps: int = 128,
                total_timesteps: int = 2048 * 512 * 8,
                minibatch_size: int = 65536) -> PPOConfig:
    """The scaled configuration of the flagship policy: 2048 envs x 128
    steps (a 262,144-sample buffer), minibatch 65,536, 10 epochs.  The name
    is the JAX package's preset name and is kept so that `--preset tpu`
    means the same run in both packages."""
    return PPOConfig(n_envs=n_envs, n_steps=n_steps,
                     total_timesteps=total_timesteps,
                     minibatch_size=minibatch_size,
                     eval_every_steps=max(n_envs * n_steps * 4, 2048 * 512 // 32))
