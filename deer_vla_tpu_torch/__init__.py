"""PyTorch / CUDA port of deer_vla_tpu for NVIDIA Hopper.

The layout mirrors the JAX package (``core/``, ``ops/``, ``ops/kernels/``,
``models/``, ``data/``, ``eval/``, ``train/``, ``utils/``, ``cli/``).  This
package imports torch and numpy only, never JAX and never the JAX package.

Public API, the JAX package's names, each imported at first use (so
``import deer_vla_tpu_torch`` stays cheap):

  Configs    deer_vla_tpu_torch.DeerConfig / deer_3b / deer_9b / bc_llama /
             deer_tiny / MODEL_REGISTRY
  Model      deer_vla_tpu_torch.init_deer / forward_train /
             forward_fixed_exit / trainable_mask
  Engines    deer_vla_tpu_torch.ScanDeerPolicy (default) / DeerPolicy /
             FusedDeerPolicy (the equivalence oracle) / BatchedDeerPolicy
  Training   deer_vla_tpu_torch.Trainer / TrainConfig
  Eval       deer_vla_tpu_torch.calibrate / evaluate_policy /
             ExitController / solve_thresholds
"""

_LAZY = {
    "DeerConfig": "deer_vla_tpu_torch.core.config",
    "deer_3b": "deer_vla_tpu_torch.core.config",
    "deer_9b": "deer_vla_tpu_torch.core.config",
    "bc_llama": "deer_vla_tpu_torch.core.config",
    "deer_tiny": "deer_vla_tpu_torch.core.config",
    "MODEL_REGISTRY": "deer_vla_tpu_torch.core.config",
    "init_deer": "deer_vla_tpu_torch.models.flamingo",
    "forward_train": "deer_vla_tpu_torch.models.flamingo",
    "forward_fixed_exit": "deer_vla_tpu_torch.models.flamingo",
    "trainable_mask": "deer_vla_tpu_torch.models.flamingo",
    "ExitController": "deer_vla_tpu_torch.models.value_net",
    "solve_thresholds": "deer_vla_tpu_torch.models.value_net",
    "ScanDeerPolicy": "deer_vla_tpu_torch.eval.scan_policy",
    "DeerPolicy": "deer_vla_tpu_torch.eval.policy",
    "FusedDeerPolicy": "deer_vla_tpu_torch.eval.fused_policy",
    "BatchedDeerPolicy": "deer_vla_tpu_torch.eval.batched_policy",
    "calibrate": "deer_vla_tpu_torch.eval.calibrate",
    "evaluate_policy": "deer_vla_tpu_torch.eval.rollout",
    "Trainer": "deer_vla_tpu_torch.train.trainer",
    "TrainConfig": "deer_vla_tpu_torch.train.trainer",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'deer_vla_tpu_torch' has no attribute {name!r}")
