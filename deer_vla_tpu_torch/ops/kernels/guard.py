"""The hand-written kernels have no backward: they write their outputs
through ``ctypes`` into buffers autograd never sees, so an output would
carry no ``grad_fn`` and every gradient behind it would be silently zero.
Each wrapper therefore refuses a CUDA input that requires grad while grad
mode is on.  Serving (``torch.inference_mode``), calibration and the frozen
ViT of training (``torch.no_grad``) never trip it; there is no quiet
fallback to the plain version.
"""

from __future__ import annotations

import torch

# where ROADMAP.md stands on a backward for K1 and for the layer-indexed
# matmuls K2-K4 (serving only: training runs the unstacked decoder)
K1_BACKWARD = ("M11: a K1 backward, needed only to train the ViT "
               "(--unfreeze_vit) on the card")
INDEXED_BACKWARD = ("none planned: training runs the unstacked decoder "
                    "through ops.layers.linear")


def check_no_grad(kernel: str, *tensors) -> None:
    """Raise ``RuntimeError`` if grad mode is on and any of ``tensors``
    (``None`` entries skipped) requires grad."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors):
        item = K1_BACKWARD if kernel == "flash_attention" else \
            INDEXED_BACKWARD
        raise RuntimeError(
            f"{kernel}: an input requires grad, but the kernel has no "
            f"backward (ROADMAP.md {item}); call it under torch.no_grad() "
            "or torch.inference_mode(), or keep its inputs frozen")
