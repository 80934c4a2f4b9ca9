"""The layer-indexed kernels (K2-K4) have no backward, and K1's backward
gives no bias gradient: they write their outputs through ``ctypes`` into
buffers autograd never sees, so an output would carry no ``grad_fn`` and
every gradient behind it would be silently zero.  Each wrapper therefore
refuses an input that requires grad while grad mode is on, where it has no
backward for that input (the layer-indexed operators register none).
Serving (``torch.inference_mode``), calibration and the frozen ViT of
training (``torch.no_grad``) never trip it; there is no quiet fallback to
the plain version.
"""

from __future__ import annotations

import torch

# where ROADMAP.md stands on the gradients the kernels do not give: K1's
# bias (q, k and v have K1's backward) and the layer-indexed matmuls K2-K4
# (serving only: training runs the unstacked decoder)
K1_BACKWARD = ("M11: K1's backward gives q, k and v their gradients, not "
               "the bias; no model trains an attention bias")
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
            f"backward for it (ROADMAP.md {item}); call it under "
            "torch.no_grad() "
            "or torch.inference_mode(), or keep its inputs frozen")


def check_device(kernel: str, t: torch.Tensor) -> None:
    """Raise ``ValueError`` for a tensor neither on the CPU (the plain
    version) nor on the card (the kernel): the operators' fake
    implementations would answer for it, and nothing may fall back."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {t.device}")
