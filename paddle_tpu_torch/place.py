"""Device resolution for the port: CUDA unless the caller asks for
another device, and never a silent fall back to the CPU."""

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``None`` means the current CUDA device, and raises when there is
    none; anything else is passed to ``torch.device``. A CUDA device
    runs float32 matmuls in full float32 (TF32 off), the precision the
    port is held to against the reference."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device %s requested but CUDA is not "
                               "available" % device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
