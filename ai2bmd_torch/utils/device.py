"""Explicit device selection.

Replaces the ``on_tpu`` probes of ``ai2bmd_tpu/models/visnet.py:102-131`` and
``ai2bmd_tpu/frag/hydrogen.py:58-76``.  Nothing in the port probes for a
device on its own: a kernel wrapper looks at the tensors it is given (CPU:
plain PyTorch version, CUDA: the hand-written kernel), and a caller that
wants the card asks for it with ``require_cuda``, which raises when there is
none instead of falling back to the CPU.
"""

from __future__ import annotations

import torch


def set_fp32_precision() -> None:
    """Full float32 for every float32 product on the card.

    PyTorch's matmul default is already full float32, but cuDNN's is TF32;
    both are set here explicitly so that the plain versions the kernels are
    compared with keep about seven decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def require_cuda() -> torch.device:
    """The current CUDA device, with TF32 turned off; raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the kernel path needs an NVIDIA GPU "
            "(the plain PyTorch path runs on CPU tensors)"
        )
    set_fp32_precision()
    return torch.device("cuda", torch.cuda.current_device())
