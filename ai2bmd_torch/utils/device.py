"""Explicit device selection.

Replaces the ``on_tpu`` probes of ``ai2bmd_tpu/models/visnet.py:102-131`` and
``ai2bmd_tpu/frag/hydrogen.py:58-76``.  A kernel wrapper looks at the tensors
it is given (CPU: plain PyTorch version, CUDA: the hand-written kernel).  The
entry points that build state (``FragmentPotential.build``,
``ViSNetPotential.build``, ``FragmentRuntime.build``, ``NonbondedParams.build``, ``LangevinCoeffs.build``,
``ReplicaEnsemble.build``, ``ShardedPotential.build``, ``EnsembleSimulation.build``,
``BondRestraint.find_hydrogen_bonds``,
``Simulator``, ``ProteinSimulation.from_pdb``, and ``cli.main`` by its
``--device``) take the card unless the caller passes ``device="cpu"``, through ``resolve_device``, which raises when
there is no card instead of falling back to the CPU.
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


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card for None (raising without
    one, through ``require_cuda``), else the device asked for."""
    if device is None:
        return require_cuda()
    device = torch.device(device)
    if device.type == "cuda":
        require_cuda()
    return device
