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


# --matmul-precision -> torch.set_float32_matmul_precision: the JAX CLI's
# values (ai2bmd_tpu/cli.py:96-98, 123), which set jax_default_matmul_precision
MATMUL_PRECISIONS = {"float32": "highest", "tensorfloat32": "high", "bfloat16": "medium"}
_chosen: str | None = None


def set_matmul_precision(name: str) -> str:
    """``--matmul-precision``: the precision of the eager float32 products
    outside the kernels (cuBLAS on the card; on the CPU, torch's own matmul,
    which takes ``medium`` as bfloat16 where the CPU has bfloat16
    instructions); cuDNN takes TF32 unless the name is ``float32``.  The
    kernels keep their own mode (``ops._build.MM_MODE``, from
    ``ops.vismp``), as the JAX
    package's Pallas kernels pass explicit precisions.  Once chosen, it
    stays: ``set_fp32_precision`` no longer resets it, and ranks that
    ``parallel.launch`` spawns take it too.  Returns torch's name for it."""
    global _chosen
    if name not in MATMUL_PRECISIONS:
        raise ValueError(f"--matmul-precision {name!r}: one of {sorted(MATMUL_PRECISIONS)}")
    torch.set_float32_matmul_precision(MATMUL_PRECISIONS[name])
    torch.backends.cudnn.allow_tf32 = name != "float32"
    _chosen = name
    return torch.get_float32_matmul_precision()


def chosen_matmul_precision() -> str | None:
    """The ``--matmul-precision`` value ``set_matmul_precision`` set, or None."""
    return _chosen


def set_fp32_precision() -> None:
    """Full float32 for every float32 product on the card, unless a
    precision was chosen (``set_matmul_precision``), which it leaves as it is.

    PyTorch's matmul default is already full float32, but cuDNN's is TF32;
    both are set here explicitly so that the plain versions the kernels are
    compared with keep about seven decimal digits.  The matmul precision is
    set for every backend at once: torch 2.13 refuses to report it once the
    CUDA flag alone (``allow_tf32``) has moved it away from the CPU's."""
    if _chosen is not None:
        return
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False


def require_cuda() -> torch.device:
    """The current CUDA device, with TF32 turned off unless a precision was
    chosen (``set_fp32_precision``); raises without a card."""
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
