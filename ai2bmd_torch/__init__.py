"""PyTorch + CUDA port of ai2bmd_tpu for one NVIDIA H100.

Mirrors the subpackage layout of ``ai2bmd_tpu`` so that each port file maps
to one reference file.  Plain tensor code is PyTorch; every Pallas kernel on
the ported path is a hand-written CUDA kernel under ``ops/csrc/`` with a
plain PyTorch version beside it.  Nothing here imports JAX or
``ai2bmd_tpu``: the numpy host modules are copies of the JAX package's.
Nothing decides a device at import time: a kernel wrapper follows its
tensors' device, and the entry points that build state take the card unless
the caller passes ``device="cpu"``.
"""
