"""Hand-written Hopper kernels and their plain PyTorch versions.

Every wrapper adds one to ``LAUNCHES[name]`` where it launches its CUDA
kernel, and nowhere else, so a run can show which kernels its main path
went through; ``_build.LIBRARY_LAUNCHES`` shows from which product mode's
library they came.  The bfloat16 instantiations of the edge kernels count
under names of their own (``edge_fwd_bf16``, ...).  ``tf32x3_mm`` is a
check of the edge kernels' shared tensor-core product and is on no path of
the model.  ``plain_edge_core``
counts no kernel: it counts the edge-core calls on CUDA tensors of a model
with other activations than silu, which take the plain version
(``ops.vismp.edge_core(plain=True)``), so that a run shows whether any
layer left the kernels.  ``reset_launches`` leaves it alone, so it counts
across every reset a run makes (``reset_plain_edge_core`` sets it to 0).
"""

LAUNCHES = {"edge_fwd": 0, "edge_bwd_msg": 0, "edge_bwd_upd": 0, "cap_grad": 0,
            "vislayer_fwd": 0, "vislayer_bwd": 0, "edge_bwd_msg_rc": 0, "edge_bwd_upd_rc": 0,
            "tf32x3_mm": 0, "plain_edge_core": 0,
            "edge_fwd_bf16": 0, "edge_bwd_msg_bf16": 0, "edge_bwd_upd_bf16": 0,
            "edge_bwd_msg_rc_bf16": 0, "edge_bwd_upd_rc_bf16": 0}


def reset_launches() -> None:
    from ai2bmd_torch.ops._build import LIBRARY_LAUNCHES

    for name in LAUNCHES:
        if name != "plain_edge_core":
            LAUNCHES[name] = 0
    LIBRARY_LAUNCHES.clear()


def reset_plain_edge_core() -> None:
    LAUNCHES["plain_edge_core"] = 0
