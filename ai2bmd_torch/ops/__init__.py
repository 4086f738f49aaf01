"""Hand-written Hopper kernels and their plain PyTorch versions.

Every wrapper adds one to ``LAUNCHES[name]`` where it launches its CUDA
kernel, and nowhere else, so a run can show which kernels its main path
went through.  ``tf32x3_mm`` is a check of the edge kernels' shared
tensor-core product and is on no path of the model.
"""

LAUNCHES = {"edge_fwd": 0, "edge_bwd_msg": 0, "edge_bwd_upd": 0, "cap_grad": 0,
            "vislayer_fwd": 0, "vislayer_bwd": 0, "edge_bwd_msg_rc": 0, "edge_bwd_upd_rc": 0,
            "tf32x3_mm": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
