"""Trajectory conversion CLI (reference src/utils/traj2dcd.py equivalent).

A copy of ``ai2bmd_tpu/tools/traj2dcd.py`` on the port's
``io.trajectory``.  The engine already writes DCD natively; this tool
converts between the formats it emits (xyz <-> dcd) for post-processing
pipelines that expect one or the other.  Usage:

    python -m ai2bmd_torch.tools.traj2dcd input.xyz output.dcd
    python -m ai2bmd_torch.tools.traj2dcd input.dcd output.xyz --symbols "C H H O"
"""

from __future__ import annotations

import argparse

import numpy as np

from ai2bmd_torch.io.trajectory import DCDTrajectory, read_dcd


def read_xyz(path: str):
    frames, symbols = [], None
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        n = int(lines[i].strip())
        block = lines[i + 2:i + 2 + n]
        symbols = [l.split()[0] for l in block]
        frames.append([[float(x) for x in l.split()[1:4]] for l in block])
        i += 2 + n
    return np.asarray(frames), symbols


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="traj2dcd")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--symbols", default=None,
                    help="space-separated element symbols (dcd -> xyz)")
    ap.add_argument("--timestep-fs", type=float, default=1.0)
    args = ap.parse_args(argv)

    if args.input.endswith(".xyz") and args.output.endswith(".dcd"):
        frames, _ = read_xyz(args.input)
        out = DCDTrajectory(args.output, frames.shape[1], args.timestep_fs)
        for fr in frames:
            out.write(fr)
        out.close()
        print(f"wrote {len(frames)} frames to {args.output}")
    elif args.input.endswith(".dcd") and args.output.endswith(".xyz"):
        frames = read_dcd(args.input)
        symbols = (args.symbols or "X " * frames.shape[1]).split()
        with open(args.output, "w") as f:
            for k, fr in enumerate(frames):
                f.write(f"{frames.shape[1]}\nframe={k}\n")
                for s, p in zip(symbols, fr):
                    f.write(f"{s} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        print(f"wrote {len(frames)} frames to {args.output}")
    else:
        ap.error("supported conversions: .xyz->.dcd, .dcd->.xyz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
