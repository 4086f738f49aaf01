"""Float32 against float64 of the JAX package's pure-AMOEBA energy, on the CPU.

The reference's own precision spread for ``physics/amoeba_md.AmoebaMD``
(valence terms plus the nonbonded engine with the unrolled full-Ewald
induction, 12 PCG iterations): the box JAX's ``solvate`` builds around
``build_polyalanine(2)`` at a 4 A padding (251 atoms, ACE-ALA-ALA-NME and
73 waters, seed 0), cutoff 5 A with the other ``AmoebaMD.build`` defaults,
one ``energy`` and its gradient in float32 and one under
``jax_enable_x64`` (the tables float32 in both), at the box's positions
moved by N(0, 0.02 A) from seed 0: the builder's amides are exactly planar,
where JAX's out-of-plane bend (arcsin of sqrt(sin^2 chi) at 0) has a NaN
gradient.  Prints one JSON
line: max|dF| on solvent and on peptide atoms (eV/A), |dE| (eV), E and
max|F| in float64.  The port's card check (``chip_smoke.py`` phase 12(b))
takes its limits from these figures.  Each evaluation compiles the whole
energy (minutes).

    JAX_PLATFORMS=cpu python tools/amoeba_md_f32_spread.py
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE)]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def small_box():
    from ai2bmd_tpu.io.build import build_polyalanine
    from ai2bmd_tpu.preprocess import solvate

    box = solvate(build_polyalanine(2), padding=4.0, seed=0)
    box.positions = box.positions + np.random.default_rng(0).normal(0.0, 0.02,
                                                                    box.positions.shape)
    return box, 32


def evaluate(atoms, x64: bool):
    jax.config.update("jax_enable_x64", x64)
    from ai2bmd_tpu.physics.amoeba_md import AmoebaMD

    dt = jnp.float64 if x64 else jnp.float32
    md = AmoebaMD.build(atoms, cutoff=5.0)
    P = jnp.asarray(atoms.positions, dt)
    nl = md.init_aux(P)
    e, g = jax.jit(jax.value_and_grad(lambda p: md.energy(p, nl)))(P)
    return float(e), -np.asarray(g, np.float64)


def main():
    atoms, n_p = small_box()
    e64, f64 = evaluate(atoms, True)
    e32, f32 = evaluate(atoms, False)
    df = np.abs(f32 - f64).max(axis=1)
    print(json.dumps({"atoms": int(len(f64)), "peptide_atoms": n_p,
                      "max_df_solvent": float(df[n_p:].max()),
                      "max_df_peptide": float(df[:n_p].max()), "de": abs(e32 - e64),
                      "e64": e64, "max_abs_f64": float(np.abs(f64).max())}))


if __name__ == "__main__":
    main()
