"""Float32 against float64 of the JAX package's AMOEBA QM/MM step, on the CPU.

The reference's own precision spread for ``mm_backend="amoeba"``: the
synthetic solvated Chignolin box of ``tests/test_qmmm_amoeba.py`` (175
protein atoms and a lattice of AMOEBA waters, cutoff 6 A, K = 256), the QM
term at zero, one ``QMMMPotential`` evaluation in float32 and one under
``jax_enable_x64``.  Prints one JSON line: max|dF| on solvent and on protein
atoms (eV/A), |dE| (eV) and the carried dipoles' max|d mu| (e A).  The
port's card check (``chip_smoke.py`` phase 11(c)) takes its limits from
these figures.  Each evaluation compiles the whole step (minutes).

    JAX_PLATFORMS=cpu python tools/amoeba_f32_spread.py
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.join(os.path.dirname(HERE), "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_qmmm_amoeba import _synthetic_solvated  # noqa: E402


def evaluate(atoms, x64: bool):
    jax.config.update("jax_enable_x64", x64)
    from ai2bmd_tpu.physics.qmmm import QMMMPotential

    dt = jnp.float64 if x64 else jnp.float32
    pot = QMMMPotential.build(atoms, qm_energy_forces=lambda P: (jnp.zeros((), P.dtype),
                                                                 jnp.zeros_like(P)),
                              mm_backend="amoeba", cutoff=6.0, k_neighbors=256)
    P = jnp.asarray(atoms.positions, dt)
    aux = jax.tree.map(lambda a: a.astype(dt) if a.dtype == jnp.float32 else a,
                       pot.init_aux(P))
    e, f, aux = jax.jit(pot.__call__)(P, aux)
    md, _ = aux[2][0]
    return float(e), np.asarray(f, np.float64), np.asarray(md, np.float64)


def main():
    atoms, n_p, _ = _synthetic_solvated()
    e64, f64, m64 = evaluate(atoms, True)
    e32, f32, m32 = evaluate(atoms, False)
    df = np.abs(f32 - f64).max(axis=1)
    print(json.dumps({"atoms": int(len(f64)), "protein_atoms": int(n_p),
                      "max_df_solvent": float(df[n_p:].max()),
                      "max_df_protein": float(df[:n_p].max()), "de": abs(e32 - e64),
                      "e64": e64, "max_dmu_full": float(np.abs(m32 - m64).max()),
                      "max_abs_f64": float(np.abs(f64).max())}))


if __name__ == "__main__":
    main()
