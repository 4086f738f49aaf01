"""Unit system of ai2bmd_torch (a copy of ai2bmd_tpu/units.py).

ASE-compatible internal units so that trajectories/energies are directly
comparable with the reference stack (which runs on top of ASE):

    length  -> Angstrom (A)
    energy  -> electron-volt (eV)
    mass    -> atomic mass unit (amu / Dalton)
    charge  -> elementary charge (e)
    time    -> A * sqrt(amu / eV)   (~= 10.1805 fs)

Derived constants follow CODATA 2014 (the default of the ASE version used by
the reference; see the reference's use of ``ase.units`` in
src/Calculators/nonbonded.py:17 and src/AIMD/simulator.py:110-116).
"""

import math

# --- CODATA 2014 base constants (SI) ---
_c = 299792458.0             # speed of light, m/s
_e = 1.6021766208e-19        # elementary charge, C
_me = 9.10938356e-31         # electron mass, kg
_amu_kg = 1.660539040e-27    # atomic mass constant, kg
_Nav = 6.022140857e23        # Avogadro number
_k_B = 1.38064852e-23        # Boltzmann constant, J/K
_eps0 = 8.854187817e-12      # vacuum permittivity, F/m
_hplanck = 6.626070040e-34   # Planck constant, J s

# --- internal units ---
Angstrom = Ang = 1.0
eV = 1.0
amu = 1.0

nm = 10.0 * Angstrom
Bohr = 4e10 * math.pi * _eps0 * (_hplanck / (2 * math.pi)) ** 2 / (_me * _e**2)

# time: second expressed in internal time units
second = 1e10 * math.sqrt(_e / _amu_kg)
fs = 1e-15 * second
ps = 1e-12 * second

# energy conversions
Joule = 1.0 / _e
kJ = 1000.0 * Joule
kcal = 4.184 * kJ
mol = _Nav
kJ_per_mol = kJ / mol            # ~0.010364 eV
kcal_per_mol = kcal / mol        # ~0.043364 eV
Hartree = 27.211386024367243     # eV (m_e e^4 / (4 eps0 h/2pi)^2 ..., CODATA14)

# Boltzmann constant in eV/K
kB = _k_B / _e                   # 8.6173303e-5

# Coulomb constant 1/(4 pi eps0) in eV*A/e^2
COULOMB = _e / (4 * math.pi * _eps0) * 1e10  # ~14.399645 eV*A

# reference unit constants (cited: the reference src/utils/reference.py:3-5)
HARTREE_TO_KCAL_MOL = 627.5094738898777
EV_TO_KCAL_MOL = 23.060548012069496
BOHR_TO_ANGSTROM = 0.5291772105638411
