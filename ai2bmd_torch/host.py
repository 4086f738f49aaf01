"""Host-side setup: the names the rest of the port takes from its own copies
of the JAX package's numpy modules (``units``, ``data``, ``io``, ``system``,
``frag.indexer``, ``frag.topology``), and ``load_protein``.  Nothing here
imports ``ai2bmd_tpu`` or JAX.
"""

from __future__ import annotations

from ai2bmd_torch import units
from ai2bmd_torch.data import example_pdb
from ai2bmd_torch.frag.indexer import ACENME_LEN, ACENME_Z, FragmentIndex, build_fragment_index
from ai2bmd_torch.frag.topology import TypeTopology, build_type_topology
from ai2bmd_torch.io.pdb import read_pdb
from ai2bmd_torch.io.reorder import normalize_atom_order
from ai2bmd_torch.system import Protein

__all__ = [
    "ACENME_LEN", "ACENME_Z", "FragmentIndex", "Protein", "TypeTopology",
    "build_fragment_index", "build_type_topology", "example_pdb",
    "load_protein", "normalize_atom_order", "read_pdb", "units",
]


def load_protein(path: str) -> Protein:
    """Read a PDB file into a ``Protein`` in the fragmenter's atom order."""
    return Protein.from_atoms(normalize_atom_order(read_pdb(path)))
