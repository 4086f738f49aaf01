"""Host-side setup shared with ``ai2bmd_tpu``.

The PDB reader, atom reordering, ``Protein``, the fragment indexer, the
cap-topology tables, the data assets and the unit constants are plain numpy
and import no JAX, so the port uses them as they are.  This module is the
only place the port imports ``ai2bmd_tpu`` from; everything it names is
JAX-free (``tests/test_torch_slice.py`` checks that JAX never loads).
"""

from __future__ import annotations

from ai2bmd_tpu import units
from ai2bmd_tpu.data import example_pdb
from ai2bmd_tpu.frag.indexer import ACENME_LEN, ACENME_Z, FragmentIndex, build_fragment_index
from ai2bmd_tpu.frag.topology import TypeTopology, build_type_topology
from ai2bmd_tpu.io.pdb import read_pdb
from ai2bmd_tpu.io.reorder import normalize_atom_order
from ai2bmd_tpu.system import Protein

__all__ = [
    "ACENME_LEN", "ACENME_Z", "FragmentIndex", "Protein", "TypeTopology",
    "build_fragment_index", "build_type_topology", "example_pdb",
    "load_protein", "normalize_atom_order", "read_pdb", "units",
]


def load_protein(path: str) -> Protein:
    """Read a PDB file into a ``Protein`` in the fragmenter's atom order."""
    return Protein.from_atoms(normalize_atom_order(read_pdb(path)))
