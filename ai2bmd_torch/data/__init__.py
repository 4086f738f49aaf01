"""Versioned data assets for ai2bmd_torch (a copy of ai2bmd_tpu/data).

All load-bearing tables of the reference stack, converted to numpy archives
by tools/convert_assets.py (see that script for provenance):

  * residue templates (fragment atomic numbers / bond graphs / self energies)
  * residue-triple -> AMBER atom order permutations
  * ff19SB capped-dipeptide AMBER topologies
  * per-(residue, atom) nonbonded parameters
"""

from __future__ import annotations

import functools
import os

import numpy as np

_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")

# Bundled example inputs (chig/trpcage/ww/abd + preprocessed chig box), the
# same structures the reference ships under examples/ — input data, kept
# in-repo so the framework runs standalone.
_EXAMPLES = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples")
)


def asset_path(name: str) -> str:
    return os.path.join(_ASSETS, name)


def examples_dir() -> str:
    return os.environ.get("AI2BMD_TPU_EXAMPLES", _EXAMPLES)


def example_pdb(name: str) -> str:
    """Path of a bundled example structure by short name.

    Accepts 'chig', 'trpcage', 'ww', 'abd', 'chig-preeq', 'chig-preeq-nowat'.
    """
    root = examples_dir()
    if name in ("chig-preeq", "chig-preeq-nowat"):
        return os.path.join(root, "chig_preprocessed", f"{name}.pdb")
    return os.path.join(root, f"{name}.pdb")


@functools.lru_cache(maxsize=None)
def residue_templates() -> dict:
    """Per-residue fragment templates.

    Returns a dict with:
      z[name]         -> int32 [n_atoms] atomic numbers of the capped fragment
      atoms[name]     -> list[str] element letters
      bonds[name]     -> (src, dst, length) covalent graph
      info[name]      -> (type_key, charge, multiplicity)
      self_energies   -> {z: hartree}
    """
    raw = np.load(asset_path("residue_templates.npz"), allow_pickle=False)
    names = [str(n) for n in raw["names"]]
    out = {
        "z": {n: raw[f"z_{n}"] for n in names},
        "atoms": {n: [str(a) for a in raw[f"atoms_{n}"]] for n in names},
        "bonds": {},
        "info": {},
        "self_energies": dict(
            zip(raw["self_energy_z"].tolist(), raw["self_energy_hartree"].tolist())
        ),
    }
    for n in names:
        if f"bond_src_{n}" in raw:
            out["bonds"][n] = (raw[f"bond_src_{n}"], raw[f"bond_dst_{n}"], raw[f"bond_len_{n}"])
    for n, t, c, m in zip(
        raw["info_names"], raw["info_type"], raw["info_charge"], raw["info_mult"]
    ):
        out["info"][str(n)] = (str(t), int(c), int(m))
    return out


@functools.lru_cache(maxsize=None)
def seq_permutations() -> dict[str, np.ndarray]:
    """{'PREV_CUR_NEXT': permutation}: target slot i takes source atom perm[i].

    Composed with the raw atom ordering it produces the AMBER template atom
    order the ViSNet checkpoints were trained on (reference:
    src/Fragmentation/distancefrag.py:731-737).
    """
    raw = np.load(asset_path("seq_permutations.npz"), allow_pickle=False)
    keys = [str(k) for k in raw["keys"]]
    flat, offsets = raw["flat"], raw["offsets"]
    return {
        k: flat[offsets[i]:offsets[i + 1]].astype(np.int64)
        for i, k in enumerate(keys)
    }


class FragmentTopology:
    """AMBER ff19SB topology of one capped-dipeptide template."""

    def __init__(self, raw, name: str):
        self.name = name
        for field in (
            "charges", "masses", "atomic_numbers", "atom_type_index",
            "nonbonded_parm_index", "lj_acoef", "lj_bcoef",
            "bond_k", "bond_r0", "angle_k", "angle_t0",
            "dihedral_k", "dihedral_n", "dihedral_phase", "scee", "scnb",
            "bonds_h", "bonds_noh", "angles_h", "angles_noh",
            "dihedrals_h", "dihedrals_noh",
            "number_excluded", "excluded_list", "residue_pointers",
        ):
            setattr(self, field, raw[f"{name}/{field}"])
        # CMAP fields (absent in assets converted before round 2)
        try:
            self.cmap_grids = raw[f"{name}/cmap_grids"]
            self.cmap_index = raw[f"{name}/cmap_index"]
            self.cmap_resolution = raw[f"{name}/cmap_resolution"]
        except KeyError:
            self.cmap_resolution = np.zeros((0,), np.int32)
            self.cmap_grids = np.zeros((0, 0, 0), np.float64)
            self.cmap_index = np.zeros((0, 6), np.int32)
        self.atom_names = [str(a) for a in raw[f"{name}/atom_names"]]
        self.residue_labels = [str(a) for a in raw[f"{name}/residue_labels"]]
        self.ntypes = int(raw[f"{name}/ntypes"])
        self.natom = len(self.charges)

    def lj_pair_index(self, ti, tj):
        return self.nonbonded_parm_index[self.ntypes * ti + tj]

    def residue_of_atom(self) -> np.ndarray:
        res = np.zeros(self.natom, dtype=np.int32)
        for i, start in enumerate(self.residue_pointers):
            res[start:] = i
        return res

    def exclusion_pairs(self) -> np.ndarray:
        out = []
        ptr = 0
        for i in range(self.natom):
            n = int(self.number_excluded[i])
            for j in self.excluded_list[ptr:ptr + n]:
                if j >= 0:
                    out.append((i, int(j)))
            ptr += n
        if not out:
            return np.zeros((0, 2), dtype=np.int32)
        return np.asarray(out, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def fragment_topologies() -> dict[str, FragmentTopology]:
    raw = np.load(asset_path("fragment_topologies.npz"), allow_pickle=False)
    return {str(n): FragmentTopology(raw, str(n)) for n in raw["names"]}


@functools.lru_cache(maxsize=None)
def ff_nonbonded() -> dict[tuple[str, str], tuple[float, float, float]]:
    """(residue, atom_name) -> (charge [e], sigma [A], eps [kcal/mol])."""
    raw = np.load(asset_path("ff_nonbonded.npz"), allow_pickle=False)
    return {
        (str(r), str(a)): (float(q), float(s), float(e))
        for r, a, q, s, e in zip(
            raw["residue"], raw["atom"], raw["charge"], raw["sigma"], raw["eps"]
        )
    }
