"""Minimal PDB parser producing per-chain residue/atom arrays.

Port of ``deepinteract_tpu/pipeline/pdb.py`` (the port imports nothing
of the JAX package); every function gives the same arrays on the same
input.

Replaces the reference's Biopython ``PDB_PARSER`` + atom3 DataFrame front
end (deepinteract_constants.py:31-33, deepinteract_utils.py:611-628) with a
dependency-free column parser. Only what the featurizers need is kept:
heavy-atom coordinates grouped by residue, backbone extraction with the
reference's missing-atom substitution semantics
(``substitute_missing_atoms``, deepinteract_utils.py:311-383 — a missing
backbone atom borrows the residue's CA position), and CB lookup for amide
normal vectors.
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Dict, List, Optional, Sequence

import numpy as np

from deepinteract_tpu_torch import constants

BACKBONE_ATOMS = ("N", "CA", "C", "O")


@dataclasses.dataclass
class Chain:
    """One polypeptide chain as flat numpy arrays.

    Residue-level (length R):
      resnames:   list[str] three-letter codes
      res_ids:    list[str] author residue ids (number + insertion code)
      atom_start: [R+1] int CSR offsets into the atom arrays
    Atom-level (length A, heavy atoms only, altloc ' '/'A' only):
      atom_names: list[str]
      coords:     [A, 3] float32
      elements:   list[str]
    """

    chain_id: str
    resnames: List[str]
    res_ids: List[str]
    atom_start: np.ndarray
    atom_names: List[str]
    coords: np.ndarray
    elements: List[str]

    def __len__(self) -> int:
        return len(self.resnames)

    @property
    def num_atoms(self) -> int:
        return self.coords.shape[0]

    def residue_atoms(self, i: int) -> slice:
        return slice(int(self.atom_start[i]), int(self.atom_start[i + 1]))

    def atom_coord(self, i: int, name: str) -> Optional[np.ndarray]:
        s = self.residue_atoms(i)
        for a in range(s.start, s.stop):
            if self.atom_names[a] == name:
                return self.coords[a]
        return None

    def sequence(self) -> str:
        return "".join(constants.D3TO1.get(r, "-") for r in self.resnames)

    def slice_residues(self, start: int, stop: int) -> "Chain":
        """Contiguous residue window [start, stop) as a new Chain (atom
        arrays re-based). Used to derive fragment complexes from real
        structures (real-geometry multi-complex datasets, tools/
        real_data_proof.py) and for windowed analyses."""
        a0, a1 = int(self.atom_start[start]), int(self.atom_start[stop])
        return Chain(
            chain_id=self.chain_id,
            resnames=self.resnames[start:stop],
            res_ids=self.res_ids[start:stop],
            atom_start=np.asarray(self.atom_start[start : stop + 1]) - a0,
            atom_names=self.atom_names[a0:a1],
            coords=self.coords[a0:a1],
            elements=self.elements[a0:a1],
        )

    def backbone(self) -> np.ndarray:
        """[R, 4, 3] N/CA/C/O coordinates.

        Missing backbone atoms take the residue's CA coordinate — the
        reference's ``substitute_missing_atoms`` fallback
        (deepinteract_utils.py:311-383). A residue with no CA at all is
        not emitted by the parser (see ``parse_pdb_chains``).
        """
        r = len(self)
        out = np.zeros((r, 4, 3), dtype=np.float32)
        for i in range(r):
            ca = self.atom_coord(i, "CA")
            for j, name in enumerate(BACKBONE_ATOMS):
                c = self.atom_coord(i, name)
                out[i, j] = c if c is not None else ca
        return out

    def cb_coords(self) -> np.ndarray:
        """[R, 3] CB coordinates, NaN where absent (glycine etc.);
        consumers substitute a virtual CB (features.amide_normal_vectors)."""
        out = np.full((len(self), 3), np.nan, dtype=np.float32)
        for i in range(len(self)):
            cb = self.atom_coord(i, "CB")
            if cb is not None:
                out[i] = cb
        return out

    def side_chain_slices(self) -> List[np.ndarray]:
        """Per residue, indices of side-chain atoms (non-backbone heavy
        atoms) — the atoms PAIRpred's ``get_side_chain_vector`` averages
        over (dips_plus_utils.py:55-81)."""
        out = []
        for i in range(len(self)):
            s = self.residue_atoms(i)
            idx = [a for a in range(s.start, s.stop)
                   if self.atom_names[a] not in BACKBONE_ATOMS]
            out.append(np.asarray(idx, dtype=np.int32))
        return out


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def parse_pdb_chains(
    path: str,
    chain_ids: Optional[Sequence[str]] = None,
    model: int = 1,
) -> Dict[str, Chain]:
    """Parse ATOM records of one PDB file into per-chain arrays.

    Reference behaviors kept: first model only (postprocess_pruned_pair
    uses ``structure[0]``, dips_plus_utils.py:462), hetero residues and
    waters dropped (``residue.get_id()[0] == ' '`` filter, :456-458),
    hydrogens dropped, alternate locations resolved to ' '/'A', and
    residues without a CA atom skipped (the graph is CA-based).
    """
    per_chain: Dict[str, dict] = {}
    current_model = 0  # 0 = no MODEL record yet (implicit single-model file)
    with _open_maybe_gz(path) as fh:
        for line in fh:
            rec = line[:6]
            if rec == "MODEL ":
                try:
                    current_model = int(line[10:14])
                except ValueError:
                    current_model = model
                continue
            if rec == "ENDMDL":
                if current_model in (0, model):
                    break  # requested model fully read
                continue
            if rec != "ATOM  " or current_model not in (0, model):
                continue
            # Alternate locations: any altloc is accepted; the per-residue
            # duplicate-name filter below keeps the first conformer seen
            # (handles residues whose only conformers are labeled 'B').
            element = line[76:78].strip()
            if not element:
                # Legacy files without element columns: derive from the atom
                # name, skipping leading digits ('1HB' is a hydrogen).
                name_alpha = [c for c in line[12:16].strip() if c.isalpha()]
                element = name_alpha[0] if name_alpha else ""
            if element.upper().startswith("H") or element.upper() == "D":
                continue
            chain_id = line[21]
            if chain_ids is not None and chain_id not in chain_ids:
                continue
            atom_name = line[12:16].strip()
            resname = line[17:20].strip()
            res_id = line[22:27].strip()  # residue number + insertion code
            xyz = (float(line[30:38]), float(line[38:46]), float(line[46:54]))

            ch = per_chain.setdefault(
                chain_id,
                {"resnames": [], "res_ids": [], "atoms": [], "key_to_res": {}},
            )
            key = (resname, res_id)
            if key not in ch["key_to_res"]:
                ch["key_to_res"][key] = len(ch["resnames"])
                ch["resnames"].append(resname)
                ch["res_ids"].append(res_id)
                ch["atoms"].append([])
            ridx = ch["key_to_res"][key]
            # Drop duplicate atom names within a residue (altloc remnants).
            if any(n == atom_name for n, _, _ in ch["atoms"][ridx]):
                continue
            ch["atoms"][ridx].append((atom_name, xyz, element.upper()))

    chains: Dict[str, Chain] = {}
    for cid, ch in per_chain.items():
        keep = [i for i, atoms in enumerate(ch["atoms"])
                if any(n == "CA" for n, _, _ in atoms)]
        resnames = [ch["resnames"][i] for i in keep]
        res_ids = [ch["res_ids"][i] for i in keep]
        atom_names: List[str] = []
        elements: List[str] = []
        coords: List[tuple] = []
        atom_start = [0]
        for i in keep:
            for name, xyz, el in ch["atoms"][i]:
                atom_names.append(name)
                coords.append(xyz)
                elements.append(el)
            atom_start.append(len(atom_names))
        if not resnames:
            continue
        chains[cid] = Chain(
            chain_id=cid,
            resnames=resnames,
            res_ids=res_ids,
            atom_start=np.asarray(atom_start, dtype=np.int32),
            atom_names=atom_names,
            coords=np.asarray(coords, dtype=np.float32),
            elements=elements,
        )
    return chains


def merge_chains(chains: Sequence[Chain], chain_id: str = "M") -> Chain:
    """Concatenate several chains into one (the reference treats each PDB
    *file* as one structure; multimer files merge all selected chains —
    postprocess_pruned_pair's ``chains_selected``, dips_plus_utils.py:426)."""
    resnames: List[str] = []
    res_ids: List[str] = []
    atom_names: List[str] = []
    elements: List[str] = []
    coords_list: List[np.ndarray] = []
    atom_start = [0]
    for ch in chains:
        resnames.extend(ch.resnames)
        res_ids.extend(f"{ch.chain_id}:{r}" for r in ch.res_ids)
        atom_names.extend(ch.atom_names)
        elements.extend(ch.elements)
        coords_list.append(ch.coords)
        base = atom_start[-1]
        atom_start.extend(int(base + o) for o in ch.atom_start[1:])
    return Chain(
        chain_id=chain_id,
        resnames=resnames,
        res_ids=res_ids,
        atom_start=np.asarray(atom_start, dtype=np.int32),
        atom_names=atom_names,
        coords=np.concatenate(coords_list, axis=0) if coords_list else np.zeros((0, 3), np.float32),
        elements=elements,
    )


def write_pdb(chain: Chain, path: str) -> None:
    """Minimal PDB writer (ATOM records only) — the inverse of
    :func:`parse_pdb_chains` for single chains. Lets tools materialize
    derived structures (e.g. residue-window fragments) as files the
    builder CLI can re-ingest."""
    cid = (chain.chain_id or "A")[0]
    # di: allow[artifact-write] derived fragment materialization, regenerated from the source chain
    with open(path, "w") as fh:
        serial = 1
        for i, resname in enumerate(chain.resnames):
            res_id = chain.res_ids[i].split(":")[-1]
            try:
                res_seq = int("".join(c for c in res_id if c.isdigit() or c == "-"))
            except ValueError:
                res_seq = i + 1
            icode = res_id[-1] if res_id and res_id[-1].isalpha() else " "
            s = chain.residue_atoms(i)
            for a in range(s.start, s.stop):
                name = chain.atom_names[a]
                # PDB column rules: 4-char names start at col 13, shorter
                # element-leading names at col 14.
                name_field = name.ljust(4) if len(name) == 4 else f" {name:<3}"
                x, y, z = chain.coords[a]
                fh.write(
                    f"ATOM  {serial:5d} {name_field} {resname:<3s} {cid}"
                    f"{res_seq:4d}{icode}   {x:8.3f}{y:8.3f}{z:8.3f}"
                    f"{1.00:6.2f}{0.00:6.2f}          "
                    f"{chain.elements[a]:>2s}\n"
                )
                serial += 1
        fh.write("TER\nEND\n")
