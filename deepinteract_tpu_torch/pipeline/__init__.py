"""Raw-data pipeline: PDB files -> 113/28-schema graph pairs.

Port of ``deepinteract_tpu/pipeline/``: the featurization front end that
turns two PDB files into the complex ``cli.predict``, the server and the
dataset builder consume. It runs on the host, as in the JAX package: a
C++ library (:mod:`deepinteract_tpu_torch.pipeline.native`, the port's
own copy of ``geomfeats.cpp``) computes the O(atoms^2) geometry (SASA,
residue min-distance matrix, protrusion index, residue depth), with
vectorized numpy fallbacks, and numpy derives DSSP-style secondary
structure, HSAAC/CN and PSAIA-style protrusion statistics from them.
Sequence profiles need an hhblits binary and database
(``DI_HHBLITS_BIN`` / ``DI_HHBLITS_DB``); without them they are zeros
with a warning.
"""

from deepinteract_tpu_torch.pipeline.pdb import parse_pdb_chains, Chain
from deepinteract_tpu_torch.pipeline.pair import convert_pdb_pair_to_complex
