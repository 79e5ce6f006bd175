"""Feature schema, size limits, and shared constants.

Mirrors the reference contract in
``project/utils/deepinteract_constants.py:10-116`` (limits, FEATURE_INDICES)
so converted data is bit-compatible, while adding TPU-side padding/bucketing
constants that have no reference equivalent.

Note on edge feature dimensionality: the reference stores 28 edge feature
columns (indices 0..27, with the amide angle at index 27 — see
``FEATURE_INDICES['edge_amide_angles']``) even though its dataset property
``num_edge_features`` reports 27 (`dips_dgl_dataset.py:269-271`, an
off-by-one never consumed anywhere). We make the true width explicit.
"""

# ---------------------------------------------------------------------------
# Size limits (reference: deepinteract_constants.py:10-13)
# ---------------------------------------------------------------------------
ATOM_COUNT_LIMIT = 2048
RESIDUE_COUNT_LIMIT = 256
NODE_COUNT_LIMIT = 2304
KNN = 20
GEO_NBRHD_SIZE = 2  # reference default: lit_model_predict.py:63, db5_dgl_dataset.py:70

# ---------------------------------------------------------------------------
# Node feature layout: 113 columns (reference: deepinteract_constants.py:99-116
# and convert_df_to_dgl_graph, deepinteract_utils.py:493-500)
# ---------------------------------------------------------------------------
NUM_NODE_FEATS = 113

NODE_POS_ENC = 0                    # min-max-normalized node index
NODE_GEO_FEATS = slice(1, 7)        # cos/sin of (phi, psi, omega) dihedrals
NODE_DIPS_FEATS = slice(7, 113)     # DIPS-Plus residue features, layout below

# DIPS-Plus residue feature sub-layout within columns 7..113
# (reference: FEAT_COLS/ALLOWABLE_FEATS, deepinteract_constants.py:64-96)
NODE_RESNAME_ONE_HOT = slice(7, 27)     # 20-way residue type
NODE_SS_ONE_HOT = slice(27, 35)         # 8-state DSSP secondary structure
NODE_RSA = 35                           # relative solvent accessibility
NODE_RD = 36                            # residue depth (MSMS)
NODE_PROTRUSION = slice(37, 43)         # 6 PSAIA protrusion-index stats
NODE_HSAAC = slice(43, 85)              # 42-dim half-sphere AA composition
NODE_CN = 85                            # coordination number
NODE_SEQUENCE_FEATS = slice(86, 113)    # 27 profile-HMM emission/transition probs

# ---------------------------------------------------------------------------
# Edge feature layout: 28 columns (reference: deepinteract_utils.py:503-531)
# ---------------------------------------------------------------------------
NUM_EDGE_FEATS = 28

EDGE_POS_ENC = 0                    # sin(src_idx - dst_idx)
EDGE_WEIGHT = 1                     # min-max-normalized squared CA-CA distance
EDGE_DIST_FEATS = slice(2, 20)      # 18 RBF bins over squared distances
EDGE_DIR_FEATS = slice(20, 23)      # unit direction to neighbor in local frame
EDGE_ORIENT_FEATS = slice(23, 27)   # relative-rotation quaternion
EDGE_AMIDE_ANGLE = 27               # min-max-normalized amide-plane angle

NUM_RBF = 18
NUM_DIST_FEATS = 18
NUM_DIR_FEATS = 3
NUM_ORIENT_FEATS = 4
NUM_AMIDE_FEATS = 1

# Number of raw "edge message" channels fed to the edge initializer
# (pos enc + edge weight; reference: deepinteract_modules.py:1354-1356).
NUM_EDGE_MESSAGE_FEATS = 2

NUM_CLASSES = 2

# ---------------------------------------------------------------------------
# Feature-generation constants shared with the data pipeline
# (reference: deepinteract_constants.py:37-62)
# ---------------------------------------------------------------------------
PSAIA_COLUMNS = ["avg_cx", "s_avg_cx", "s_ch_avg_cx", "s_ch_s_avg_cx", "max_cx", "min_cx"]
AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY-"
HSAAC_DIM = 42
NUM_ALLOWABLE_NANS = 5
NUM_SEQUENCE_FEATS = 27  # 20 emission + 7 transition profile-HMM probabilities

ALLOWABLE_RESNAMES = [
    "TRP", "PHE", "LYS", "PRO", "ASP", "ALA", "ARG", "CYS", "VAL", "THR",
    "GLY", "SER", "HIS", "LEU", "GLU", "TYR", "ILE", "ASN", "MET", "GLN",
]
ALLOWABLE_SS = ["H", "B", "E", "G", "I", "T", "S", "-"]

D3TO1 = {
    "CYS": "C", "ASP": "D", "SER": "S", "GLN": "Q", "LYS": "K",
    "ILE": "I", "PRO": "P", "THR": "T", "PHE": "F", "ASN": "N",
    "GLY": "G", "HIS": "H", "LEU": "L", "ARG": "R", "TRP": "W",
    "ALA": "A", "VAL": "V", "GLU": "E", "TYR": "Y", "MET": "M",
}

# ---------------------------------------------------------------------------
# TPU-side padding buckets (no reference equivalent; XLA needs static shapes).
# Chains are padded up to the smallest bucket that fits; each bucket compiles
# once. 256 matches RESIDUE_COUNT_LIMIT, the reference's training regime.
# ---------------------------------------------------------------------------
CHAIN_LENGTH_BUCKETS = (64, 128, 192, 256)
PAIR_MAP_TILE = 256  # tile edge for the blockwise long-context decoder
