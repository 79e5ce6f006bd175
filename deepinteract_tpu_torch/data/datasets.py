"""Datasets: DIPS-Plus, DB5-Plus and CASP-CAPRI over the npz tree.

Port of ``deepinteract_tpu/data/datasets.py``. A root directory holds
``processed/`` (one npz per complex, see ``data.io``) and split list files
``pairs-postprocessed-{mode}.txt`` (one relative path per line, the
reference's naming). ``percent_to_use`` subsamples with a persisted sample
file, so re-runs see the same subset; ``input_indep`` zeroes the input
features. Items are unpadded raw dicts: the loader pads and buckets them.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

from deepinteract_tpu_torch import constants
from deepinteract_tpu_torch.data.io import complex_lengths_from_file, load_complex_npz


class ComplexDataset:
    """File-list driven dataset of npz complexes."""

    name = "generic"
    num_node_features = constants.NUM_NODE_FEATS
    num_edge_features = constants.NUM_EDGE_FEATS
    num_classes = constants.NUM_CLASSES

    def __init__(self, root: str, mode: str = "train", percent_to_use: float = 1.0,
                 input_indep: bool = False, split_ver: Optional[str] = None,
                 seed: int = 42):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"unknown split mode {mode!r}")
        if not 0.0 < percent_to_use <= 1.0:
            raise ValueError(f"percent_to_use must be in (0, 1], got {percent_to_use}")
        self.root = root
        self.mode = mode
        self.input_indep = input_indep
        self.processed_dir = os.path.join(root, "processed")
        self.filenames = self._resolve_filenames(mode, percent_to_use, split_ver, seed)

    def _resolve_filenames(self, mode: str, percent: float, split_ver: Optional[str],
                           seed: int) -> List[str]:
        base = f"pairs-postprocessed-{mode}.txt"
        split_path = os.path.join(self.root, split_ver, base) if split_ver else \
            os.path.join(self.root, base)
        if not os.path.exists(split_path):
            raise FileNotFoundError(f"{type(self).__name__}: missing split file {split_path}")
        with open(split_path) as f:
            names = [line.strip() for line in f if line.strip()]
        if percent < 1.0:
            # The sampled subset is written once beside the split file and
            # reused (the reference's behavior).
            sampled_path = split_path.replace(".txt", f"-{int(percent * 100)}%.txt")
            if os.path.exists(sampled_path):
                with open(sampled_path) as f:
                    names = [line.strip() for line in f if line.strip()]
            else:
                names = random.Random(seed).sample(names, max(1, int(len(names) * percent)))
                with open(sampled_path, "w") as f:
                    f.write("\n".join(names) + "\n")
        return names

    def __len__(self) -> int:
        return len(self.filenames)

    def path_of(self, idx: int) -> str:
        rel = os.path.splitext(self.filenames[idx])[0] + ".npz"
        return os.path.join(self.processed_dir, rel)

    def target_of(self, idx: int) -> str:
        return os.path.splitext(os.path.basename(self.filenames[idx]))[0]

    def __getitem__(self, idx: int) -> Dict:
        raw = load_complex_npz(self.path_of(idx))
        raw["input_indep"] = self.input_indep
        raw["target"] = self.target_of(idx)
        return raw

    def lengths(self) -> List[tuple]:
        """(n1, n2) per item, from npy headers only."""
        return [complex_lengths_from_file(self.path_of(i)) for i in range(len(self))]


class DIPSDataset(ComplexDataset):
    """DIPS-Plus: 15,618 train / 3,548 val / 32 test complexes."""

    name = "DIPS-Plus"


class DB5Dataset(ComplexDataset):
    """DB5-Plus: 140 train / 35 val / 55 test unbound dimers."""

    name = "DB5-Plus"


class CASPCAPRIDataset(ComplexDataset):
    """CASP-CAPRI 13/14: 19 test-only dimers."""

    name = "CASP-CAPRI"

    def __init__(self, root: str, mode: str = "test", **kw):
        if mode != "test":
            raise ValueError("CASP-CAPRI is a test-only dataset")
        super().__init__(root, mode=mode, **kw)


class PICPDataModule:
    """The train/val/test sources of protein-interface contact prediction:
    train and val on DIPS-Plus or DB5-Plus, test on DIPS-Plus, DB5-Plus or
    CASP-CAPRI."""

    def __init__(self, dips_root: Optional[str] = None, db5_root: Optional[str] = None,
                 casp_capri_root: Optional[str] = None, train_with_db5: bool = False,
                 test_with_casp_capri: bool = False, percent_to_use: float = 1.0,
                 input_indep: bool = False, split_ver: Optional[str] = None, seed: int = 42):
        kw = dict(percent_to_use=percent_to_use, input_indep=input_indep, seed=seed)
        if train_with_db5:
            if not db5_root:
                raise ValueError("train_with_db5 requires db5_root")
            self.train = DB5Dataset(db5_root, mode="train", **kw)
            self.val = DB5Dataset(db5_root, mode="val", **kw)
        else:
            if not dips_root:
                raise ValueError("training requires dips_root")
            self.train = DIPSDataset(dips_root, mode="train", split_ver=split_ver, **kw)
            self.val = DIPSDataset(dips_root, mode="val", split_ver=split_ver, **kw)
        if test_with_casp_capri:
            if not casp_capri_root:
                raise ValueError("test_with_casp_capri requires casp_capri_root")
            self.test = CASPCAPRIDataset(casp_capri_root, input_indep=input_indep)
        elif train_with_db5:
            self.test = DB5Dataset(db5_root, mode="test", **kw)
        else:
            self.test = DIPSDataset(dips_root, mode="test", split_ver=split_ver, **kw)
