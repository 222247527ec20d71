"""Label taxonomy and fixed constants of the SemanticKITTI-MOS task (the
port's own copy of ``insmos_tpu/constants.py``; tests/test_torch_cli.py
holds the two equal).

Raw SemanticKITTI semantic ids (lower 16 bits of a .label word) collapse
onto 3 learning classes {0: unlabeled, 1: static, 2: moving}, as the
reference's semantic-kitti-mos.yaml label maps do; the inverse map emits
the artifact ids {0, 9, 251}.
"""

from __future__ import annotations

import numpy as np

N_MOS_CLASSES = 3
IGNORE_INDEX = (0,)  # "unlabeled" is ignored in losses/metrics

# raw id -> learning class. Raw ids 251..259 are the "moving" family; 0/1 are
# unlabeled/outlier; everything else is static.
_MOVING_RAW = (251, 252, 253, 254, 255, 256, 257, 258, 259)
_UNLABELED_RAW = (0, 1)

#: 260-entry lookup table raw semantic id -> {0,1,2}
LEARNING_MAP_TABLE = np.ones(260, dtype=np.int32)
LEARNING_MAP_TABLE[list(_UNLABELED_RAW)] = 0
LEARNING_MAP_TABLE[list(_MOVING_RAW)] = 2

#: learning class -> artifact label id (reference learning_map_inv)
LEARNING_MAP_INV = np.array([0, 9, 251], dtype=np.int32)

# Detection taxonomy: boundingbox_label raw class -> merged class
# {1,3,6}->1 car, 8->2 pedestrian, {9,10}->3 cyclist, else 0 (ignored).
DET_CLASS_NAMES = ("Car", "Pedestrian", "Cyclist")
N_DET_CLASSES = 3


def merge_det_class(raw: np.ndarray) -> np.ndarray:
    """Merge raw boundingbox_label classes into {0,1,2,3} (0 = ignore)."""
    raw = raw.astype(np.int64)
    out = np.zeros_like(raw)
    out[(raw == 1) | (raw == 3) | (raw == 6)] = 1
    out[raw == 8] = 2
    out[(raw == 9) | (raw == 10)] = 3
    return out


def map_semantic_labels(raw_labels: np.ndarray) -> np.ndarray:
    """Map raw .label words to learning classes {0,1,2}: the lower 16 bits,
    then the learning map. SemanticKITTI has no ids outside the table;
    any such id is clipped into the table's range."""
    sem = (raw_labels & 0xFFFF).astype(np.int64)
    sem = np.clip(sem, 0, len(LEARNING_MAP_TABLE) - 1)
    return LEARNING_MAP_TABLE[sem]


def to_original_labels(learning_labels: np.ndarray) -> np.ndarray:
    """Learning classes {0,1,2} -> artifact ids {0,9,251} (int32)."""
    return LEARNING_MAP_INV[np.asarray(learning_labels, dtype=np.int64)].astype(
        np.int32
    )
