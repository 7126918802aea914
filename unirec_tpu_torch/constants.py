"""Constants and enumerations the ported slices read (copy of
unirec_tpu/constants.py)."""
from __future__ import annotations

import enum

EPS = 1e-8


class DataFormat(str, enum.Enum):
    """On-disk interaction file formats (reference protocols.py:12-52)."""

    T1 = "user-item"
    T1_1 = "user-item-max_len"
    T2 = "user-item-label"
    T2_1 = "user-item-label-session"
    T3 = "user-item-rating"
    T4 = "user-item_group-label_group"
    T5 = "user-item_seq"
    T5_1 = "user_item_seq"
    T6 = "user-item_seq-time_seq"
    T7 = "label-index_group-value_group"


class LossType(str, enum.Enum):
    BCE = "bce"
    BPR = "bpr"
    SOFTMAX = "softmax"
    CCL = "ccl"
    FULLSOFTMAX = "fullsoftmax"


class DistanceType(str, enum.Enum):
    DOT = "dot"
    COSINE = "cosine"
    MLP = "mlp"

