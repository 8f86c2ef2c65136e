"""Speaker-stable dataset split by SHA1 hash bucketing (a copy of ``honk_tpu.data.splits``).

Equivalent of the split logic in reference ``utils/train.py::SpeechDataset``
(the TF Speech Commands convention): the hash is taken over the filename
with the ``_nohash_<n>`` suffix stripped, so all clips from one speaker
land in the same split, and the membership matches the official benchmark
exactly — required so dev/test accuracy is comparable with the reference
(SURVEY.md §3.5, §4.4).
"""

from __future__ import annotations

import hashlib
import os
import re

MAX_NUM_WAVS_PER_CLASS = 2**27 - 1  # ~134M

TRAIN, DEV, TEST = 0, 1, 2


def which_set(filename: str, dev_pct: float = 10.0, test_pct: float = 10.0) -> int:
    """Return TRAIN/DEV/TEST for a Speech Commands wav path."""
    base = os.path.basename(filename)
    hash_name = re.sub(r"_nohash_.*$", "", base)
    h = hashlib.sha1(hash_name.encode("utf-8")).hexdigest()
    pct = (int(h, 16) % (MAX_NUM_WAVS_PER_CLASS + 1)) * (100.0 / MAX_NUM_WAVS_PER_CLASS)
    if pct < dev_pct:
        return DEV
    if pct < dev_pct + test_pct:
        return TEST
    return TRAIN
