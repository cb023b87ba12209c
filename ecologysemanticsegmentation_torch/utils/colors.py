"""Overlay colour table (copy of the JAX package's ``utils/colors.py``).

The reference's static RGB name table travels with the port as data
(``resources/color_constants.json``, the reference's ``colors`` dict, 551
entries in source order).  The reference keeps every entry (its filter is a
no-op) and shuffles them unseeded at import; here the shuffle is seeded
with 0, as the JAX package's default, so overlay colours repeat from run to
run.
"""

from __future__ import annotations

import json
import os
import random

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "resources", "color_constants.json")
_SHUFFLE_SEED = 0

with open(_PATH) as _f:
    COLOR_NAMES: dict[str, tuple[int, int, int]] = {
        k: tuple(int(c) for c in v) for k, v in json.load(_f).items()}
COLORS: list[tuple[int, int, int]] = list(COLOR_NAMES.values())
random.Random(_SHUFFLE_SEED).shuffle(COLORS)
