"""Frozen operation and byte counts of the program's kernels, one file a
kernel, and the table of the cards' peaks (``peaks.json``)."""

import json
import os
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))


def peaks(kind: str) -> Optional[dict]:
    """The published peaks of the card named ``kind`` (as
    ``torch.cuda.get_device_name`` gives it), or None for a card the table
    lacks."""
    with open(os.path.join(_DIR, "peaks.json")) as f:
        table = json.load(f)["cards"]
    return table.get(kind)
