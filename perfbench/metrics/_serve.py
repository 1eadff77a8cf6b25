"""What the serving readers share: the traced cycle's decode steps (each
slot's positions, the CFG rows doubled) and its admissions."""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np


def decode_steps(trace) -> Iterator[Tuple[List[int], List[int]]]:
    """(positions, pads) of the 2P cache rows at each traced decode step."""
    f = trace.facts
    pads = np.concatenate([f["pads"], f["pads"]]).tolist()
    for k in range(f["n_steps"]):
        pos = f["pos_end"] - f["n_steps"] + k
        yield np.concatenate([pos, pos]).tolist(), pads
