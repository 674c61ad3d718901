"""Faults planted in a finished sample's jump libraries, as
`harness.collect` read them from the run dir, for the check to catch.
Each takes one library's arrays (jump_ec's reads and their alignlets)
and its insert, and returns a copy with the fault in it. The CPU tests
judge them on a tiny run; `readings.py` judges them on the card at a
cell's own size.
"""

import copy

import numpy as np


def shuffled_mates(j: dict, insert: int) -> dict:
    """The second mates shuffled among the library's pairs."""
    pairs = np.array(j["pairs"])
    pairs[:, 1] = np.random.default_rng(3).permutation(pairs[:, 1])
    return dict(j, pairs=pairs)


def shifted_anchors(j: dict, insert: int) -> dict:
    """Every alignlet's anchor moved by one insert."""
    return dict(j, anchor=np.asarray(j["anchor"]) + insert)


def dropped_pairs(j: dict, insert: int) -> dict:
    """Every pair dropped, as jump_ec leaves a pair it drops: no length
    and `pair_ok` false."""
    return dict(j, lengths=np.zeros_like(j["lengths"]),
                pair_ok=np.zeros_like(j["pair_ok"]))


# name: (the library it is planted in, the fault)
JUMP_FAULTS = {"shuffled_jump_mates": ("jump", shuffled_mates),
               "shifted_jump_anchors": ("jump", shifted_anchors),
               "long_jumps_dropped": ("long_jump", dropped_pairs)}


def planted(samples: list, read_sets: list, name: str) -> list:
    """Copies of `samples` with fault `name` planted in every one."""
    lib, fault = JUMP_FAULTS[name]
    out = []
    for rec in samples:
        rec = dict(rec, out=copy.copy(rec["out"]))
        jumps = dict(rec["out"]["jumps"])
        jumps[lib] = fault(jumps[lib],
                           read_sets[rec["set"]]["insert"][lib][0])
        rec["out"]["jumps"] = jumps
        out.append(rec)
    return out
