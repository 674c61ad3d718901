"""Kernel tuning registry (port of allpathslg_tpu/tuning.py).

Device-kernel variant choices (flat sort vs bucketed grouping for k-mer
counting) give the same results but not the same speed, and the winner
depends on the card. Choices are measured once on the target card
(`python -m allpathslg_tpu_torch.tune_count`) and persisted to an
UNTRACKED per-user file (`$APLG_TUNING_FILE`, default
`~/.cache/allpathslg_tpu_torch/kernel_tuning.json`); the
`kernel_tuning.json` committed next to this module holds repo defaults only
and is never written at runtime. The env var `APLG_COUNT_ENGINE=flat|bucketed`
overrides both.

The file is the port's own, apart from the reference's
`~/.cache/allpathslg_tpu/kernel_tuning.json`: a winner measured for JAX on
a TPU is no winner for the port's Hopper kernels, so neither package reads
the other's.

Scope: "count_engine" routes the single-batch spectrum entry point
(`kmer.count.spectrum_reads_auto`); the pipeline's counting paths have one
engine (the flat sort), as in the reference.
"""

from __future__ import annotations

import functools
import json
import os

_REPO_DEFAULTS_FILE = os.path.join(os.path.dirname(__file__),
                                   "kernel_tuning.json")

DEFAULTS = {
    # k-mer counting/spectrum engine: "flat" = one global radix sort;
    # "bucketed" = batched row sorts + quantile buckets (ops/bucket_count.py)
    "count_engine": "flat",
}


def _user_file() -> str:
    env = os.environ.get("APLG_TUNING_FILE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "allpathslg_tpu_torch", "kernel_tuning.json")


@functools.lru_cache(maxsize=1)
def _load() -> dict:
    cur = dict(DEFAULTS)
    for path in (_REPO_DEFAULTS_FILE, _user_file()):
        try:
            with open(path) as f:
                cur.update(json.load(f))
        except Exception:
            pass
    return cur


def get(key: str) -> str:
    """APLG_<KEY> first, then the per-user file, the repo file, DEFAULTS."""
    env = os.environ.get("APLG_" + key.upper())
    if env:
        return env
    return _load().get(key, DEFAULTS[key])


def save(updates: dict) -> str:
    """Persist measured winners to the per-user tuning file (never the
    repo checkout: a card's winner is not a universal default)."""
    path = _user_file()
    cur = {}
    try:
        with open(path) as f:
            cur = json.load(f)
    except Exception:
        pass
    cur.update(updates)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cur, f, indent=1, sort_keys=True)
    _load.cache_clear()
    return path
