#!/usr/bin/env python3
"""Build variants of the Hopper bit-parallel banded DP and time them on
the card.

    python3 scripts/tune_banded_bp.py [--variants "" kThreads=64 src=F x:A]
                                      [--ptxas] [--seed S]

A variant is a comma-separated list of NAME=VALUE; each sets the constant
`constexpr int NAME` in a copy of allpathslg_tpu_torch/csrc/banded_bp.cu
under build/tune_banded_bp/ ("" is the source as it is); `src=F` builds
the file F as it is instead (an earlier version of the kernel, e.g. `git
show <commit>:allpathslg_tpu_torch/csrc/banded_bp.cu`, saved under build/);
`x:A+B` applies the timing experiments A and B of EXPERIMENTS, each of
which drops a part of the kernel's work (so it is timed, never checked).
Each is built by ops/cuda/nvcc.build_variant (with --ptxas, plus -Xptxas
-v, whose report of registers, shared memory and spills is printed), checked
exactly (cost and t_end) against the plain version on chip_smoke.dp_problems
at bands 1, 8 and 15, an N-bearing batch and the two batch shapes that
run_full gives the kernel (run_full_batch: 65,536 x 260 x 276 with q_len
over 0..188, mean ~132, and 65,536 x 100 x 116 with q_len over 0..100,
mean ~84; offset = band = 8, t_len = Lt), and timed in turns
(chip_smoke.device_ms: the device time of one call, with the launches
queued behind a sleep kernel; variants, then variants reversed) at the two
run_full shapes and at chip_smoke.py's set "a". Each timed batch prints
its share of idle lane-rows (a warp runs as long as its longest query)
and its bound (chip_smoke.dp_bound, chip_smoke.BP_OPS_PER_ROW integer
operations a row). Two more batches of set "a"'s shape, every q_len 32
and every q_len 188, split each variant's time into a cost a row (of all
65,536 problems, no lane idle) and the rest of a launch. Needs one CUDA
GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from allpathslg_tpu_torch.ops.cuda import banded_cuda, nvcc  # noqa: E402

# Timing experiments: each drops one part of the kernel's work by an edit
# of the source, so its results are wrong and it is not checked.
# no_chunk_loads: no loads or plane builds after the first two plane words;
# eq_from_registers: each row's Eq from registers, not shared memory.
EXPERIMENTS = {
    "no_chunk_loads": ("  const bool more = 32 * (m + 1) < n_rows;\n",
                       "  const bool more = false;\n"),
    "eq_from_registers": (
        "      const uint2 w = mine[min(code, 4u) * kThreads];\n",
        "      const uint2 w = make_uint2(code * 0x9E3779B9u, "
        "code ^ st.hi[0]);\n"),
}


UNIFORM_Q_LEN = (32, 188)


def build_variant(variant: str, ptxas: bool):
    """The bound library of banded_bp.cu with the variant's constants, or
    of the file a `src=` variant names, or of the source with the edits of
    an `x:` variant's experiments (joined by +)."""
    text = None
    if variant.startswith("src="):
        text = Path(variant[4:]).read_text()
    elif variant.startswith("x:"):
        text = (nvcc.CSRC / "banded_bp.cu").read_text()
        for name in variant[2:].split("+"):
            old, new = EXPERIMENTS[name]
            if text.count(old) != 1:
                raise RuntimeError(f"experiment {name} does not apply")
            text = text.replace(old, new)
    lib = nvcc.build_variant("banded_bp.cu", "" if text else variant,
                             ptxas, text=text)
    return banded_cuda.bind(ctypes.CDLL(str(lib)))


def run_full_batch(rng, stage: str, B: int = 65_536):
    """A batch shaped like those run_full gives the kernel (offset = band
    = 8, t_len = Lt), as numpy arrays (q, q_len, t, t_len, offset).
    "align_frags" (and polish): 260 x 276, the first ~77 % of the problems
    with q_len in 121..188 (mean ~170), the rest q_len 0 at the tail of the
    batch; "align_jumps": 100 x 116, q_len 100 for ~55 %, 0 for ~9 %, the
    rest in 30..99, spread over the batch."""
    band = 8
    Lq, Lt = {"align_frags": (260, 276), "align_jumps": (100, 116)}[stage]
    q, _, t, _, _ = smoke.dp_problems(rng, B, Lq, Lt, band)
    if stage == "align_frags":
        ql = 188 - np.abs(rng.normal(0, 22.5, B)).astype(np.int32)
        ql = np.clip(ql, 121, 188)
        ql[int(0.774 * B):] = 0
    else:
        ql = 100 - np.abs(rng.normal(0, 25, B)).astype(np.int32)
        ql = np.clip(ql, 30, 99)
        u = rng.random(B)
        ql[u < 0.55] = 100
        ql[u > 0.91] = 0
    return with_q_len(q, ql.astype(np.int32), t, band)


def with_q_len(q, ql, t, band: int):
    """(q, q_len, t, t_len, offset): q's rows past q_len set to code 4,
    offset = band, t_len = Lt."""
    B, Lq = q.shape
    q = np.where(np.arange(Lq)[None, :] < ql[:, None], q, 4).astype(np.uint8)
    return (q, ql, t, np.full(B, t.shape[1], np.int32),
            np.full(B, band, np.int32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=[""])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_banded_bp: no CUDA device")
    _, int_rate = smoke.phase_card()
    libs = {v: build_variant(v, args.ptxas) for v in args.variants}

    def run_with(variant, fn):
        banded_cuda.library.lib = libs[variant]
        return fn()

    rng = np.random.default_rng(args.seed)
    checked = [(f"band {b}", b, smoke.dp_problems(rng, 16_384, Lq, Lt, b))
               for b, Lq, Lt in ((1, 150, 160), (8, 260, 276),
                                 (15, 260, 290))]
    q, ql, t, tl, off = smoke.dp_problems(rng, 16_384, 101, 133, 6,
                                          with_n=True)
    ql[:64] = 0
    checked.append(("N-bearing, Lq 101, Lt 133, band 6", 6,
                    (q, ql, t, tl, off)))
    # every q_len the same (no idle lanes): the time against the rows
    q, _, t, _, _ = smoke.dp_problems(rng, 65_536, 260, 276, 8)
    uniform = {n: with_q_len(q, np.full(65_536, n, np.int32), t, 8)
               for n in UNIFORM_Q_LEN}
    timed = [("run_full align_frags 65,536 x 260 x 276", 8,
              run_full_batch(rng, "align_frags")),
             ("run_full align_jumps 65,536 x 100 x 116", 8,
              run_full_batch(rng, "align_jumps")),
             ('chip_smoke set "a" 65,536 x 260 x 276', 8,
              smoke.dp_problems(np.random.default_rng(args.seed + 2),
                                65_536, 260, 276, 8))]
    timed += [(f"65,536 x 260 x 276, every q_len {n}", 8, uniform[n])
              for n in UNIFORM_Q_LEN]
    dev = torch.device("cuda")
    cases = [(label, band, tuple(torch.from_numpy(np.ascontiguousarray(a))
                                 .to(dev) for a in arrays))
             for label, band, arrays in checked + timed]
    for label, band, arrays in cases:
        want = banded_cuda.banded_align_bp_plain(*arrays, band=band)
        for variant in (v for v in args.variants if not v.startswith("x:")):
            got = run_with(variant, lambda: banded_cuda.banded_align_bp(
                *arrays, band=band))
            torch.cuda.synchronize()
            smoke.check(torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1]),
                        f"{variant or 'source'}: kernel != plain on {label}")
        print(f"[check] {label}: every variant == plain (cost and t_end)",
              flush=True)

    order = list(args.variants) + list(reversed(args.variants))
    best = {}
    for label, band, arrays in cases[len(checked):]:
        q, ql, t = arrays[0], arrays[1], arrays[2]
        t_ms = {v: [] for v in args.variants}
        for variant in order:
            t_ms[variant].append(run_with(variant, lambda: smoke.device_ms(
                lambda: banded_cuda.banded_align_bp(*arrays, band=band))))
        bound, by = smoke.dp_bound(q, ql, t, arrays[4], band,
                                   smoke.BP_OPS_PER_ROW, int_rate)
        idle = smoke.lane_idle_share(ql.cpu().numpy(), q.shape[1])
        shown = "; ".join(f"{v or 'source'}: " + " / ".join(
            f"{x:.4f}" for x in ms) + f" ms ({100 * bound / min(ms):.1f} %)"
            for v, ms in t_ms.items())
        print(f"[time] {label}, band {band}: q_len mean "
              f"{float(ql.float().mean()):.1f}, idle lane-rows "
              f"{100 * idle:.1f} %, bound {bound:.4f} ms by {by}; {shown}",
              flush=True)
        best[label] = {v: min(ms) for v, ms in t_ms.items()}
    lo, hi = UNIFORM_Q_LEN
    row_bound = 65_536 * smoke.BP_OPS_PER_ROW / int_rate * 1e3
    for v in args.variants:
        t_lo = best[f"65,536 x 260 x 276, every q_len {lo}"][v]
        t_hi = best[f"65,536 x 260 x 276, every q_len {hi}"][v]
        slope = (t_hi - t_lo) / (hi - lo)
        print(f"[rows] {v or 'source'}: {1e3 * slope:.4f} us a row of "
              f"65,536 problems ({100 * row_bound / slope:.1f} % of "
              f"{smoke.BP_OPS_PER_ROW} instructions a row at the int32 "
              f"rate); the rest of a launch {t_lo - lo * slope:.4f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
