#!/usr/bin/env python3
"""Build variants of the Hopper general banded DP and time them on the card.

    python3 scripts/tune_banded_general.py [--variants "" src=F kBlockWarps=2
                                            x:A] [--ptxas] [--sass]
                                           [--sass-dump S] [--seed S]

A variant is a comma-separated list of NAME=VALUE; each sets the constant
`constexpr int NAME` in a copy of allpathslg_tpu_torch/csrc/banded_general.cu
under build/tune_banded_general/ ("" is the source as it is); `src=F` builds
the file F as it is instead (an earlier version of the kernel, e.g. `git
show 6d642d7:allpathslg_tpu_torch/csrc/banded_general.cu`, saved under
build/); `x:A+B` applies the timing experiments A and B of EXPERIMENTS, each
of which drops a part of the kernel's work (so it is timed, never checked).
Each is built by ops/cuda/nvcc.build_variant (with --ptxas, plus -Xptxas -v,
whose report of registers, shared memory and spills is printed; with
--sass, the source's library is disassembled by cuobjdump -sass and the
count of each instruction of the recurrence printed for each template),
checked exactly (cost and t_end) against the plain version on chip_smoke's
phase-6 input makers at run_full's three B = 8 patch_gaps shapes (8 x 64 x
512 at band 192, 8 x 128 x 512 at bands 96 and 48), B = 1 at band 16,
bench.py's shape (16,384 x 100 x 140, band 15), 16,384 x 256 x 512 at band
96, bands 0, 1, 2 and 255 and an edge set, and timed in turns
(chip_smoke.device_ms; variants, then variants reversed) at the first six.
Each timed shape prints its bound and its three terms (chip_smoke.
general_bound); the DPX latency and the empty launch that the chain term
uses are measured first (chip_smoke.chain_terms). Two `[steps]` pairs split
each variant's time into a cost a step and the rest of a launch: 8 x 128 x
512 at band 96 with every q_len 64 and 128 (a step is one wavefront step,
lanes = 32), and 16,384 x 256 x 512 at band 96 with every q_len 128 and
256 (a step is one row of all 16,384 problems). Needs one CUDA GPU and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from allpathslg_tpu_torch.ops.cuda import banded_general_cuda as bg  # noqa: E402
from allpathslg_tpu_torch.ops.cuda import nvcc  # noqa: E402

SOURCE = "banded_general.cu"
# Timing experiments: each drops one part of the kernel's work by an edit
# of the source, so its results are wrong and it is not checked.
# no_left: no horizontal closure (each slot's value is its up/diagonal
# minimum, so no dependent chain across a lane's slots);
# no_guard: every lane computes every step (no test of the lane's row);
# no_edge_bytes: no query or target codes handed along (no chunk loads, no
# code shuffles or register shift).
EXPERIMENTS = {
    "no_left": ("      const int v = __viaddmin_s32(nv, gp[s],\n"
                "                                   __viaddmin_s32(up, gap_cost, "
                "diag));\n",
                "      const int v = __viaddmin_s32(up, gap_cost, diag);\n"),
    "no_guard": ("    const bool active = static_cast<unsigned>(tau - l) <\n"
                 "                        static_cast<unsigned>(span);\n",
                 "    const bool active = true;\n"),
    "no_edge_bytes": (
        "    qc = l == 0 ? static_cast<int>(edge & 0xffu) : q_in;\n"
        "#pragma unroll\n"
        "    for (int s = 0; s + 1 < S; ++s) tc[s] = tc[s + 1];\n"
        "    tc[S - 1] = l == P - 1 ? static_cast<int>(edge >> 8) : t_in;\n",
        ""),
}
STEP_PAIRS = (("B = 8, band 96", 8, 128, 512, 96, (64, 128)),
              ("16,384 x 256 x 512, band 96", 16_384, 256, 512, 96,
               (128, 256)))
SASS_OPS = ("VIADDMNMX", "VIMNMX", "ISETP", "SEL", "IADD3", "IMAD", "MOV",
            "SHFL", "LDG", "PRMT", "BRA")


def build_variant(variant: str, ptxas: bool) -> Path:
    """The library of banded_general.cu with the variant's constants, or
    of the file a `src=` variant names, or of the source with the edits of
    an `x:` variant's experiments (joined by +)."""
    text = None
    if variant.startswith("src="):
        text = Path(variant[4:]).read_text()
    elif variant.startswith("x:"):
        text = (nvcc.CSRC / SOURCE).read_text()
        for name in variant[2:].split("+"):
            old, new = EXPERIMENTS[name]
            if text.count(old) != 1:
                raise RuntimeError(f"experiment {name} does not apply")
            text = text.replace(old, new)
    return nvcc.build_variant(SOURCE, "" if text else variant, ptxas,
                              text=text)


def print_sass(lib: Path, dump: int = 0):
    """Counts of the recurrence's instructions in each kernel template of
    `lib` (cuobjdump -sass), so that the DPX instructions show as emitted,
    not emulated; with `dump`, the whole SASS of template S = dump goes to
    build/tune_banded_general/sass_S<dump>.txt."""
    cuobjdump = Path(nvcc._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        m = re.search(r"ILi(\d+)E", name)
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                         block)
        counts = {op: sum(o.split(".")[0] == op for o in ops)
                  for op in SASS_OPS}
        shown = ", ".join(f"{k} {v}" for k, v in counts.items() if v)
        print(f"[sass] {name if not m else f'S = {m.group(1)}'}: "
              f"{len(ops)} instructions; {shown}", flush=True)
        if m and int(m.group(1)) == dump:
            out = nvcc.BUILD_DIR.parent / "tune_banded_general" / (
                f"sass_S{dump}.txt")
            out.write_text(block)
            print(f"[sass] S = {dump} written to {out}", flush=True)


def uniform(arrays, n: int):
    """The batch with every q_len = n (offset and t_len as they are)."""
    q, ql, t, tl, off = (a.copy() for a in arrays)
    ql[:] = n
    q = np.where(np.arange(q.shape[1])[None, :] < n, q, 4).astype(np.uint8)
    return q, ql, t, np.maximum(tl, 1), off


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=[""])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--sass-dump", type=int, default=0,
                    help="write the SASS of this S's template")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_banded_general: no CUDA device")
    _, int_rate = smoke.phase_card()
    paths = {v: build_variant(v, args.ptxas) for v in args.variants}
    if args.sass:
        print_sass(paths[""] if "" in paths else next(iter(paths.values())),
                   args.sass_dump)
    libs = {v: bg.bind(ctypes.CDLL(str(p))) for v, p in paths.items()}
    chain = smoke.chain_terms()

    def run_with(variant, fn):
        bg.library.lib = libs[variant]
        return fn()

    rng = np.random.default_rng(args.seed)

    def dp(B, Lq, Lt, band):
        q, ql, t, tl, off = smoke.dp_problems(rng, B, Lq, Lt, band)
        if B > 1:
            ql[rng.random(B) < 0.02] = 0
        q = np.where(np.arange(Lq)[None, :] < ql[:, None], q, 4)
        return q.astype(np.uint8), ql, t, tl, off

    timed = [(f"run_full patch_gaps B = 8, band {b}", b,
              smoke.patch_problems(rng, 8, lq, 512, b))
             for b, lq in ((192, 64), (96, 128), (48, 128))]
    timed += [("assisted B = 1, band 16", 16, dp(1, 128, 160, 16)),
              ("bench.py shape 16,384 x 100 x 140", 15,
               dp(16_384, 100, 140, 15)),
              ("16,384 x 256 x 512", 96, dp(16_384, 256, 512, 96))]
    for label, B, Lq, Lt, band, pair in STEP_PAIRS:
        base = (smoke.patch_problems(rng, B, Lq, Lt, band) if B == 8
                else dp(B, Lq, Lt, band))
        timed += [(f"{label}, every q_len {n}", band, uniform(base, n))
                  for n in pair]
    checked = [(f"band {b}", b, dp(4096, lq, lt, b))
               for b, lq, lt in ((0, 100, 140), (1, 100, 140),
                                 (2, 100, 140), (255, 64, 600))]
    checked.append(("edges, band 96", 96,
                    smoke.edge_problems(rng, 4096, 64, 160, 96)))
    dev = torch.device("cuda")
    cases = [(label, band, tuple(torch.from_numpy(np.ascontiguousarray(a))
                                 .to(dev) for a in arrays))
             for label, band, arrays in timed + checked]
    for label, band, arrays in cases:
        want = bg.banded_general_plain(*arrays, band=band)
        for variant in (v for v in args.variants if not v.startswith("x:")):
            got = run_with(variant, lambda: bg.banded_align_general(
                *arrays, band=band))
            torch.cuda.synchronize()
            smoke.check(torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1]),
                        f"{variant or 'source'}: kernel != plain on {label}")
        print(f"[check] {label}: every variant == plain (cost and t_end)",
              flush=True)

    order = list(args.variants) + list(reversed(args.variants))
    best = {}
    for label, band, arrays in cases[:len(timed)]:
        q, ql, t = arrays[0], arrays[1], arrays[2]
        t_ms = {v: [] for v in args.variants}
        for variant in order:
            t_ms[variant].append(run_with(variant, lambda: smoke.device_ms(
                lambda: bg.banded_align_general(*arrays, band=band))))
        bound, by, terms = smoke.general_bound(q, ql, t, arrays[4], band,
                                               int_rate, chain)
        shown = "; ".join(f"{v or 'source'}: " + " / ".join(
            f"{x:.5f}" for x in ms) + f" ms ({100 * bound / min(ms):.1f} %)"
            for v, ms in t_ms.items())
        print(f"[time] {label}, {tuple(q.shape)} x {t.shape[1]}, band "
              f"{band}: q_len mean {float(ql.float().mean()):.1f}, bound "
              f"{bound:.5f} ms by {by} (terms ms: {smoke.show_terms(terms)})"
              f"; {shown}", flush=True)
        best[label] = {v: min(ms) for v, ms in t_ms.items()}
    for label, B, Lq, Lt, band, (lo, hi) in STEP_PAIRS:
        for v in args.variants:
            t_lo = best[f"{label}, every q_len {lo}"][v]
            t_hi = best[f"{label}, every q_len {hi}"][v]
            slope = (t_hi - t_lo) / (hi - lo)
            dpx_steps = slope * 1e-3 / chain["dpx_s"]
            print(f"[steps] {v or 'source'}, {label}: {1e3 * slope:.5f} us "
                  f"a row ({dpx_steps:.1f} dependent DPX latencies); the "
                  f"rest of a launch {t_lo - lo * slope:.5f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
