"""Pipeline inputs (port of allpathslg_tpu/pipeline/run.py, the fragment
part of its simulated-input preparation). The reference's CLI, FASTQ and
library-sheet imports, and jump / long-jump / PacBio simulation are not
ported yet (ROADMAP.md)."""

from __future__ import annotations

import numpy as np

from allpathslg_tpu_torch.eval import sim
from allpathslg_tpu_torch.pipeline.rundir import RunDir


def prepare_sim_inputs(rd: RunDir, genome_size: int, coverage: float,
                       error_rate: float, read_len: int, seed: int, log):
    """PrepareAllPathsInputs analog for a simulated fragment library; also
    stores the truth genome. Same seeds and artifacts as the reference."""
    genome = sim.random_genome(genome_size, seed=seed)
    batch, pairs, _ = sim.simulate_paired_reads(
        genome, coverage=coverage, read_len=read_len,
        error_rate=error_rate, seed=seed + 1)
    rd.save_arrays("frag_reads_orig",
                   codes=np.asarray(batch.codes),
                   lengths=np.asarray(batch.lengths),
                   quals=np.asarray(batch.quals),
                   pairs=np.asarray(pairs.pairs))
    rd.save_arrays("genome_truth", genome=genome)
    log(f"[prepare] simulated genome={genome_size} reads={batch.n_reads}")
