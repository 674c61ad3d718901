"""Mean seconds a sample in the stages of this layer (manifest elapsed_s)."""

from portbench.metrics import stage_mean_s

STAGES = ('fill_fragments', 'unipaths')


def read(ctx):
    return stage_mean_s(ctx, STAGES)
