"""graphs.block_ms_per_step: A replayed decode block's host time (replay and read) per step it ran, ms (*.block spans)."""

from portbench.spans import block_ms_per_step


def read(obs):
    return block_ms_per_step(obs)
