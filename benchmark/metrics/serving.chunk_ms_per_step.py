"""serving.chunk_ms_per_step: A slot session's decode chunk wall ms per step run (SlotSession.chunk_s over the slot blocks' steps)."""

from portbench.readers import chunk_ms_per_step


def read(obs):
    return chunk_ms_per_step(obs)
