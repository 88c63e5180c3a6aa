"""serving.admit_ms_per_row: A slot row's admission (its prefill and the write into the slot state), ms (slot.admit spans)."""

from portbench.spans import admit_ms_per_row


def read(obs):
    return admit_ms_per_row(obs)
