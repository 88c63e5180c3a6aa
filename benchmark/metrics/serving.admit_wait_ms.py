"""serving.admit_wait_ms: A slot row's mean wait from its queueing to its admission, ms (the window's slot.admit spans)."""

from portbench.spans import admit_wait_ms


def read(obs):
    return admit_wait_ms(obs)
