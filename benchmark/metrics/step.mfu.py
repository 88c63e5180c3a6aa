"""step.mfu: Model FLOPs of the traced window's work over the card's dense bf16 peak for the window, %."""

from portbench.readers import step_mfu


def read(obs):
    return step_mfu(obs)
