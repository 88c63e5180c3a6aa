"""graphs.window_captures: Graph warm runs and captures inside the window (0: the warm-up covered the cell's keys)."""

from portbench.readers import window_captures


def read(obs):
    return window_captures(obs)
