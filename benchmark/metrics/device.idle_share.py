"""device.idle_share: The device's idle share of the traced window, from the union of its operation intervals, %."""

from portbench.readers import idle_share


def read(obs):
    return idle_share(obs)
