"""kernels.k1_roofline: K1's roofline bound over its own device time in the traced window, %."""

from portbench.readers import k1_roofline


def read(obs):
    return k1_roofline(obs)
