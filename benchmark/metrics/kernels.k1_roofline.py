"""kernels.k1_roofline: K1's roofline bound over its own device time in the traced window, %."""

from counts.flops import K1_KERNEL
from portbench.readers import kernel_roofline


def read(obs):
    return kernel_roofline(obs, K1_KERNEL)
