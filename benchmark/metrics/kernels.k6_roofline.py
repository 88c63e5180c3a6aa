"""kernels.k6_roofline: K6's (decode_attn_kernel) roofline bound for the traced window's decode steps over its own device time, %."""

from portbench.readers import kernel_roofline


def read(obs):
    return kernel_roofline(obs, "decode_attn_kernel")
