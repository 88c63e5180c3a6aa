"""graphs.loop_host_ms_per_block: A decode loop's host time outside its blocks, per block, ms (*.loop less child *.block spans)."""

from portbench.spans import loop_host_ms_per_block


def read(obs):
    return loop_host_ms_per_block(obs)
