"""kernels.k7_roofline: K7's (ssm_step_kernel) roofline bound for the traced window's decode steps over its own device time, %.

A traced run whose trace saw fewer K7 launches than the program's decode loops counted in the window (the
`k7_launches` of their loop spans) exits non-zero: the profiler lost events, and no share is read from it."""

import sys

from portbench.readers import kernel_roofline
from portbench.spans import in_window
from portbench.trace import own

FUNCTION = "ssm_step_kernel"


def read(obs):
    tr = obs.get("trace")
    if tr:
        seen = own(tr["kernels"], FUNCTION)[1]
        counted = sum(int(s[5].get("k7_launches", 0)) for s in in_window(obs) if s[2].endswith(".loop"))
        if seen < counted:
            print(f"kernels.k7_roofline: the trace recorded {seen} K7 launches where {counted} ran: the profiler "
                  f"lost events; no share is read from this trace", file=sys.stderr)
            sys.exit(4)
    return kernel_roofline(obs, FUNCTION)
