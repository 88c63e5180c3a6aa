"""latency_p50_s: median (nearest rank) over the window's whole-file requests of the seconds from due to the whole wav; a request that never finished ranks beyond all others."""

from portbench.readers import request_tail


def read(obs):
    return request_tail(obs, False, "done_at", 0.5)
