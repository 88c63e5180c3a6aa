"""serving.ttfa_p90_s: 90th percentile over the window's streaming requests of the seconds from due to the first audio chunk in the caller's hands; a request with no chunk ranks beyond all others."""

from portbench.readers import request_tail


def read(obs):
    return request_tail(obs, True, "first_at", 0.9)
