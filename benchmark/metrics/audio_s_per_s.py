"""audio_s_per_s: Seconds of audio completed in the window over the window's seconds: all the work over all the time."""

from portbench.readers import audio_rate


def read(obs):
    return audio_rate(obs)
