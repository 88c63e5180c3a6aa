"""engine.vocoder_ms_per_audio_s: Vocoder ms per second of audio: the calls' bigvgan_s over their audio_s (IndexTTS.last_stats)."""

from portbench.readers import vocoder_ms_per_audio_s


def read(obs):
    return vocoder_ms_per_audio_s(obs)
