"""engine.decode_ms_per_step: Decode ms per step: the calls' gpt_gen_s over their gpt_steps (IndexTTS.last_stats)."""

from portbench.readers import decode_ms_per_step


def read(obs):
    return decode_ms_per_step(obs)
