"""The system under test, set up from the benchmark's own inputs: the
configuration file's model, and weights the benchmark makes from the seed
(reference/weights.py, with the tensors that the architecture's reference
lists) and loads into the program before any capture, with nothing written
but the configuration the engine reads. `arch` is the cell's architecture
reference (portbench.cell.Cell.reference)."""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch

from reference import weights as RW


def weights(arch, cfg: Dict[str, Any], seed: int, device) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The model's and the vocoder's weights from `seed`, in the served type."""
    dtype = getattr(torch, cfg["engine"]["dtype"]) if torch.device(device).type == "cuda" else torch.float32
    return RW.make_model(arch, cfg["gpt"], seed, device, dtype), RW.make_vocoder(cfg["bigvgan"], seed, device, dtype)


def engine(arch, cfg: Dict[str, Any], seed: int, device, workdir: str):
    """An IndexTTS engine of the configuration, holding the benchmark's
    weights for `seed`. The configuration goes to `workdir` as the YAML the
    engine reads; the model directory is empty (so the tokenizer is the
    random-init vocabulary, and the engine's own init is overwritten)."""
    from indextts_tpu_torch.config import IndexTTSConfig, save_config
    from indextts_tpu_torch.engine import IndexTTS

    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "config.yaml")
    save_config(IndexTTSConfig.from_dict({"gpt": cfg["gpt"], "bigvgan": cfg["bigvgan"]}), path)
    e = cfg["engine"]
    eng = IndexTTS(path, model_dir=os.path.join(workdir, "no-checkpoints"), device=str(device), allow_random_init=True,
                   seed=seed, quant_kv=e["quant_kv"], fast_latents=e["fast_latents"])
    load(eng, arch, cfg, seed, device)
    return eng


@torch.no_grad()
def load(eng, arch, cfg: Dict[str, Any], seed: int, device) -> None:
    """Copy the benchmark's weights for `seed` into the engine's models in
    place (the addresses its captured programs read stay the same)."""
    w_gpt, w_voc = weights(arch, cfg, seed, device)
    eng.gpt.load_state_dict(w_gpt, strict=True)
    eng.bigvgan.load_state_dict(w_voc, strict=True)
    del w_gpt, w_voc
