"""Fidelity evaluation on the port (tools/eval_fidelity.py, BASELINE config
#5): the DVAE's mel tokenize -> detokenize round-trip error, and BigVGAN
discriminator scoring of a reference waveform against a resynthesized one.

With dvae.pth / bigvgan_discriminator.pth in --model_dir it converts and
uses them (indextts_tpu_torch/convert.py) and reports the reference-comparable
numbers; without them it runs on seeded random init (the JAX init_*
distributions, seed 0), so the loop itself stays exercised. The DVAE and
the discriminators run in float32, and on CUDA without TF32: the tool turns
cuDNN's and cuBLAS's TF32 off for its run and restores them afterwards
(float32_numerics), so its numbers are float32's whatever the caller set.

Usage:
  python -m indextts_tpu_torch.eval_fidelity --wav tests/sample_prompt.wav \\
      [--wav_hat resynth.wav] [--model_dir checkpoints] [--cfg config.yaml] [-d cuda]

It prints one JSON line with the keys of tools/eval_fidelity.py.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from indextts_tpu_torch.config import BigVGANConfig, DVAEConfig, load_config
from indextts_tpu_torch.convert import convert_discriminator, convert_dvae, load_torch_state_dict
from indextts_tpu_torch.models.bigvgan import (MultiPeriodDiscriminator, MultiResolutionDiscriminator,
                                               discriminator_loss, feature_loss, mpd_apply, mrd_apply)
from indextts_tpu_torch.models.dvae import DiscreteVAE, dvae_infer, get_codebook_indices
from indextts_tpu_torch.utils.audio import load_audio
from indextts_tpu_torch.utils.mel import dvae_wav_to_mel
from indextts_tpu_torch.weights import load_jax_params


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--wav", default="tests/sample_prompt.wav")
    parser.add_argument("--wav_hat", default=None, help="resynthesized wav (defaults to --wav)")
    parser.add_argument("--model_dir", default=None, help="checkpoints dir with dvae.pth / bigvgan_discriminator.pth")
    parser.add_argument("--cfg", default=None,
                        help="config.yaml providing dvae/bigvgan sections (default: published scale)")
    parser.add_argument("-d", "--device", default="cuda", help="torch device (default cuda)")
    return parser.parse_args(argv)


@dataclass
class Fidelity:
    """The loop's models and inputs on one device: mel [1, T, 80] (T a
    multiple of 4) of --wav, the waveforms y and y_hat [1, n, 1] (n <= 24000),
    and the weights' sources as the JAX tool reports them."""

    dvae_cfg: DVAEConfig
    h: BigVGANConfig
    dvae: DiscreteVAE
    mpd: MultiPeriodDiscriminator
    mrd: MultiResolutionDiscriminator
    mel: torch.Tensor
    y: torch.Tensor
    y_hat: torch.Tensor
    dvae_weights: str
    discriminator_weights: str


def load(args: argparse.Namespace) -> Fidelity:
    """The checkpoints in --model_dir, else seeded random init, and the inputs."""
    dev = torch.device(args.device)
    if args.cfg:
        eng_cfg = load_config(args.cfg)
        dvae_cfg, h = eng_cfg.dvae, eng_cfg.bigvgan
    else:
        dvae_cfg, h = DVAEConfig(), BigVGANConfig()
    g = torch.Generator().manual_seed(0)
    dvae_path = args.model_dir and os.path.join(args.model_dir, "dvae.pth")
    disc_path = args.model_dir and os.path.join(args.model_dir, "bigvgan_discriminator.pth")

    dvae = DiscreteVAE(dvae_cfg)
    dvae_weights = "random-init"
    if dvae_path and os.path.exists(dvae_path):
        load_jax_params(dvae, convert_dvae(load_torch_state_dict(dvae_path), dvae_cfg))
        dvae_weights = dvae_path
    else:
        dvae.reset_parameters(g)
    mpd, mrd = MultiPeriodDiscriminator(h), MultiResolutionDiscriminator(h)
    disc_weights = "random-init"
    if disc_path and os.path.exists(disc_path):
        disc = convert_discriminator(load_torch_state_dict(disc_path), h)
        load_jax_params(mpd, disc["mpd"])
        load_jax_params(mrd, disc["mrd"])
        disc_weights = disc_path
    else:
        mpd.reset_parameters(g)
        mrd.reset_parameters(g)
    for m in (dvae, mpd, mrd):
        m.to(dev).eval()

    wav = load_audio(args.wav, 22050)
    wav_hat = load_audio(args.wav_hat, 22050) if args.wav_hat else wav
    mel = dvae_wav_to_mel(wav)  # [1, 80, T]
    t4 = (mel.shape[2] // 4) * 4
    mel_t = torch.from_numpy(np.ascontiguousarray(np.transpose(mel, (0, 2, 1))[:, :t4])).to(dev)
    n = min(wav.shape[1], wav_hat.shape[1], 24000)
    y, y_hat = (torch.from_numpy(np.ascontiguousarray(w[:, :n])).to(dev)[..., None] for w in (wav, wav_hat))
    return Fidelity(dvae_cfg, h, dvae, mpd, mrd, mel_t, y, y_hat, dvae_weights, disc_weights)


@torch.no_grad()
def dvae_round_trip(f: Fidelity) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes [1, T/4], round-trip MSE): tokenize, then tokenize -> detokenize."""
    codes = get_codebook_indices(f.dvae, f.dvae_cfg, f.mel)
    recon = dvae_infer(f.dvae, f.dvae_cfg, f.mel)
    return codes, torch.mean((recon[:, : f.mel.shape[1]] - f.mel) ** 2)


@torch.no_grad()
def discriminator_losses(f: Fidelity) -> List[torch.Tensor]:
    """MPD and MRD discriminator losses, then their feature losses, of y
    against y_hat."""
    rs, gs, fr, fg = mpd_apply(f.mpd, f.h, f.y, f.y_hat)
    rs2, gs2, fr2, fg2 = mrd_apply(f.mrd, f.h, f.y, f.y_hat)
    return [discriminator_loss(rs, gs)[0], discriminator_loss(rs2, gs2)[0], feature_loss(fr, fg),
            feature_loss(fr2, fg2)]


@contextlib.contextmanager
def float32_numerics(device: str):
    """On CUDA, TF32 off for cuDNN's convolutions and cuBLAS's matmuls (cuDNN
    allows it by default) while the block runs; both flags restored after."""
    if torch.device(device).type != "cuda":
        yield
        return
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def fidelity_report(args: argparse.Namespace) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(report, extras): the report of tools/eval_fidelity.py, and the DVAE
    codes [1, T/4] with the device-synchronized ms of each stage (dvae_ms,
    disc_ms: from the launch to the scalars on the host), in float32
    (float32_numerics)."""
    with float32_numerics(args.device):
        return _fidelity_report(args)


def _fidelity_report(args: argparse.Namespace) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    f = load(args)
    if f.mel.is_cuda:
        torch.cuda.synchronize(f.mel.device)
    t0 = time.perf_counter()
    codes, mse = dvae_round_trip(f)
    rt_mse, codes = float(mse), codes.cpu().numpy()
    dvae_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    losses = [float(v) for v in discriminator_losses(f)]
    disc_ms = 1e3 * (time.perf_counter() - t0)
    report = {
        "dvae_round_trip_mse": round(rt_mse, 6),
        "dvae_codes_used": int(len(np.unique(codes))),
        "mpd_disc_loss": round(losses[0], 4),
        "mrd_disc_loss": round(losses[1], 4),
        "mpd_feature_loss": round(losses[2], 4),
        "mrd_feature_loss": round(losses[3], 4),
        "dvae_weights": f.dvae_weights,
        "discriminator_weights": f.discriminator_weights,
    }
    extras = {"codes": codes, "losses": losses, "dvae_ms": dvae_ms, "disc_ms": disc_ms,
              "samples": f.y.shape[1], "mel_frames": f.mel.shape[1]}
    return report, extras


def main(argv=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Print the report as one JSON line; return it with its extras
    (fidelity_report)."""
    report, extras = fidelity_report(parse_args(argv))
    print(json.dumps(report))
    return report, extras


if __name__ == "__main__":
    main()
