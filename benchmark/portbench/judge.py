"""The check that decides `correct`: the program's served requests against
the plain reference (benchmark/reference/), and the lower-precision control.

What the program gives back is judged, request by request, on a sample of
the window's finished requests drawn from the seed (the longest always in
it): its sentence rows (the codes each row was served, keyed by the row's
text tokens), and its audio (the whole wav, or the streamed chunks). The
reference recomputes everything from the benchmark's own inputs (text,
prompt mel, weights) and the served codes:

  rows_missing  sentence rows of the reference's split that the program did
                not serve (its front end split or tokenized otherwise)
  len_mismatch  requests whose audio is not the served codes' length
  logit_gap     the widest gap, over every served code, by which its
                reference score lies below the least score the step's
                sampling could draw (for greedy rows: below the best)
  wav_rel_err   the largest relative L2 error of a request's audio against
                the reference's waveform of the same codes

The reference vocodes exactly as the engine's paths define the calls: one
call a sentence padded to 16 frames (infer), chunks of two sentences padded
to 32 frames (infer_batch, a slot session's whole-file requests), streamed
windows of chunk + overlap + 1 frames zeroed past the codes they cover and
padded to 32 (a slot session's streams). Where the engine pads a chunk by
fewer than EDGE frames, its batch may pad it by more; the last EDGE codes of
such a chunk are left out of the comparison (zero frames beyond the first
EDGE do not reach the valid samples: measured on the reference at the
published widths).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from reference import gpt as RG
from reference import text as RT
from reference import vocoder as RV

EDGE = 8


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def remove_long_silence(codes: np.ndarray, silent: int = 52, max_run: int = 30) -> np.ndarray:
    """The reference engine's silence trim (infer.py:244-298): where a row
    holds more than `max_run` silence codes, runs of them are cut to 10."""
    if int((codes == silent).sum()) <= max_run:
        return codes
    keep, run = [], 0
    for k, c in enumerate(codes):
        if c != silent:
            keep.append(k)
            run = 0
        elif run < 10:
            keep.append(k)
            run += 1
    return codes[keep]


def fp8(t: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per slice along `dim` (per output
    channel for weights) or per tensor (activations), returned in float32."""
    amax = t.abs().amax() if dim is None else t.abs().amax(dim=tuple(d for d in range(t.dim()) if d != dim),
                                                           keepdim=True)
    s = amax.clamp(min=1e-12) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def fp8_weights(W: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The control's weights: every matrix and convolution rounded to fp8
    per output channel; vectors (biases, norms, snake) as they are."""
    return {k: fp8(v, 0) if v.dim() >= 2 and v.is_floating_point() else v for k, v in W.items()}


class Model:
    """The reference (or the control) on one device: the architecture's
    plain reference `arch` (reference/models/<architecture>.py: its
    `conditioning` and `forward`) and the shared vocoder, float32 copies of
    the weights, TF32 off, and the activation rounding `act`."""

    def __init__(self, cfg: Dict[str, Any], arch, w_gpt, w_voc, device, control: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.arch = arch
        self.g, self.h = cfg["gpt"], cfg["bigvgan"]
        self.Wg = {k: v.to(device=device, dtype=torch.float32) if v.is_floating_point() else v.to(device)
                   for k, v in w_gpt.items()}
        self.Wv = {k: v.to(device=device, dtype=torch.float32) if v.is_floating_point() else v.to(device)
                   for k, v in w_voc.items()}
        if control:
            self.Wg, self.Wv = fp8_weights(self.Wg), fp8_weights(self.Wv)
        self.act = fp8 if control else RG._same
        self.device = device
        self.spc = 4 * int(np.prod(self.h["upsample_rates"]))

    def prompt(self, mel: np.ndarray):
        """(conditioning latents, speaker embedding) of a [1, 100, frames]
        prompt, padded to the engine's frame bucket (100)."""
        frames = mel.shape[-1]
        fb = max(_round_up(frames, 100), 100)
        m = torch.zeros(fb, mel.shape[1], device=self.device)
        m[:frames] = torch.from_numpy(np.ascontiguousarray(mel[0].T)).to(self.device)
        return self.arch.conditioning(self.Wg, self.g, m, frames, self.act), RV.ecapa(self.Wv, m, frames / fb, self.act)

    def vocode(self, lat: torch.Tensor, frames: int, spk: torch.Tensor) -> torch.Tensor:
        """The waveform of latents [n, D] zero-padded to `frames`."""
        pad = torch.zeros(frames - lat.shape[0], lat.shape[1], device=lat.device)
        return RV.bigvgan(self.Wv, self.h, torch.cat([lat, pad]), spk, self.act)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-12))


@torch.no_grad()
def judge_request(ref: Model, req: Dict[str, Any], served: Dict[tuple, np.ndarray], out: Dict[str, Any],
                  path: Dict[str, Any], control: Optional[Model] = None, draws: int = 0) -> Dict[str, Any]:
    """One request's numbers. `out`: {"wav": int16 [S]} or {"chunks": [int16
    arrays]}; `path`: how the engine served it (pos_off, quant_kv, beams,
    knobs, max_split, vocode: "sentence" | "pairs", stream_vocode for
    streamed requests: "stream", with chunk_steps, overlap, max_new). With `control`, the control's
    numbers on the same prompt and codes come back too: its code at each step
    drawn from its own support with uniforms seeded by `draws`."""
    dev = ref.device
    if req.get("stream"):
        path = dict(path, vocode=path["stream_vocode"])
    rows = RT.split_rows(RT.tokenize(req["text"]), path["max_split"])
    res = {"rows": len(rows), "rows_missing": 0, "len_mismatch": 0, "gap": 0.0, "tokens": 0,
           "greedy_tokens": 0, "wav_rel_err": None}
    if control is not None:
        res.update(ctrl_gap=None, ctrl_wav_rel_err=None)
    conds, spk = ref.prompt(req["mel"])
    if control is not None:
        c_conds, c_spk = control.prompt(req["mel"])
        gen = torch.Generator(device=dev).manual_seed(int(draws))
    knobs = dict(path["knobs"], top_p=0.0 if req.get("greedy") else path["knobs"]["top_p"])
    lats, c_lats = [], []
    for r in rows:
        codes_np = served.get(tuple(r))
        if codes_np is None:
            res["rows_missing"] += 1
            continue
        codes = torch.as_tensor(np.asarray(codes_np, np.int64), device=dev)
        text = torch.as_tensor(r, device=dev)
        logits, lat = ref.arch.forward(ref.Wg, ref.g, conds, text, codes, path["pos_off"], path["quant_kv"])
        gap = RG.support_gap(logits, codes, ref.g, knobs, path["beams"])
        res["gap"] = max(res["gap"], float(gap.max()))
        res["tokens"] += int(codes.shape[0])
        greedy = req.get("greedy") and not path["beams"]
        res["greedy_tokens"] += int(codes.shape[0]) if greedy else 0
        if control is not None:
            c_logits, c_lat = control.arch.forward(control.Wg, control.g, c_conds, text, codes, path["pos_off"],
                                                   path["quant_kv"], control.act)
            cg = float(RG.drawn_gap(logits, c_logits, codes, ref.g, knobs, path["beams"], gen).max())
            res["ctrl_gap"] = max(res["ctrl_gap"] or 0.0, cg)
        if path["vocode"] != "stream":
            kept = remove_long_silence(codes_np)
            if len(kept) != len(codes_np) or path["pos_off"] != 1:
                kt = torch.as_tensor(np.asarray(kept, np.int64), device=dev)
                _, lat = ref.arch.forward(ref.Wg, ref.g, conds, text, kt, 1)
                if control is not None:
                    _, c_lat = control.arch.forward(control.Wg, control.g, c_conds, text, kt, 1, act=control.act)
        lats.append(lat)
        c_lats.append(c_lat if control is not None else None)
    if res["rows_missing"]:
        return res
    ref_parts, c_parts, prog_parts = _audio(ref, path, lats, spk, out, res, control, c_lats,
                                            c_spk if control is not None else None)
    if ref_parts is None:
        return res
    r = torch.cat(ref_parts)
    res["wav_rel_err"] = _rel(torch.cat(prog_parts), r)
    if control is not None:
        res["ctrl_wav_rel_err"] = _rel(torch.cat(c_parts), r)
    return res


def _audio(ref: Model, path, lats, spk, out, res, control, c_lats, c_spk):
    """Pieces of (reference, control, program) audio to compare, float32."""
    spc = ref.spc
    dev = ref.device
    scale = 1.0 / 32767.0
    ref_p, c_p, prog_p = [], [], []

    def clip(w):  # the engine's int16 output: scaled, clipped (and truncated)
        return torch.clamp(w * 32767.0, -32767.0, 32767.0).trunc() * scale

    if path["vocode"] == "stream":
        chunks = [torch.as_tensor(np.asarray(c, np.float32), device=dev) * scale for c in out["chunks"]]
        total = sum(int(c.shape[0]) for c in chunks)
        if total != sum(lats_i.shape[0] for lats_i in lats) * spc or any(c.shape[0] % spc for c in chunks):
            res["len_mismatch"] = 1
            return None, None, None
        win = min(path["chunk_steps"] + path["overlap"] + 1, path["max_new"])
        frames = _round_up(win, 32)
        k = 0
        for ri, lat in enumerate(lats):
            emitted = 0
            while emitted < lat.shape[0]:
                n_now = emitted + chunks[k].shape[0] // spc
                start = max(min(max(emitted - path["overlap"], 0), path["max_new"] - win), 0)
                lo, hi = (emitted - start) * spc, (n_now - start) * spc

                def window(lt, sp, m):
                    w = lt[start : start + win].clone()
                    w[n_now - start :] = 0
                    return clip(m.vocode(w, frames, sp)[lo:hi])

                ref_p.append(window(lat, spk, ref))
                if control is not None:
                    c_p.append(window(c_lats[ri], c_spk, control))
                prog_p.append(chunks[k])
                emitted = n_now
                k += 1
        return ref_p, c_p, prog_p
    wav = torch.as_tensor(np.asarray(out["wav"], np.float32).reshape(-1), device=dev) * scale
    if wav.shape[0] != sum(l.shape[0] for l in lats) * spc:
        res["len_mismatch"] = 1
        return None, None, None
    groups = [[i] for i in range(len(lats))] if path["vocode"] == "sentence" else \
        [list(range(i, min(i + 2, len(lats)))) for i in range(0, len(lats), 2)]
    at = 0
    for grp in groups:
        lat = torch.cat([lats[i] for i in grp])
        n = lat.shape[0]
        frames = _round_up(n, 16 if path["vocode"] == "sentence" else 32)
        keep = n - EDGE if frames - n < EDGE and path["vocode"] != "sentence" else n
        ref_p.append(clip(ref.vocode(lat, frames, spk)[: keep * spc]))
        if control is not None:
            c_p.append(clip(control.vocode(torch.cat([c_lats[i] for i in grp]), frames, c_spk)[: keep * spc]))
        prog_p.append(wav[at : at + keep * spc])
        at += n * spc
    return ref_p, c_p, prog_p


def pick(requests: List[Dict[str, Any]], n: int, seed: int) -> List[int]:
    """The requests to judge: from the finished ones, the longest (most
    sentence tokens), every greedy one up to half of n, and the rest drawn
    from the seed."""
    done = [i for i, r in enumerate(requests) if r.get("out") is not None]
    if not done:
        return []
    rng = np.random.default_rng([int(seed), 3])
    longest = max(done, key=lambda i: sum(requests[i]["lengths"]))
    chosen = [longest]
    greedy = [i for i in done if requests[i].get("greedy") and i != longest]
    for i in rng.permutation(greedy)[: max(n // 2, 1)]:
        chosen.append(int(i))
    rest = [i for i in done if i not in chosen]
    for i in rng.permutation(rest)[: max(n - len(chosen), 0)]:
        chosen.append(int(i))
    return chosen


def draw_seed(seed: int, i: int) -> int:
    """The seed of the control's draws for the run's i-th request."""
    return int(np.random.default_rng([int(seed), 4, int(i)]).integers(2**62))


def as_control(r: Dict[str, Any]) -> Dict[str, Any]:
    """A request's control numbers in the shape summarize() reads."""
    return dict(r, gap=math.inf if r.get("ctrl_gap") is None else r["ctrl_gap"], wav_rel_err=r.get("ctrl_wav_rel_err"))


def summarize(results: List[Dict[str, Any]], limits: Dict[str, float]) -> Dict[str, Any]:
    """The numbers compared, each beside its limit, and `correct`."""
    nums = {
        "rows_missing": sum(r["rows_missing"] for r in results),
        "len_mismatch": sum(r["len_mismatch"] for r in results),
        "logit_gap": max((r["gap"] for r in results), default=math.inf),
        "wav_rel_err": max((r["wav_rel_err"] if r["wav_rel_err"] is not None else math.inf for r in results),
                           default=math.inf),
    }
    checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    ok = bool(results) and all(c["value"] <= c["limit"] for c in checks.values())
    return {"correct": ok, "checks": checks, "judged": len(results),
            "tokens": sum(r["tokens"] for r in results), "greedy_tokens": sum(r["greedy_tokens"] for r in results)}
