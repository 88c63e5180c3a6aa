"""The IndexTTS inference engine on PyTorch (port of indextts_tpu/engine.py:
the single-request `infer` path, the bucketed batch `infer_fast` path, the
streaming `infer_stream` path, and the serving paths: cross-request batches
in `infer_batch`, continuous batching in `slot_session` / `infer_slots`, and
`warmup`).

Public surface as the reference engine (indextts/infer.py: class IndexTTS):
__init__(cfg_path, model_dir, is_fp16, device, use_cuda_kernel), infer(),
infer_fast(), extract_features(), set_gr_progress_callback(),
torch_empty_cache(), remove_long_silence(), bucket_sentences(),
pad_tokens_cat(), and the JAX engine's infer_stream(), a generator of
float32 chunks, infer_batch(), slot_session(), infer_slots(), warmup() and
start_profiling() / stop_profiling() (a torch.profiler trace).
Underneath, PyTorch runs eagerly on `device` (default
"cuda"), in bf16 there when `is_fp16`, with the fused anti-aliased activation
kernel (K1) at every vocoder activation when `use_cuda_kernel` (the default).
`quant_kv` selects the int8 KV cache, as in the JAX engine; int8 GPT weights
(the K5 kernel in every decode matmul) come from
ops/quant.quantize_unified_voice(engine.gpt), a library call as in JAX. The
decode takes the reference's generation kwargs with their defaults: beam
search with num_beams=3, sampled (models/gpt_decode.generate_speech_beam);
`fast_latents` keeps the latents the decode computes and skips the
teacher-forced pass where silence removal left the codes as they were.
A request with max_mel_tokens >= 320 decodes with a KV cache that grows by
segments of 160 (generate_speech_segmented / generate_speech_beam_segmented),
as in the JAX engine. INDEXTTS_WIDE_BRANCH=1 sends the vocoder's wide
half-branches through K2, INDEXTTS_WIDE_TMAJOR=1 its wide activations through
K3, INDEXTTS_FUSED_AA=1 its narrow stages' resblock activations through K4
(models/bigvgan.py).

Weights load as the JAX engine loads them, GPT and BigVGAN each on its own:
the <checkpoint>.npz cache of a converted tree first, else the reference's
.pth (converted by convert.py, and the cache written beside it), else random
init from `seed` when `allow_random_init`, else FileNotFoundError.

The same shape buckets as the JAX engine are kept, because padding changes
numbers: text is padded with stop_text_token to a multiple of 8, codes to a
multiple of 16, prompt mel frames to a multiple of 100 (ECAPA then gets
relative lengths), vocoder latents to a multiple of 16 (32 in the batched
vocoder of infer_fast).
"""

from __future__ import annotations

import hashlib
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from indextts_tpu_torch.config import IndexTTSConfig, load_config
from indextts_tpu_torch.convert import (convert_bigvgan, convert_unified_voice, load_params_npz, load_torch_state_dict,
                                        save_params_npz)
from indextts_tpu_torch.models.bigvgan import BigVGAN, bigvgan_apply
from indextts_tpu_torch.models.gpt import UnifiedVoice, get_conditioning, unified_voice_forward
from indextts_tpu_torch.models.gpt_decode import (
    GenerationConfig,
    decode_steps,
    generate_speech,
    generate_speech_beam,
    generate_speech_beam_segmented,
    generate_speech_segmented,
    prefill_decode_state,
)
from indextts_tpu_torch.ops.sampling import RowDraw
from indextts_tpu_torch.parallel.mesh import env_world_size, init_distributed, make_mesh, shard_batch, shard_gpt_params
from indextts_tpu_torch.utils.audio import decode_audio, resample, write_wav
from indextts_tpu_torch.utils.front import TextNormalizer, TextTokenizer
from indextts_tpu_torch.utils.mel import MelSpectrogramFeatures
from indextts_tpu_torch.weights import load_jax_params


# a request whose max_mel_tokens reaches two segments decodes with a growing cache
DECODE_SEGMENT = 160


def make_tokenizer(bpe_path: str, normalizer: TextNormalizer, allow_random_init: bool) -> TextTokenizer:
    """The BPE tokenizer of `bpe_path`; where that file is missing, the
    random-init vocabulary (26 upper-case letters, "." and "▁") when
    `allow_random_init`, else FileNotFoundError, as the JAX engine does."""
    if os.path.exists(bpe_path):
        tokenizer = TextTokenizer(bpe_path, normalizer)
        print(">> bpe model loaded from:", bpe_path)
        return tokenizer
    if not allow_random_init:
        raise FileNotFoundError(bpe_path)
    from indextts_tpu_torch.utils.spm import SentencePieceProcessor, build_vocab_from_pieces

    pieces = [(chr(65 + i), -float(i)) for i in range(26)] + [(".", -30.0), ("▁", -31.0)]
    return TextTokenizer(sp_model=SentencePieceProcessor(vocab=build_vocab_from_pieces(pieces)), normalizer=normalizer)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class IndexTTS:
    def __init__(
        self,
        cfg_path: str = "checkpoints/config.yaml",
        model_dir: str = "checkpoints",
        is_fp16: bool = True,
        device: str = "cuda",
        use_cuda_kernel: bool = True,
        allow_random_init: bool = False,
        seed: int = 0,
        use_mesh: Optional[bool] = None,
        tp: Optional[int] = None,
        quant_kv: bool = False,
        fast_latents: bool = False,
    ):
        """`is_fp16` selects bf16 compute off the CPU. `use_cuda_kernel` routes
        every vocoder activation to the fused kernel K1 (its plain version on
        the CPU); off, the composed torch path runs. `model_dir` holds the
        reference's checkpoints (cfg.gpt_checkpoint, cfg.bigvgan_checkpoint,
        bpe.model) or their .npz caches; where one is missing,
        `allow_random_init` builds that model from `seed` with the JAX init_*
        distributions, else FileNotFoundError. Weights load in float32 and
        are then cast to the engine's dtype. Weights of the JAX engine can be
        copied in afterwards with weights.load_jax_params(self.gpt, ...) /
        (self.bigvgan, ...).
        `quant_kv`: decode with the int8 KV cache (per head-pair and position
        scales); opt-in, since K/V rounding changes the sampled numbers.
        `fast_latents`: the JAX engine's consistent-positions mode. The
        decode runs with the teacher-forced pass's mel positions and keeps
        the final-norm hiddens it computes (for beams, the winner's), and
        the teacher-forced latent pass is skipped whenever silence removal
        left the codes as they were. Codes then differ slightly from the
        reference's generate() (other positions); off by default.
        `use_mesh` / `tp`: run as one rank of a (data, model) mesh over
        torch.distributed (parallel/mesh.py): the GPT tensor-parallel over
        `tp` ranks (default 2 where the world is even), batch rows over the
        data groups. use_mesh=None means on when the process group is
        initialized, or torchrun's environment is set, with more than one
        rank (the group is then initialized from that environment). Every
        rank builds or loads the whole model from the same seed or checkpoint
        and keeps its shard, and makes the same calls with the same
        arguments; each request is checked for that (_agree). The device is
        cuda:{LOCAL_RANK} when every local rank has a card, else the one
        card (over gloo). Only rank 0 writes output files. `self.mesh` is
        None on one process."""
        self.mesh = None
        if use_mesh is None:
            use_mesh = env_world_size() > 1
        if use_mesh and env_world_size() > 1:
            init_distributed(device)
            self.mesh = make_mesh(tp=tp, device=device)
            device = self.mesh.device
        self.device = torch.device(device)
        self.is_fp16 = bool(is_fp16) and self.device.type != "cpu"
        self.dtype = torch.bfloat16 if self.is_fp16 else torch.float32
        self.use_cuda_kernel = bool(use_cuda_kernel)
        self.quant_kv = bool(quant_kv)
        self.fast_latents = bool(fast_latents)
        self.cfg: IndexTTSConfig = load_config(cfg_path) if os.path.exists(cfg_path) else IndexTTSConfig()
        self.model_dir = model_dir
        self.stop_mel_token = self.cfg.gpt.stop_mel_token

        g = torch.Generator(device=self.device).manual_seed(seed)
        with torch.device(self.device):
            self.gpt = UnifiedVoice(self.cfg.gpt)
            self.bigvgan = BigVGAN(self.cfg.bigvgan)
        self._load_weights(self.gpt, "GPT", os.path.join(model_dir, self.cfg.gpt_checkpoint), None,
                           lambda sd: convert_unified_voice(sd, self.cfg.gpt), allow_random_init, g)
        self._load_weights(self.bigvgan, "bigvgan", os.path.join(model_dir, self.cfg.bigvgan_checkpoint), "generator",
                           lambda sd: convert_bigvgan(sd, self.cfg.bigvgan), allow_random_init, g)
        for m in (self.gpt, self.bigvgan):
            # .to(device) also moves buffers built from numpy (the conformer's PE table)
            m.to(device=self.device, dtype=self.dtype).eval().requires_grad_(False)
        if self.mesh is not None:
            # the GPT keeps this rank's tensor-parallel shard; the vocoder,
            # ECAPA and the conditioning encoders stay replicated
            shard_gpt_params(self.gpt, self.mesh, quant_kv=self.quant_kv)
            print(f">> mesh: {self.mesh.describe()} (tensor-parallel GPT)")

        bpe_path = os.path.join(model_dir, self.cfg.dataset.get("bpe_model", "bpe.model"))
        self.normalizer = TextNormalizer()
        self.normalizer.load()
        self.tokenizer = make_tokenizer(bpe_path, self.normalizer, allow_random_init)
        self.wav2mel = MelSpectrogramFeatures()
        self.gr_progress: Optional[Callable[[float, str], None]] = None
        self._profiler = None
        self._trace_dir: Optional[str] = None
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._value_cache: Dict[Any, Any] = {}
        self._feature_cache: Dict[Any, np.ndarray] = {}
        # stage times and counts of the last infer() / infer_fast() / infer_stream() call
        self.last_stats: Dict[str, Any] = {}
        # segments the segmented decode loops ran since a request last zeroed it
        self._decode_segments = 0

    @staticmethod
    def _load_weights(module, name: str, path: str, key: Optional[str], convert, allow_random_init: bool,
                      g: torch.Generator) -> None:
        """Fill `module` (float32) as indextts_tpu/engine.py:160-212 does: the
        converted tree cached at `path`.npz, else the .pth at `path` (the
        state dict under `key`), converted and then cached (a cache that
        cannot be written is passed over), else random init from `g` when
        `allow_random_init`, else FileNotFoundError(path)."""
        if os.path.exists(path + ".npz"):
            load_jax_params(module, load_params_npz(path + ".npz"))
            print(f">> {name} weights restored from cache:", path + ".npz")
        elif os.path.exists(path):
            converted = convert(load_torch_state_dict(path, key=key))
            try:
                save_params_npz(converted, path + ".npz")
            except OSError:
                pass
            load_jax_params(module, converted)
            print(f">> {name} weights restored from:", path)
        elif allow_random_init:
            module.reset_parameters(g)
            print(f">> {name} randomly initialized (no checkpoint at", path, ")")
        else:
            raise FileNotFoundError(path)

    # ------------------------------------------------------------------
    # features / host helpers (reference: infer.py:82-329)
    # ------------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def set_gr_progress_callback(self, _callback):
        """`_callback(value, description)` is called at the stages of infer,
        infer_fast and infer_batch (the reference's Gradio progress hook)."""
        self.gr_progress = _callback

    def _set_gr_progress(self, value, desc):
        if self.gr_progress is not None:
            self.gr_progress(value, desc)

    def torch_empty_cache(self):
        """Hand the CUDA allocator's cached blocks back to the device
        (reference: infer.py:320-329); nothing to do on the CPU."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def start_profiling(self, logdir: str = "/tmp/indextts_trace"):
        """Trace the synthesis calls that follow with torch.profiler (host
        activity, and the device's kernels on a CUDA engine) until
        stop_profiling, which writes a Chrome trace under `logdir`."""
        from torch.profiler import ProfilerActivity, profile

        if self._profiler is not None:
            raise RuntimeError("start_profiling: a trace is already running; call stop_profiling first")
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        os.makedirs(logdir, exist_ok=True)
        self._profiler = profile(activities=activities)
        self._profiler.start()
        self._trace_dir = logdir

    def stop_profiling(self) -> Optional[str]:
        """End the trace: `logdir`/indextts_trace_<n>.json (chrome://tracing,
        Perfetto). Returns the directory, None when no trace was running."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return self._trace_dir
        self._sync()
        prof.stop()
        n = sum(1 for f in os.listdir(self._trace_dir) if f.startswith("indextts_trace_"))
        prof.export_chrome_trace(os.path.join(self._trace_dir, f"indextts_trace_{n}.json"))
        return self._trace_dir

    def extract_features(self, audio_prompt_path: str) -> np.ndarray:
        """Prompt audio -> log-mel [1, 100, frames] (reference: infer.py:82-93):
        mono by mean, resampled to 24 kHz. Memoized by (path, mtime)."""
        try:
            key = (audio_prompt_path, os.path.getmtime(audio_prompt_path))
        except OSError:
            key = (audio_prompt_path, None)
        cached = self._feature_cache.get(key)
        if cached is not None:
            return cached
        print(f">> extracting prompt mel spectrogram: {audio_prompt_path}")
        audio, sr = decode_audio(audio_prompt_path)
        audio = audio.mean(axis=0, keepdims=True)
        if sr != 24000:
            audio = resample(audio, sr, 24000)
        cond_mel = self.wav2mel(np.clip(audio, -1, 1)).astype(np.float32)
        if len(self._feature_cache) >= 16:
            self._feature_cache.pop(next(iter(self._feature_cache)))
        self._feature_cache[key] = cond_mel
        return cond_mel

    def remove_long_silence(self, codes: np.ndarray, silent_token=52, max_consecutive=30):
        """Shrink runs of the silence code and trim at the stop token
        (reference: infer.py:244-298)."""
        codes = np.asarray(codes)
        code_lens = []
        codes_list = []
        for i in range(codes.shape[0]):
            code = codes[i]
            stop_idx = np.nonzero(code == self.stop_mel_token)[0]
            len_ = int(stop_idx[0]) if stop_idx.size else code.shape[0]
            count = int((code[:len_] == silent_token).sum())
            trimmed = code[:len_]
            if count > max_consecutive:
                keep = []
                run = 0
                for k in range(len_):
                    if code[k] != silent_token:
                        keep.append(k)
                        run = 0
                    elif run < 10:
                        keep.append(k)
                        run += 1
                trimmed = code[keep]
                len_ = len(trimmed)
            codes_list.append(trimmed)
            code_lens.append(len_)
        max_len = max(code_lens) if code_lens else 0
        out = np.full((len(codes_list), max_len), self.stop_mel_token, dtype=codes.dtype)
        for i, c in enumerate(codes_list):
            out[i, : len(c)] = c
        return out, np.asarray(code_lens, dtype=np.int64)

    # ------------------------------------------------------------------
    # stages (bucketed shapes, as the JAX engine)
    # ------------------------------------------------------------------

    def _cache_value(self, key, make, bound: int):
        """Value cache under a FIFO bound per key kind."""
        if key not in self._value_cache:
            same_kind = [k for k in self._value_cache if k[0] == key[0]]
            if len(same_kind) >= bound:
                del self._value_cache[same_kind[0]]
            self._value_cache[key] = make()
        return self._value_cache[key]

    @torch.no_grad()
    def _conds_for(self, prompt_mel: np.ndarray) -> torch.Tensor:
        """Conditioning latents [1, latents, D] for a [1, 100, frames] prompt
        mel, frames zero-padded to a multiple of 100; cached per prompt."""

        def make():
            frames = prompt_mel.shape[-1]
            bucket = max(_round_up(frames, 100), 100)
            mel = np.zeros((1, bucket, prompt_mel.shape[1]), np.float32)
            mel[0, :frames] = prompt_mel[0].T
            mel_t = torch.from_numpy(mel).to(self.device, self.dtype)
            lens = torch.tensor([frames], device=self.device)
            return get_conditioning(self.gpt, self.cfg.gpt, mel_t, lens)

        digest = hashlib.sha1(np.ascontiguousarray(prompt_mel)).hexdigest()
        return self._cache_value(("condval", digest), make, 128)

    @torch.no_grad()
    def _conds_for_many(self, prompt_mels: List[np.ndarray]) -> List[torch.Tensor]:
        """Conditioning latents for several [1, 100, frames] prompts with ONE
        batched call per frame bucket, for cache misses only; hits come from
        the per-prompt value cache shared with _conds_for (and its bound of
        128). Prompts are de-duplicated by digest. Misses group by the SAME
        frame bucket _conds_for uses: the conformer's conv module is not
        pad-invariant (as in the reference), so padding a prompt to a larger
        shared bucket would change its latents against the solo path. Batch
        rows pad to a power of two."""
        digests = [hashlib.sha1(np.ascontiguousarray(m)).hexdigest() for m in prompt_mels]
        out: Dict[str, torch.Tensor] = {}
        groups: Dict[int, List[Tuple[str, int]]] = {}
        seen = set()
        for i, d in enumerate(digests):
            if d in seen:
                continue
            seen.add(d)
            cached = self._value_cache.get(("condval", d))
            if cached is not None:
                out[d] = cached
                continue
            groups.setdefault(max(_round_up(prompt_mels[i].shape[-1], 100), 100), []).append((d, i))
        for bucket, entries in groups.items():
            if len(entries) == 1:
                d, i = entries[0]
                out[d] = self._conds_for(prompt_mels[i])
                continue
            nb = 1 << (len(entries) - 1).bit_length()
            mel = np.zeros((nb, bucket, prompt_mels[entries[0][1]].shape[1]), np.float32)
            lens = np.ones((nb,), np.int64)
            for r, (d, i) in enumerate(entries):
                f = prompt_mels[i].shape[-1]
                mel[r, :f] = prompt_mels[i][0].T
                lens[r] = f
            conds = get_conditioning(self.gpt, self.cfg.gpt, torch.from_numpy(mel).to(self.device, self.dtype),
                                     torch.from_numpy(lens).to(self.device))
            for r, (d, i) in enumerate(entries):
                out[d] = self._cache_value(("condval", d), lambda r=r: conds[r : r + 1].clone(), 128)
        return [out[d] for d in digests]

    def _text_bucket(self, n: int) -> int:
        """Text length rounded up to 8, clamped to the text positional table."""
        return min(max(_round_up(n, 8), 8), max(self.cfg.gpt.max_text_tokens, n))

    def _code_bucket(self, n: int) -> int:
        """Mel-code length rounded up to 16, clamped to the mel positional table."""
        return min(max(_round_up(n, 16), 16), max(self.cfg.gpt.max_mel_tokens, n))

    def bucket_sentences(self, sentences, bucket_max_size=4) -> List[List[Dict]]:
        """Length-sorted fixed-capacity buckets (reference: infer.py:303-315)."""
        outputs = [{"idx": idx, "sent": sent, "len": len(sent)} for idx, sent in enumerate(sentences)]
        if len(outputs) <= bucket_max_size:
            return [outputs]
        buckets: List[List[Dict]] = []
        for sent in sorted(outputs, key=lambda x: x["len"]):
            if not buckets or len(buckets[-1]) >= bucket_max_size:
                buckets.append([sent])
            else:
                buckets[-1].append(sent)
        return buckets

    def pad_tokens_cat(self, tokens: List[np.ndarray]) -> np.ndarray:
        """Rows of text tokens right-padded with stop_text_token to the longest."""
        max_len = max(t.shape[-1] for t in tokens)
        out = np.full((len(tokens), max_len), self.cfg.gpt.stop_text_token, dtype=np.int64)
        for i, t in enumerate(tokens):
            t = np.asarray(t).reshape(-1)
            out[i, : t.shape[0]] = t
        return out

    def _gpt_generate(self, conds, text_tokens: np.ndarray, text_lengths: np.ndarray, gen: GenerationConfig,
                      temperature, top_p, repetition_penalty, length_penalty=0.0, typical_mass=0.9):
        """The decode over text padded to its bucket: beam search when
        gen.num_beams > 1, else greedy / sampled; with the segment-growing
        cache from gen.max_new_tokens >= 2 * DECODE_SEGMENT. conds is [1, C, D]
        or one row per text row; each dynamic knob a float or a numpy [B]
        with one value per row. Returns (codes,
        lengths) in numpy, the captured latents [B, max_new, D] on the device
        under fast_latents (else None), and the number of decode steps run.
        On a mesh with data groups, B > 1 rows pad to a multiple of dp by
        repeating the last row (as the JAX engine does), each data group
        decodes its slice, and the outputs are gathered and the padding cut
        off (_dp_decode)."""
        b, l0 = text_tokens.shape
        padded = np.full((b, self._text_bucket(l0)), self.cfg.gpt.stop_text_token, np.int64)
        padded[:, :l0] = text_tokens
        text_lengths = np.asarray(text_lengths)
        conds = conds.expand(b, -1, -1)
        knobs = (temperature, top_p, repetition_penalty, length_penalty, typical_mass)
        if self.mesh is not None and self.mesh.dp > 1 and b > 1:
            codes, lengths, lat, steps = self._dp_decode(conds, padded, text_lengths, gen, knobs)
        else:
            codes, lengths, lat, steps = self._decode(conds, padded, text_lengths, gen, knobs, self._generator)
        return codes.cpu().numpy(), lengths.cpu().numpy(), lat, steps

    def _decode(self, conds, padded: np.ndarray, text_lengths: np.ndarray, gen: GenerationConfig, knobs,
                generator):
        """_gpt_generate's decode on rows already padded to their bucket;
        returns the codes and lengths as device tensors."""
        capture = self.fast_latents
        # a knob given per row (infer_batch's per_request_kwargs) goes in as a [B] tensor
        temperature, top_p, repetition_penalty, length_penalty, typical_mass = (
            torch.as_tensor(v, dtype=torch.float32, device=self.device) if isinstance(v, np.ndarray) else v
            for v in knobs)
        args = (self.gpt, self.cfg.gpt, gen, conds.to(self.dtype), torch.from_numpy(padded).to(self.device),
                torch.as_tensor(text_lengths, dtype=torch.long, device=self.device), generator)
        kw = dict(temperature=temperature, top_p=top_p, repetition_penalty=repetition_penalty,
                  typical_mass=typical_mass, quant_kv=self.quant_kv, capture_latents=capture,
                  pos_off=1 if capture else 2)
        stats = {}
        if gen.max_new_tokens >= 2 * DECODE_SEGMENT:
            kw.update(segment=DECODE_SEGMENT, stats=stats)
            if gen.num_beams > 1:
                out = generate_speech_beam_segmented(*args, length_penalty=length_penalty, **kw)
            else:
                out = generate_speech_segmented(*args, **kw)
        elif gen.num_beams > 1:
            out = generate_speech_beam(*args, length_penalty=length_penalty, stats=stats, **kw)
        else:
            out = generate_speech(*args, **kw)
        self._decode_segments += stats.get("segments", 0)
        steps = stats.get("steps", int(out[1].max()) - 1)
        return out[0], out[1], (out[2] if capture else None), steps

    def _dp_decode(self, conds, padded: np.ndarray, text_lengths: np.ndarray, gen: GenerationConfig, knobs):
        """The data-parallel decode: the batch padded to a multiple of dp by
        repeating its last row, this data group's rows decoded (a RowDraw
        keeps the sampled draws those of the whole padded batch), codes,
        lengths and captured latents gathered over the data group and the
        padding sliced off. The data groups run different numbers of steps,
        so the generator state of the one that ran the most (that of a
        single process) is then broadcast to every rank."""
        mesh, b = self.mesh, padded.shape[0]
        rep = lambda a: np.concatenate([a, np.repeat(a[-1:], -b % mesh.dp, axis=0)])
        padded, text_lengths = rep(padded), rep(text_lengths)
        n = padded.shape[0]
        conds = torch.cat([conds, conds[-1:].expand(n - b, -1, -1)])
        start, stop = mesh.rows(n)
        knobs = tuple(rep(v)[start:stop] if isinstance(v, np.ndarray) else v for v in knobs)
        codes, lengths, lat, steps = self._decode(conds[start:stop], padded[start:stop], text_lengths[start:stop],
                                                  gen, knobs, RowDraw(self._generator, start, n))
        gather = mesh.data.gather
        codes, lengths = gather(codes)[:b], gather(lengths)[:b]
        lat = None if lat is None else gather(lat)[:b]
        steps_all = gather(torch.tensor([steps], device=self.device)).tolist()
        src = int(np.argmax(steps_all)) * mesh.tp  # model index 0 of the data group that ran the most steps
        self._generator.set_state(mesh.world.broadcast(self._generator.get_state(), src))
        return codes, lengths, lat, max(steps_all)

    @torch.no_grad()
    def _gpt_latent(self, conds, text_tokens: np.ndarray, codes: np.ndarray, code_lens: np.ndarray,
                    text_lengths: Optional[np.ndarray] = None) -> torch.Tensor:
        """Teacher-forced latents [B, code bucket, D] for the generated codes.
        text_lengths [B]: each row's true text length (default: the full
        width, for per-row callers)."""
        b, lt0 = text_tokens.shape
        if text_lengths is None:
            text_lengths = np.full(b, lt0, np.int64)
        text = np.full((b, self._text_bucket(lt0)), self.cfg.gpt.stop_text_token, np.int64)
        text[:, :lt0] = text_tokens
        lc0 = codes.shape[1]
        codes_p = np.full((b, self._code_bucket(lc0)), self.stop_mel_token, np.int64)
        codes_p[:, :lc0] = codes
        dev = self.device
        return unified_voice_forward(
            self.gpt, self.cfg.gpt, None,
            text_inputs=torch.from_numpy(text).to(dev),
            text_lengths=torch.as_tensor(np.asarray(text_lengths), dtype=torch.long, device=dev),
            mel_codes=torch.from_numpy(codes_p).to(dev),
            wav_lengths=torch.as_tensor(np.asarray(code_lens) * self.cfg.gpt.mel_length_compression, device=dev),
            cond_mel_lengths=None, conds=conds.expand(b, -1, -1).to(self.dtype), mask_pad_keys=True,
        )

    def _gpt_latent_many(self, rows) -> List[torch.Tensor]:
        """Batched teacher-forced latents (port of the JAX engine's
        _gpt_latent_many). rows: (conds [1, C, D], text_tokens [1, Lt],
        codes [1, Lc], code_lens [1]); returns per-row latents [1, Lc, D] in
        input order. Rows group by (text bucket, code bucket), at most 16 to a
        batch padded to a power of two with zero conds rows; the pass is
        per-row independent, so batched equals per-row."""
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, (_cds, tt, cd, _cl) in enumerate(rows):
            groups.setdefault((self._text_bucket(tt.shape[1]), self._code_bucket(cd.shape[1])), []).append(i)
        out: List[Optional[torch.Tensor]] = [None] * len(rows)
        bucket_max = 16
        for (lt, lc), idxs in sorted(groups.items()):
            for k in range(0, len(idxs), bucket_max):
                part = idxs[k : k + bucket_max]
                b0 = len(part)
                b = 1 << (b0 - 1).bit_length()
                text = np.full((b, lt), self.cfg.gpt.stop_text_token, np.int64)
                tlens = np.ones((b,), np.int64)
                codes_p = np.full((b, lc), self.stop_mel_token, np.int64)
                clens = np.ones((b,), np.int64)
                conds_rows = []
                for j, i in enumerate(part):
                    cds, tt, cd, cl = rows[i]
                    text[j, : tt.shape[1]] = tt[0]
                    tlens[j] = tt.shape[1]
                    codes_p[j, : cd.shape[1]] = cd[0]
                    clens[j] = int(np.asarray(cl).reshape(-1)[0])
                    conds_rows.append(cds.to(self.dtype))
                if b != b0:
                    conds_rows.append(conds_rows[0].new_zeros((b - b0,) + tuple(conds_rows[0].shape[1:])))
                lat = self._gpt_latent(torch.cat(conds_rows, dim=0), text, codes_p, clens, text_lengths=tlens)
                for j, i in enumerate(part):
                    out[i] = lat[j : j + 1, : rows[i][2].shape[1]]
        return out

    def _samples_per_code(self) -> int:
        h = self.cfg.bigvgan
        return (4 if h.feat_upsample else 1) * int(np.prod(h.upsample_rates))

    def _mel_ref_for(self, prompt_mel: np.ndarray, b: int):
        """Reference mel [b, fb, 100] with frames zero-padded to a multiple of
        100, and ECAPA's relative lengths; cached per prompt."""
        frames = prompt_mel.shape[-1]
        fb = max(_round_up(frames, 100), 100)

        def make():
            mel_ref = np.zeros((b, fb, prompt_mel.shape[1]), np.float32)
            mel_ref[:, :frames] = np.transpose(prompt_mel, (0, 2, 1))
            return (torch.from_numpy(mel_ref).to(self.device, self.dtype),
                    torch.full((b,), frames / fb, dtype=torch.float32, device=self.device))

        digest = hashlib.sha1(np.ascontiguousarray(prompt_mel)).hexdigest()
        return self._cache_value(("melref", digest, b), make, 16)

    @torch.no_grad()
    def _vocode(self, latent: torch.Tensor, n_valid: int, prompt_mel: np.ndarray) -> np.ndarray:
        """latent [1, m, D] -> wav [1, samples] float32; pads the latent to a
        multiple of 16 frames and trims the wav to n_valid codes."""
        m0 = latent.shape[1]
        m = max(_round_up(m0, 16), 16)
        latent = torch.nn.functional.pad(latent, (0, 0, 0, m - m0))
        mel_ref, lens = self._mel_ref_for(prompt_mel, latent.shape[0])
        wav = bigvgan_apply(self.bigvgan, self.cfg.bigvgan, latent.to(self.dtype), mel_ref, lens=lens,
                            use_cuda_kernel=self.use_cuda_kernel)
        wav = wav[..., 0].float().cpu().numpy()
        return wav[:, : n_valid * self._samples_per_code()]

    def _vocode_rows(self, latent: torch.Tensor, mel_ref: torch.Tensor, lens: torch.Tensor,
                     split: bool = False) -> torch.Tensor:
        """One vocoder call: latent [b, m, D], mel_ref [b, frames, 100] and
        ECAPA's relative lengths [b] -> wav [b, samples] float32. `split`
        (a mesh with data groups, b a multiple of dp): each data group
        vocodes its slice of the rows and the waves are gathered."""
        if split:
            latent, mel_ref, lens = shard_batch(self.mesh, (latent, mel_ref, lens))
        wav = bigvgan_apply(self.bigvgan, self.cfg.bigvgan, latent, mel_ref, lens=lens,
                            use_cuda_kernel=self.use_cuda_kernel)[:, :, 0].float()
        return self.mesh.data.gather(wav) if split else wav

    @staticmethod
    def _vocode_batches(chunks) -> List[Tuple[int, List[int]]]:
        """The vocoder calls _vocode_many makes for `chunks`, each as (prompt
        frame bucket, chunk indices): chunks group by prompt frame bucket;
        within a group they sort by latent length and batch in neighbours of
        at most 16."""
        groups: Dict[int, List[int]] = {}
        for i, (_lat, _nv, mel) in enumerate(chunks):
            groups.setdefault(max(_round_up(mel.shape[-1], 100), 100), []).append(i)
        bucket_max = 16
        batches = []
        for fb, idxs in sorted(groups.items()):
            idxs.sort(key=lambda i: chunks[i][0].shape[1])
            batches.extend((fb, idxs[k : k + bucket_max]) for k in range(0, len(idxs), bucket_max))
        return batches

    @torch.no_grad()
    def _vocode_many(self, chunks) -> List[np.ndarray]:
        """Batched vocoder (port of the JAX engine's _vocode_many). chunks:
        (latent [1, Tc, D], n_valid codes, prompt_mel [1, 100, frames]);
        returns int16 wavs [1, n_valid * samples per code] in input order,
        scaled and clipped on the device. One call per batch of
        _vocode_batches, each latent zero-padded to the batch's longest
        rounded up to 32 frames, the batch padded to a power of two with zero
        rows. Each row's ECAPA relative length masks its own zero-padded
        prompt frames. On a mesh with data groups, a batch of more than one
        chunk pads to a multiple of dp, each data group vocodes its slice of
        the rows and the waves are gathered (the vocoder is replicated)."""
        spc = self._samples_per_code()
        out: List[Optional[np.ndarray]] = [None] * len(chunks)
        for fb, part in self._vocode_batches(chunks):
            m = max(_round_up(max(chunks[i][0].shape[1] for i in part), 32), 32)
            b0 = len(part)
            dp = self.mesh.dp if self.mesh is not None and b0 > 1 else 1
            b = _round_up(1 << (b0 - 1).bit_length(), dp)
            lat_rows = [torch.nn.functional.pad(chunks[i][0].to(self.dtype), (0, 0, 0, m - chunks[i][0].shape[1]))
                        for i in part]
            if b != b0:
                lat_rows.append(lat_rows[0].new_zeros((b - b0, m, lat_rows[0].shape[2])))
            n_mels = chunks[part[0]][2].shape[1]
            mel_b = np.zeros((b, fb, n_mels), np.float32)
            rel = np.ones((b,), np.float32)
            for j, i in enumerate(part):
                mel = chunks[i][2]
                mel_b[j, : mel.shape[-1]] = mel[0].T
                rel[j] = mel.shape[-1] / fb
            wav = self._vocode_rows(torch.cat(lat_rows, dim=0), torch.from_numpy(mel_b).to(self.device, self.dtype),
                                    torch.from_numpy(rel).to(self.device), split=dp > 1)
            wav16 = torch.clamp(wav[:b0] * 32767.0, -32767.0, 32767.0).to(torch.int16)
            wav_np = wav16.cpu().numpy()
            for j, i in enumerate(part):
                out[i] = wav_np[j : j + 1, : chunks[i][1] * spc]
        return out

    # ------------------------------------------------------------------
    # public synthesis API
    # ------------------------------------------------------------------

    def _resolve_prompt(self, prompt) -> np.ndarray:
        """Accept a [1, 100, frames] mel array or an audio path."""
        if isinstance(prompt, str):
            return self.extract_features(prompt)
        arr = np.asarray(prompt)
        if arr.ndim == 2:
            arr = arr[None]
        return arr.astype(np.float32)

    def _clamp_split_len(self, n: int) -> int:
        """Sentences must fit the text positional table (max_text_tokens + 2 rows)."""
        return max(4, min(int(n), self.cfg.gpt.max_text_tokens))

    def _clamp_mel_tokens(self, n: int) -> int:
        """Generation must fit the mel positional table (max_mel_tokens + 3 rows)."""
        cap = self.cfg.gpt.max_mel_tokens
        if int(n) > cap:
            warnings.warn(f"WARN: max_mel_tokens ({int(n)}) exceeds the model's mel capacity ({cap}); "
                          "clamping.", RuntimeWarning)
        return max(1, min(int(n), cap))

    def _parse_generation_kwargs(self, generation_kwargs, force_num_beams: Optional[int] = None):
        """The reference's generation kwargs with its defaults (infer.py:116-124).
        Returns (gen, dynamic sampling params, max_mel_tokens).
        `force_num_beams` overrides the num_beams knob (a stream cannot wait
        for a beam search to pick its winner)."""
        do_sample = generation_kwargs.pop("do_sample", True)
        top_p = generation_kwargs.pop("top_p", 0.8)
        top_k = generation_kwargs.pop("top_k", 30)
        temperature = generation_kwargs.pop("temperature", 1.0)
        length_penalty = generation_kwargs.pop("length_penalty", 0.0)
        num_beams = generation_kwargs.pop("num_beams", 3)
        if force_num_beams is not None:
            num_beams = force_num_beams
        repetition_penalty = generation_kwargs.pop("repetition_penalty", 10.0)
        max_mel_tokens = self._clamp_mel_tokens(generation_kwargs.pop("max_mel_tokens", 600))
        typical_sampling = generation_kwargs.pop("typical_sampling", False)
        typical_mass = generation_kwargs.pop("typical_mass", 0.9)
        if generation_kwargs:
            raise ValueError(f"unknown generation kwargs: {sorted(generation_kwargs)} "
                             "(did you misspell a sampling parameter?)")
        gen = GenerationConfig(do_sample=bool(do_sample), num_beams=int(num_beams), top_k=int(top_k) if top_k else 0,
                               typical_sampling=bool(typical_sampling), max_new_tokens=int(max_mel_tokens))
        dyn = {"temperature": float(temperature), "top_p": float(top_p),
               "repetition_penalty": float(repetition_penalty), "length_penalty": float(length_penalty),
               "typical_mass": float(typical_mass)}
        return gen, dyn, int(max_mel_tokens)

    def infer(
        self,
        prompt_mel=None,
        text: str = "",
        output_path: Optional[str] = None,
        max_text_tokens_per_sentence: int = 120,
        verbose: bool = False,
        audio_prompt: Optional[str] = None,
        **generation_kwargs,
    ):
        """Sequential per-sentence synthesis (reference: infer.py:101-241).
        Returns output_path when given, else (sampling_rate, int16 wav [T, 1])."""
        max_text_tokens_per_sentence = self._clamp_split_len(max_text_tokens_per_sentence)
        print(">> start inference...")
        self._set_gr_progress(0, "start inference...")
        if verbose:
            print(f"origin text:{text}")
        start_time = time.perf_counter()
        prompt_mel = self._resolve_prompt(audio_prompt if prompt_mel is None else prompt_mel)
        cond_mel_frame = prompt_mel.shape[-1]

        text_tokens_list = self.tokenizer.tokenize(text)
        sentences = self.tokenizer.split_sentences(text_tokens_list, max_text_tokens_per_sentence)
        if not sentences:
            raise ValueError("Text is empty (nothing to synthesize after tokenization).")
        if verbose:
            print("text token count:", len(text_tokens_list))
            print("sentences count:", len(sentences))
            print(*sentences, sep="\n")
        gen, dyn, max_mel_tokens = self._parse_generation_kwargs(generation_kwargs)
        self._agree("infer", sentences, prompt_mel.shape, gen, dyn)
        sampling_rate = 24000

        m_start = time.perf_counter()
        conds = self._conds_for(prompt_mel)
        self._sync()
        cond_time = time.perf_counter() - m_start
        wavs = []
        gpt_gen_time = gpt_forward_time = bigvgan_time = 0.0
        gpt_tokens = gpt_steps = tf_rows = 0
        self._decode_segments = 0
        has_warned = False
        progress = 0
        for sent in sentences:
            text_tokens = np.asarray(self.tokenizer.convert_tokens_to_ids(sent), np.int64)[None, :]
            if verbose:
                print(text_tokens)
                print(f"text_tokens shape: {text_tokens.shape}")
            progress += 1
            self._set_gr_progress(0.2 + 0.4 * (progress - 1) / len(sentences),
                                  f"gpt inference latent... {progress}/{len(sentences)}")
            m_start = time.perf_counter()
            codes, code_lens, cap_lat, steps = self._gpt_generate(
                conds, text_tokens, np.asarray([text_tokens.shape[1]]), gen, **dyn)
            gpt_gen_time += time.perf_counter() - m_start
            gpt_tokens += int(code_lens.max())
            gpt_steps += steps
            if (not has_warned and not (codes[:, -1] == self.stop_mel_token).all()
                    and code_lens.max() >= gen.max_new_tokens):
                warnings.warn(
                    f"WARN: generation stopped due to exceeding `max_mel_tokens` ({max_mel_tokens}). "
                    f"Input text tokens: {text_tokens.shape[1]}. "
                    f"Consider reducing `max_text_tokens_per_sentence`({max_text_tokens_per_sentence}) "
                    f"or increasing `max_mel_tokens`.",
                    category=RuntimeWarning,
                )
                has_warned = True
            codes_orig = codes[:, : int(code_lens.max())]
            codes, code_lens = self.remove_long_silence(codes_orig)
            if verbose:
                print(f"fix codes shape: {codes.shape}, code_lens: {code_lens}")
            self._set_gr_progress(0.2 + 0.4 * progress / len(sentences),
                                  f"gpt inference speech... {progress}/{len(sentences)}")
            m_start = time.perf_counter()
            # captured latents are indexed by the decode's code positions:
            # valid only where silence removal did not compact the row
            if cap_lat is not None and np.array_equal(codes, codes_orig[:, : codes.shape[1]]):
                latent = cap_lat
            else:
                latent = self._gpt_latent(conds, text_tokens, codes, code_lens)
                tf_rows += 1
            self._sync()
            gpt_forward_time += time.perf_counter() - m_start

            m_start = time.perf_counter()
            wav = self._vocode(latent[:, : codes.shape[1]], int(code_lens[0]), prompt_mel)
            bigvgan_time += time.perf_counter() - m_start
            wav = np.clip(32767 * wav, -32767.0, 32767.0)
            if verbose:
                print(f"wav shape: {wav.shape}", "min:", wav.min(), "max:", wav.max())
            wavs.append(wav)

        end_time = time.perf_counter()
        self._set_gr_progress(0.9, "save audio...")
        wav = np.concatenate(wavs, axis=1)
        wav_length = wav.shape[-1] / sampling_rate
        total = end_time - start_time
        self.last_stats = {
            "cond_s": cond_time, "gpt_gen_s": gpt_gen_time, "gpt_tokens": gpt_tokens,
            "gpt_calls": len(sentences), "gpt_steps": gpt_steps, "gpt_segments": self._decode_segments,
            "tf_latent_rows": tf_rows,
            "gpt_forward_s": gpt_forward_time, "bigvgan_s": bigvgan_time, "vocoder_calls": len(sentences),
            "total_s": total, "audio_s": wav_length, "rtf": total / max(wav_length, 1e-9),
        }
        print(f">> Reference audio length: {cond_mel_frame * 256 / sampling_rate:.2f} seconds")
        print(f">> gpt_gen_time: {gpt_gen_time:.2f} seconds")
        print(f">> gpt_forward_time: {gpt_forward_time:.2f} seconds")
        print(f">> bigvgan_time: {bigvgan_time:.2f} seconds")
        print(f">> Total inference time: {total:.2f} seconds")
        print(f">> Generated audio length: {wav_length:.2f} seconds")
        print(f">> RTF: {total / max(wav_length, 1e-9):.4f}")
        return self._emit(wav, output_path, sampling_rate)

    # ------------------------------------------------------------------
    # streaming synthesis (the JAX engine's infer_stream; the reference has
    # none): chunked vocoder calls between runs of decode steps
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _first_chunk(self, conds, tokens0: np.ndarray, gen: GenerationConfig, dyn, n_steps: int,
                     prompt_mel: np.ndarray):
        """Prefill + n_steps decode steps give w = n_steps + 1 codes; the
        first chunk is their waveform. valid_n is the first stop code of the
        window, or w. The latents (captured under fast_latents, else the
        teacher-forced pass over the codes stop-padded to lc = round_up(w,
        16)) are zeroed past valid_n, the vocoder runs on all lc frames and
        the wav is cut to valid_n codes: a call on valid_n frames alone would
        give other samples near the end, where the receptive field sees the
        padding. Returns (wav [samples] float32, valid_n, state, ctx)."""
        l0 = tokens0.shape[1]
        padded = np.full((1, self._text_bucket(l0)), self.cfg.gpt.stop_text_token, np.int64)
        padded[:, :l0] = tokens0
        fast = self.fast_latents
        pos_off = 1 if fast else 2
        state, ctx = prefill_decode_state(
            self.gpt, self.cfg.gpt, gen, conds.to(self.dtype), torch.from_numpy(padded).to(self.device),
            torch.tensor([l0], dtype=torch.long, device=self.device), self._generator,
            temperature=dyn["temperature"], top_p=dyn["top_p"], repetition_penalty=dyn["repetition_penalty"],
            typical_mass=dyn["typical_mass"], quant_kv=self.quant_kv, capture_latents=fast,
        )
        state = decode_steps(self.gpt, self.cfg.gpt, state, ctx, n_steps, pos_off=pos_off)
        w = n_steps + 1
        lc = max(_round_up(w, 16), 16)
        codes_w = state.codes[:, :w].cpu().numpy()
        stop_pos = np.nonzero(codes_w[0] == self.stop_mel_token)[0]
        valid_n = int(stop_pos[0]) if stop_pos.size else w
        if valid_n == 0:
            return np.zeros((0,), np.float32), 0, state, ctx
        if fast:
            latent = state.lat[:, :w]
        else:
            latent = self._gpt_latent(conds, tokens0, codes_w, np.asarray([valid_n]))[:, :w]
        latent = latent.clone()
        latent[:, valid_n:] = 0
        latent = torch.nn.functional.pad(latent, (0, 0, 0, lc - latent.shape[1]))
        return self._vocode(latent, valid_n, prompt_mel)[0], valid_n, state, ctx

    def infer_stream(
        self,
        prompt_mel=None,
        text: str = "",
        max_text_tokens_per_sentence: int = 120,
        first_chunk_codes: int = 24,
        chunk_codes: int = 96,
        overlap_codes: int = 8,
        audio_prompt: Optional[str] = None,
        **generation_kwargs,
    ):
        """Generator of float32 wav chunks [samples], yielded as soon as their
        codes exist: per sentence, the first chunk after first_chunk_codes
        decode steps, then one after every chunk_codes steps, each from a
        vocoder call on the new latent window with overlap_codes codes of
        left context (trimmed from the output). The generation kwargs are
        infer()'s; num_beams is forced to 1. The cache holds p + max_mel_tokens
        slots (no segments inside a stream). last_stats is filled as the stream
        runs: ttfa_s (this call to the first chunk, device synchronized),
        chunk_s / chunk_codes per chunk, gpt_steps, vocoder_calls, and total_s
        and audio_s once it is exhausted."""
        start_time = time.perf_counter()
        max_text_tokens_per_sentence = self._clamp_split_len(max_text_tokens_per_sentence)
        prompt_mel = self._resolve_prompt(audio_prompt if prompt_mel is None else prompt_mel)
        gen, dyn, _ = self._parse_generation_kwargs(generation_kwargs, force_num_beams=1)
        # the chunk knobs must make progress and fit the codes buffer: the
        # prefill itself emits one code, so the first chunk covers
        # first_chunk_codes + 1 slots of max_new_tokens (0 extra steps when
        # max_new_tokens is 1), and a chunk of no steps would never advance
        first_chunk_codes = max(0, min(int(first_chunk_codes), gen.max_new_tokens - 1))
        chunk_codes = max(1, int(chunk_codes))
        overlap_codes = max(0, int(overlap_codes))
        conds = self._conds_for(prompt_mel)
        sentences = self.tokenizer.split_sentences(self.tokenizer.tokenize(text), max_text_tokens_per_sentence)
        if not sentences:
            raise ValueError("Text is empty (nothing to synthesize after tokenization).")
        self._agree("infer_stream", sentences, prompt_mel.shape, gen, dyn, first_chunk_codes, chunk_codes,
                    overlap_codes)
        spc = self._samples_per_code()
        pos_off = 1 if self.fast_latents else 2
        stats = self.last_stats = {"ttfa_s": None, "chunk_s": [], "chunk_codes": [], "gpt_calls": 0, "gpt_steps": 0,
                                   "tf_latent_rows": 0, "vocoder_calls": 0, "total_s": None, "audio_s": 0.0}
        mark = start_time

        def emitted_chunk(wav: np.ndarray, n_codes: int) -> np.ndarray:
            nonlocal mark
            now = time.perf_counter()
            if stats["ttfa_s"] is None:
                stats["ttfa_s"] = now - start_time
            stats["chunk_s"].append(now - mark)
            stats["chunk_codes"].append(n_codes)
            stats["vocoder_calls"] += 1
            stats["audio_s"] += wav.size / 24000
            mark = now
            return wav.astype(np.float32)

        for sent in sentences:
            tokens0 = np.asarray(self.tokenizer.convert_tokens_to_ids(sent), np.int64)[None, :]
            wav, valid_n, state, ctx = self._first_chunk(conds, tokens0, gen, dyn, first_chunk_codes, prompt_mel)
            stats["gpt_calls"] += 1
            stats["tf_latent_rows"] += int(valid_n > 0 and not self.fast_latents)
            if valid_n > 0:
                yield emitted_chunk(wav, valid_n)
            emitted = valid_n
            while not bool(state.done.all()) and state.i + 1 < gen.max_new_tokens:
                with torch.no_grad():
                    state = decode_steps(self.gpt, self.cfg.gpt, state, ctx, chunk_codes, pos_off=pos_off)
                n_codes = state.i + 1
                # only completed (non-stop) codes are vocoded
                codes_np = state.codes[:, :n_codes].cpu().numpy()
                stop_pos = np.nonzero(codes_np[0] == self.stop_mel_token)[0]
                valid_n = int(stop_pos[0]) if stop_pos.size else n_codes
                if valid_n > emitted:
                    begin = max(emitted - overlap_codes, 0)
                    if self.fast_latents:
                        latent = state.lat[:, :valid_n]
                    else:
                        latent = self._gpt_latent(conds, tokens0, codes_np[:, :valid_n], np.asarray([valid_n]))
                        stats["tf_latent_rows"] += 1
                    wav = self._vocode(latent[:, begin:valid_n], valid_n - begin, prompt_mel)
                    chunk = wav[0, (emitted - begin) * spc:]  # drop the overlap's samples
                    if chunk.size:
                        yield emitted_chunk(chunk, valid_n - emitted)
                    emitted = valid_n
            stats["gpt_steps"] += state.i
        stats["total_s"] = time.perf_counter() - start_time

    def infer_fast(
        self,
        prompt_mel=None,
        text: str = "",
        output_path: Optional[str] = None,
        max_text_tokens_per_sentence: int = 120,
        verbose: bool = False,
        sentences_bucket_max_size: int = 4,
        audio_prompt: Optional[str] = None,
        **generation_kwargs,
    ):
        """Bucketed batch synthesis (reference: infer.py:332-537): sentences
        are length-bucketed (one sentence per bucket on the CPU), each bucket
        decoded as one padded batch, the teacher-forced latents computed in
        batches across buckets, the original order restored, and the vocoder
        run over chunks of two sentences, batched across chunks.
        Returns output_path when given, else (sampling_rate, int16 wav [T, 1])."""
        max_text_tokens_per_sentence = self._clamp_split_len(max_text_tokens_per_sentence)
        print(">> start fast inference...")
        self._set_gr_progress(0, "start fast inference...")
        if verbose:
            print(f"origin text:{text}")
        start_time = time.perf_counter()
        prompt_mel = self._resolve_prompt(audio_prompt if prompt_mel is None else prompt_mel)
        cond_mel_frame = prompt_mel.shape[-1]

        text_tokens_list = self.tokenizer.tokenize(text)
        sentences = self.tokenizer.split_sentences(text_tokens_list, max_tokens_per_sentence=max_text_tokens_per_sentence)
        if not sentences:
            raise ValueError("Text is empty (nothing to synthesize after tokenization).")
        if verbose:
            print(">> text token count:", len(text_tokens_list))
            print("   splited sentences count:", len(sentences))
        gen, dyn, max_mel_tokens = self._parse_generation_kwargs(generation_kwargs)
        self._agree("infer_fast", sentences, prompt_mel.shape, gen, dyn, sentences_bucket_max_size)
        sampling_rate = 24000

        m_start = time.perf_counter()
        conds = self._conds_for(prompt_mel)
        self._sync()
        cond_time = time.perf_counter() - m_start
        gpt_gen_time = gpt_forward_time = bigvgan_time = 0.0
        self._set_gr_progress(0.1, "text processing...")
        bucket_max_size = sentences_bucket_max_size if self.device.type != "cpu" else 1
        all_sentences = self.bucket_sentences(sentences, bucket_max_size=bucket_max_size)
        all_batch_num = sum(len(b) for b in all_sentences)
        all_batch_codes, all_batch_lens, all_batch_lats, all_text_tokens = [], [], [], []
        gpt_steps = processed_num = 0
        self._decode_segments = 0
        for bucket in all_sentences:
            item_tokens = [np.asarray(self.tokenizer.convert_tokens_to_ids(item["sent"]), np.int64)[None, :]
                           for item in bucket]
            all_text_tokens.append(item_tokens)
            processed_num += len(bucket)
            self._set_gr_progress(0.2 + 0.3 * processed_num / all_batch_num,
                                  f"gpt inference speech... {processed_num}/{all_batch_num}")
            m_start = time.perf_counter()
            codes, lens, cap_lat, steps = self._gpt_generate(
                conds, self.pad_tokens_cat(item_tokens), np.asarray([t.shape[1] for t in item_tokens]), gen, **dyn)
            gpt_gen_time += time.perf_counter() - m_start
            gpt_steps += steps
            all_batch_codes.append(codes)
            all_batch_lens.append(lens)
            all_batch_lats.append(cap_lat)

        self._set_gr_progress(0.5, "gpt inference latents...")
        all_idxs, all_latents, rows, pending = [], [], [], []
        has_warned = False
        for batch_codes, batch_lens, batch_lat, batch_tokens, bucket in zip(
                all_batch_codes, all_batch_lens, all_batch_lats, all_text_tokens, all_sentences):
            for i in range(batch_codes.shape[0]):
                code_row = batch_codes[i : i + 1]
                if (not has_warned and batch_lens[i] >= gen.max_new_tokens
                        and code_row[0, -1] != self.stop_mel_token):
                    warnings.warn(f"WARN: generation stopped due to exceeding `max_mel_tokens` ({max_mel_tokens}).",
                                  category=RuntimeWarning)
                    has_warned = True
                codes, code_lens = self.remove_long_silence(code_row)
                all_idxs.append(bucket[i]["idx"])
                if batch_lat is not None and np.array_equal(codes, code_row[:, : codes.shape[1]]):
                    all_latents.append((batch_lat[i : i + 1, : codes.shape[1]], int(code_lens[0])))
                else:  # teacher-forced latents, batched across buckets below
                    pending.append(len(all_latents))
                    all_latents.append(None)
                    rows.append((conds, batch_tokens[i], codes, code_lens))
        m_start = time.perf_counter()
        if rows:
            for pos, lat, row in zip(pending, self._gpt_latent_many(rows), rows):
                all_latents[pos] = (lat, int(row[3][0]))
        self._sync()
        gpt_forward_time += time.perf_counter() - m_start

        # restore the original order (argsort: a long text splits into many sentences)
        all_latents = [all_latents[j] for j in np.argsort(all_idxs)]
        chunk_size = 2
        chunks = [all_latents[i : i + chunk_size] for i in range(0, len(all_latents), chunk_size)]
        chunk_args = [(torch.cat([lat for lat, _ in items], dim=1), sum(n for _, n in items), prompt_mel)
                      for items in chunks]
        self._set_gr_progress(0.7, "bigvgan decode...")
        m_start = time.perf_counter()
        wavs = self._vocode_many(chunk_args)  # int16, scaled and clipped on the device
        bigvgan_time += time.perf_counter() - m_start

        end_time = time.perf_counter()
        self._set_gr_progress(0.9, "save audio...")
        wav = np.concatenate(wavs, axis=1)
        wav_length = wav.shape[-1] / sampling_rate
        total = end_time - start_time
        gpt_tokens = sum(int(lens.max()) for lens in all_batch_lens)
        self.last_stats = {
            "cond_s": cond_time, "gpt_gen_s": gpt_gen_time, "gpt_tokens": gpt_tokens,
            "gpt_calls": len(all_sentences), "gpt_steps": gpt_steps, "gpt_segments": self._decode_segments,
            "tf_latent_rows": len(rows),
            "decode_batches": [len(b) for b in all_sentences],
            "gpt_forward_s": gpt_forward_time, "bigvgan_s": bigvgan_time, "vocoder_calls": len(self._vocode_batches(chunk_args)),
            "total_s": total, "audio_s": wav_length, "rtf": total / max(wav_length, 1e-9),
        }
        print(f">> Reference audio length: {cond_mel_frame * 256 / sampling_rate:.2f} seconds")
        print(f">> gpt_gen_time: {gpt_gen_time:.2f} seconds")
        print(f">> gpt_forward_time: {gpt_forward_time:.2f} seconds")
        print(f">> bigvgan_time: {bigvgan_time:.2f} seconds")
        print(f">> Total fast inference time: {total:.2f} seconds")
        print(f">> Generated audio length: {wav_length:.2f} seconds")
        print(f">> [fast] bigvgan chunk_length: {len(chunks)}")
        print(f">> [fast] batch_num: {len(sentences)} bucket_max_size: {bucket_max_size}",
              f"bucket_count: {len(all_sentences)}" if bucket_max_size > 1 else "")
        print(f">> [fast] RTF: {total / max(wav_length, 1e-9):.4f}")
        return self._emit(wav, output_path, sampling_rate)

    # the generation params that may differ per request inside one decode
    # batch: they enter only elementwise score / logit math, as floats or [B]
    # tensors (ops/sampling._colp, gpt_decode._length_norm). Everything else
    # shapes the loop and must match across a batch.
    BATCH_DYNAMIC_PARAMS = ("temperature", "top_p", "repetition_penalty", "length_penalty", "typical_mass")

    def infer_batch(
        self,
        items,
        output_paths=None,
        max_text_tokens_per_sentence: int = 120,
        sentences_bucket_max_size: int = 8,
        verbose: bool = False,
        per_request_kwargs=None,
        **generation_kwargs,
    ):
        """Cross-request batched synthesis (the JAX engine's infer_batch; the
        reference serializes whole requests). `items`: (prompt, text) pairs,
        each request with its OWN reference prompt (mel array or audio path).
        Returns one `(sampling_rate, wav)` per request, or the written path
        where `output_paths[i]` is given, in input order.

        Sentence rows of DIFFERENT requests share decode batches: rows carry
        their own conditioning latents and are length-bucketed across
        requests as infer_fast buckets one request's sentences. The decode's
        invariance to padding and batching makes that transparent: greedy
        batched == per-request infer (tests/test_torch_infer_batch.py).

        `per_request_kwargs`: optionally one dict per request of sampling
        overrides, BATCH_DYNAMIC_PARAMS only. They enter the decode as
        per-row tensors, so requests with different knobs share a batch; the
        static params (do_sample / num_beams / top_k / typical_sampling /
        max_mel_tokens) must be uniform. last_stats holds the stage times
        and counts that infer_fast records."""
        max_text_tokens_per_sentence = self._clamp_split_len(max_text_tokens_per_sentence)
        print(f">> start batched inference... ({len(items)} requests)")
        start_time = time.perf_counter()
        if output_paths is not None and len(output_paths) != len(items):
            raise ValueError("output_paths must match items length")
        gen, base_dyn, max_mel_tokens = self._parse_generation_kwargs(generation_kwargs)
        sampling_rate = 24000
        if per_request_kwargs is not None:
            if len(per_request_kwargs) != len(items):
                raise ValueError("per_request_kwargs must match items length")
            bad = set().union(*(set(d or {}) for d in per_request_kwargs)) - set(self.BATCH_DYNAMIC_PARAMS)
            if bad:
                raise ValueError(
                    f"per-request overrides are allowed only for {self.BATCH_DYNAMIC_PARAMS} "
                    f"(static/shape params must match across a batch); got {sorted(bad)}")

        # per-request front end and conditioning (cached per prompt; the cache
        # misses of one frame bucket share one batched conditioning call)
        req_mels = [self._resolve_prompt(prompt) for prompt, _ in items]
        req_conds = self._conds_for_many(req_mels)
        self._sync()
        t_cond = time.perf_counter()
        flat_sents, flat_req = [], []
        for r, (_prompt, text) in enumerate(items):
            sents = self.tokenizer.split_sentences(self.tokenizer.tokenize(text), max_text_tokens_per_sentence)
            if not sents:
                raise ValueError(f"Request {r}: text is empty (nothing to synthesize).")
            flat_req.extend([r] * len(sents))
            flat_sents.extend(sents)
        if verbose:
            print(f">> {len(flat_sents)} sentence rows across {len(items)} requests")
        self._agree("infer_batch", flat_sents, flat_req, [m.shape for m in req_mels], gen, base_dyn,
                    per_request_kwargs, sentences_bucket_max_size)

        # cross-request length buckets (idx is the flat row index, which gives the owning request)
        self._set_gr_progress(0.1, "text processing...")
        buckets = self.bucket_sentences(flat_sents, bucket_max_size=sentences_bucket_max_size)
        row_latents: Dict[int, Tuple[torch.Tensor, int]] = {}
        pending_latents = []  # (flat row, conds, text tokens, codes, code_lens)
        has_warned = False
        gpt_steps = gpt_tokens = processed = 0
        self._decode_segments = 0
        for bucket in buckets:
            self._set_gr_progress(0.15 + 0.55 * processed / len(flat_sents),
                                  f"gpt inference speech... {processed}/{len(flat_sents)}")
            processed += len(bucket)
            item_tokens = [np.asarray(self.tokenizer.convert_tokens_to_ids(it["sent"]), np.int64)[None, :]
                           for it in bucket]
            reqs = [flat_req[it["idx"]] for it in bucket]
            conds_rows = torch.cat([req_conds[r] for r in reqs], dim=0)
            if per_request_kwargs is None:
                dyn = base_dyn
            else:  # rows of one bucket may come from requests with different knobs
                dyn = {name: np.asarray([(per_request_kwargs[r] or {}).get(name, base_dyn[name]) for r in reqs],
                                        np.float32) for name in self.BATCH_DYNAMIC_PARAMS}
            codes_b, lens_b, cap_lat, steps = self._gpt_generate(
                conds_rows, self.pad_tokens_cat(item_tokens), np.asarray([t.shape[1] for t in item_tokens]), gen,
                **dyn)
            gpt_steps += steps
            gpt_tokens += int(lens_b.max())
            for i, it in enumerate(bucket):
                if (not has_warned and lens_b[i] >= gen.max_new_tokens and codes_b[i, -1] != self.stop_mel_token):
                    warnings.warn(f"WARN: generation stopped due to exceeding `max_mel_tokens` ({max_mel_tokens}).",
                                  category=RuntimeWarning)
                    has_warned = True
                code_row = codes_b[i : i + 1, : max(int(lens_b[i]), 1)]
                codes, code_lens = self.remove_long_silence(code_row, silent_token=52, max_consecutive=30)
                if cap_lat is not None and np.array_equal(codes, code_row[:, : codes.shape[1]]):
                    row_latents[it["idx"]] = (cap_lat[i : i + 1, : codes.shape[1]], int(code_lens[0]))
                else:  # teacher-forced rows are batched across the whole request set below
                    pending_latents.append((it["idx"], req_conds[reqs[i]], item_tokens[i], codes, code_lens))
        self._sync()
        t_decode = time.perf_counter()
        if pending_latents:
            lats = self._gpt_latent_many([(c, t, cd, cl) for _, c, t, cd, cl in pending_latents])
            for (gidx, _c, _t, _cd, cl), lat in zip(pending_latents, lats):
                row_latents[gidx] = (lat, int(np.asarray(cl).reshape(-1)[0]))
        self._sync()
        t_latent = time.perf_counter()

        # vocode and assemble per request: rows back in sentence order, paired
        # in chunks of two WITHIN a request as infer_fast pairs them, the chunks
        # run through the vocoder in batches ACROSS requests
        chunk_size = 2
        per_req_rows: List[List[int]] = [[] for _ in items]
        for gidx, r in enumerate(flat_req):
            per_req_rows[r].append(gidx)
        self._set_gr_progress(0.75, "bigvgan decode...")
        chunk_list, chunk_req = [], []
        for r in range(len(items)):
            rows = [row_latents[g] for g in per_req_rows[r]]
            for k in range(0, len(rows), chunk_size):
                part = rows[k : k + chunk_size]
                chunk_list.append((torch.cat([lat for lat, _ in part], dim=1), sum(n for _, n in part), req_mels[r]))
                chunk_req.append(r)
        chunk_wavs = self._vocode_many(chunk_list)  # int16, scaled and clipped on the device
        t_vocode = time.perf_counter()
        results = []
        audio_s = 0.0
        for r in range(len(items)):
            wav = np.concatenate([w for w, cr in zip(chunk_wavs, chunk_req) if cr == r], axis=1)
            audio_s += wav.shape[-1] / sampling_rate
            results.append(self._emit(wav, output_paths[r] if output_paths else None, sampling_rate))
        total = time.perf_counter() - start_time
        self.last_stats = {
            "cond_s": t_cond - start_time, "gpt_gen_s": t_decode - t_cond, "gpt_tokens": gpt_tokens,
            "gpt_calls": len(buckets), "gpt_steps": gpt_steps, "gpt_segments": self._decode_segments,
            "tf_latent_rows": len(pending_latents), "decode_batches": [len(b) for b in buckets],
            "gpt_forward_s": t_latent - t_decode, "bigvgan_s": t_vocode - t_latent,
            "vocoder_calls": len(self._vocode_batches(chunk_list)),
            "total_s": total, "audio_s": audio_s, "rtf": total / max(audio_s, 1e-9),
        }
        print(f">> Batched inference: {len(items)} requests, {len(flat_sents)} rows, {total:.2f}s total"
              + (f", RTF: {total / audio_s:.4f}" if audio_s else ""))
        if verbose:
            print(f">> stage wall: cond {t_cond - start_time:.2f}s, frontend+decode(+silence scan) "
                  f"{t_decode - t_cond:.2f}s, latent {t_latent - t_decode:.2f}s, vocode {t_vocode - t_latent:.2f}s, "
                  f"emit {time.perf_counter() - t_vocode:.2f}s")
        return results

    def slot_session(self, n_slots: int = 8, **kwargs):
        """Open a continuous-batching SlotSession (rolling admission): a
        persistent decode batch whose finished rows are refilled with new
        requests WHILE the others keep decoding: no waiting behind a running
        batch, unlike infer_batch. num_beams is fixed at 1. See serving.py."""
        from indextts_tpu_torch.serving import SlotSession

        return SlotSession(self, n_slots=n_slots, **kwargs)

    def infer_slots(self, items, output_paths=None, n_slots: int = 8, per_request_kwargs=None, **generation_kwargs):
        """Batch convenience over slot_session: submit every (prompt, text)
        request, drain, return the results in input order (infer_batch's
        contract; greedy output == per-request infer)."""
        if output_paths is not None and len(output_paths) != len(items):
            raise ValueError("output_paths must match items length")
        if per_request_kwargs is not None and len(per_request_kwargs) != len(items):
            raise ValueError("per_request_kwargs must match items length")
        sess = self.slot_session(n_slots=n_slots, **generation_kwargs)
        rids = []
        for r, (prompt, text) in enumerate(items):
            over = (per_request_kwargs[r] or {}) if per_request_kwargs else {}
            rids.append(sess.submit(prompt, text, output_path=output_paths[r] if output_paths else None, **over))
        done = sess.drain()
        return [done[rid] for rid in rids]

    def warmup(self, texts: Sequence[str] = ("WARM UP.",), prompt=None, batch: int = 1, n_slots: int = 0,
               streaming: bool = False, verbose: bool = True, **generation_kwargs) -> float:
        """Pay a serving process's first-call costs in advance by synthesizing
        each text against a silent synthetic prompt through the same public
        entry points serving uses (results discarded). In the JAX engine
        those costs are compilations; here nothing is compiled per shape, and
        what the first call of a shape pays is the kernels' build and load
        (ops/cuda/build.py), cuDNN's and cuBLAS's set-up for each new shape
        and the allocator's first blocks. Same routing as the JAX engine:
        the slot session when n_slots > 0 (num_beams forced to 1; with
        streaming on a fast_latents engine also a streaming request per text
        and a window vocoder call at every power-of-two batch up to n_slots,
        which concurrent streams would hit), infer_batch when batch > 1
        (bucketed like a full wave, sentences_bucket_max_size = max(8,
        batch)), else infer; and infer_stream when streaming without slots.
        Pass the generation kwargs that production requests will use.

        Returns the seconds spent."""
        t0 = time.perf_counter()
        if prompt is None:
            prompt = np.zeros((1, self.cfg.bigvgan.num_mels, 100), np.float32)
        texts = list(texts)
        not_for_slots = ("num_beams", "sentences_bucket_max_size")
        if n_slots:
            kw = {k: v for k, v in generation_kwargs.items() if k not in not_for_slots}
            sess = self.slot_session(n_slots=n_slots, **kw)
            stream_too = streaming and self.fast_latents
            for t in texts:
                sess.submit(prompt, t)
                if stream_too:
                    sess.submit(prompt, t, on_chunk=lambda r, c: None)
            sess.drain()
            if stream_too:
                mel = self._resolve_prompt(prompt)
                w, d = sess._win_w, self.cfg.gpt.model_dim
                b = 1
                while b <= n_slots:
                    self._vocode_many([(torch.zeros((1, w, d), dtype=self.dtype, device=self.device), w, mel)] * b)
                    b *= 2
        elif batch > 1:
            items = [(prompt, texts[i % len(texts)]) for i in range(batch)]
            gk = dict(generation_kwargs)
            gk.setdefault("sentences_bucket_max_size", max(8, batch))
            self.infer_batch(items, **gk)
        else:
            for t in texts:
                self.infer(prompt, t, None, **generation_kwargs)
        if streaming and not n_slots:
            kw = {k: v for k, v in generation_kwargs.items() if k not in not_for_slots}
            for t in texts:
                for _ in self.infer_stream(prompt, t, **kw):
                    pass
        self._sync()
        dt = time.perf_counter() - t0
        if verbose:
            print(f">> warmup done in {dt:.1f}s ({len(texts)} text(s), batch={batch}, n_slots={n_slots}, "
                  f"streaming={streaming})")
        return dt

    def _agree(self, *request) -> None:
        """On a mesh, check that every rank got the same request (its text
        tokens, knobs and prompt mel shape): a rank that went its own way
        would otherwise wait in a collective that the others never reach.
        One all_reduce (max) of (hash, -hash) over the world's gloo group;
        every rank raises on a mismatch."""
        if self.mesh is None:
            return
        h = int.from_bytes(hashlib.sha1(repr(request).encode()).digest()[:7], "big")
        t = self.mesh.world.all_reduce(torch.tensor([h, -h], dtype=torch.int64), op=dist.ReduceOp.MAX)
        if int(t[0]) != -int(t[1]):
            raise RuntimeError(f"rank {self.mesh.rank}: the ranks of the mesh got different requests "
                               f"(every rank must make the same engine calls with the same arguments)")

    def _emit(self, wav: np.ndarray, output_path: Optional[str], sampling_rate: int):
        if output_path and self.mesh is not None and self.mesh.rank != 0:
            return output_path  # rank 0 writes the file
        if output_path:
            if os.path.isfile(output_path):
                os.remove(output_path)
                print(">> remove old wav file:", output_path)
            if os.path.dirname(output_path) != "":
                os.makedirs(os.path.dirname(output_path), exist_ok=True)
            write_wav(output_path, wav.astype(np.int16), sampling_rate)
            print(">> wav file saved to:", output_path)
            return output_path
        return (sampling_rate, wav.astype(np.int16).T)
