"""Config schema for the TPU IndexTTS stack.

Mirrors the `config.yaml` contract the reference engine consumes
(reference: indextts/infer.py:42-69, indextts/gpt/model.py:301-306,
indextts/BigVGAN/models.py:140-197) so published IndexTTS-1.5 checkpoints'
config files load unchanged, while adding TPU-specific engine knobs
(dtype policy, shape buckets, mesh axes).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _filter_kwargs(cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in kwargs.items() if k in names}


@dataclass
class ConditionModuleConfig:
    """Conformer conditioning-encoder config (reference: model.py:347-358)."""

    output_size: int = 512
    linear_units: int = 2048
    attention_heads: int = 8
    num_blocks: int = 6
    input_layer: str = "conv2d2"
    perceiver_mult: int = 2
    pos_enc_layer_type: str = "rel_pos"  # rel_pos | abs_pos | no_pos

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ConditionModuleConfig":
        return cls(**_filter_kwargs(cls, d))


@dataclass
class GPTConfig:
    """UnifiedVoice hyper-parameters (reference: model.py:300-386)."""

    layers: int = 8
    model_dim: int = 512
    heads: int = 8
    max_text_tokens: int = 120
    max_mel_tokens: int = 250
    max_conditioning_inputs: int = 1
    mel_length_compression: int = 1024
    number_text_tokens: int = 256
    start_text_token: int = 0
    stop_text_token: int = 1
    number_mel_codes: int = 8194
    start_mel_token: int = 8192
    stop_mel_token: int = 8193
    train_solo_embeddings: bool = False
    use_mel_codes_as_input: bool = True
    checkpointing: bool = False
    types: int = 1
    activation_function: Optional[str] = None  # None -> gelu_new
    condition_num_latent: int = 32
    condition_type: str = "conformer_perceiver"
    condition_module: ConditionModuleConfig = field(default_factory=ConditionModuleConfig)
    # the decoder stack: "gpt2" (UnifiedVoice's GPT-2 blocks) or "granite_hybrid"
    # (granite-4.0-h's GraniteMoeHybrid without experts: Mamba-2 and NoPE GQA
    # attention layers as `layer_types` orders them, a SwiGLU MLP in every layer,
    # RMSNorm, and the four multipliers; models/granite.py)
    block: str = "gpt2"
    layer_types: Optional[Tuple[str, ...]] = None  # "mamba" | "attention" per layer
    kv_heads: Optional[int] = None  # attention's KV heads (None: heads)
    intermediate_size: int = 0  # the hybrid's SwiGLU width
    mamba_heads: int = 0
    mamba_head_dim: int = 64
    mamba_d_state: int = 128
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_n_groups: int = 1
    mamba_chunk_size: int = 256
    rms_norm_eps: float = 1e-5
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None  # the softmax scale (None: 1 / sqrt(head_dim))
    logits_scaling: float = 1.0  # the heads' logits are divided by it

    def __post_init__(self):
        if isinstance(self.condition_module, dict):
            self.condition_module = ConditionModuleConfig.from_dict(self.condition_module)
        if self.layer_types is not None:
            self.layer_types = tuple(self.layer_types)
        if self.block not in ("gpt2", "granite_hybrid"):
            raise ValueError(f"block={self.block!r}: 'gpt2' or 'granite_hybrid'")
        if is_hybrid(self):
            if self.layer_types is None or len(self.layer_types) != self.layers or \
                    set(self.layer_types) - {"mamba", "attention"}:
                raise ValueError(f"a granite_hybrid stack needs layer_types of 'mamba' / 'attention', one per layer "
                                 f"({self.layers}), got {self.layer_types}")
            if self.mamba_n_groups != 1:
                raise NotImplementedError(f"mamba_n_groups={self.mamba_n_groups}: the port keeps one B / C group")
            if self.heads % self.n_kv_heads or self.mamba_heads * self.mamba_head_dim != self.d_inner:
                raise ValueError("heads must be a multiple of kv_heads, and mamba_heads x mamba_head_dim "
                                 "= mamba_expand x model_dim")

    @property
    def n_kv_heads(self) -> int:
        return self.heads if self.kv_heads is None else int(self.kv_heads)

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.model_dim

    @property
    def conv_dim(self) -> int:
        """The Mamba layers' convolved channels: x, B and C."""
        return self.d_inner + 2 * self.mamba_n_groups * self.mamba_d_state

    @property
    def attn_layers(self) -> int:
        """The layers that keep a KV cache."""
        return self.layers if not is_hybrid(self) else sum(t == "attention" for t in self.layer_types)

    @property
    def mamba_layers(self) -> int:
        return 0 if not is_hybrid(self) else sum(t == "mamba" for t in self.layer_types)

    @property
    def head_dim(self) -> int:
        return self.model_dim // self.heads

    @property
    def max_mel_seq_len(self) -> int:
        # reference: model.py:368 — mel positional table size
        return self.max_mel_tokens + 2 + self.max_conditioning_inputs

    @property
    def max_text_seq_len(self) -> int:
        return self.max_text_tokens + 2

    @property
    def n_positions(self) -> int:
        # reference: model.py:389 — inference-model context length
        return self.max_mel_tokens + self.max_text_tokens + 2

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GPTConfig":
        return cls(**_filter_kwargs(cls, d))


@dataclass
class BigVGANConfig:
    """BigVGAN generator `h` (reference: models.py:140-197)."""

    gpt_dim: int = 512
    upsample_initial_channel: int = 1024
    upsample_rates: Tuple[int, ...] = (4, 4, 4, 4, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 4, 4, 4, 4)
    resblock: str = "1"
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"
    snake_logscale: bool = True
    feat_upsample: bool = True
    cond_d_vector_in_each_upsampling_layer: bool = True
    num_mels: int = 100
    speaker_embedding_dim: int = 512
    sampling_rate: int = 24000
    # discriminator-side keys (eval only; reference: models.py:278-417)
    discriminator_channel_mult: float = 1.0
    use_spectral_norm: bool = False
    mpd_reshapes: Tuple[int, ...] = (2, 3, 5, 7, 11)
    resolutions: Tuple[Tuple[int, int, int], ...] = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BigVGANConfig":
        cfg = cls(**_filter_kwargs(cls, d))
        cfg.upsample_rates = tuple(cfg.upsample_rates)
        cfg.upsample_kernel_sizes = tuple(cfg.upsample_kernel_sizes)
        cfg.resblock_kernel_sizes = tuple(cfg.resblock_kernel_sizes)
        cfg.resblock_dilation_sizes = tuple(tuple(d_) for d_ in cfg.resblock_dilation_sizes)
        cfg.mpd_reshapes = tuple(cfg.mpd_reshapes)
        cfg.resolutions = tuple(tuple(r) for r in cfg.resolutions)
        return cfg


@dataclass
class DVAEConfig:
    """DiscreteVAE mel codebook (reference: vqvae/xtts_dvae.py:201-303)."""

    channels: int = 80
    num_tokens: int = 8192
    codebook_dim: int = 512
    hidden_dim: int = 512
    num_resnet_blocks: int = 3
    kernel_size: int = 3
    num_layers: int = 2
    use_transposed_convs: bool = False
    positional_dims: int = 1
    stride: int = 2
    activation: str = "relu"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DVAEConfig":
        return cls(**_filter_kwargs(cls, d))


@dataclass
class EngineConfig:
    """TPU engine knobs (new; no reference equivalent — the reference hardcodes
    device policy at infer.py:26-44)."""

    dtype: str = "bfloat16"  # compute dtype for the hot path; "float32" fallback
    param_dtype: str = "float32"
    text_len_buckets: Tuple[int, ...] = (32, 64, 96, 128)
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    cond_mel_buckets: Tuple[int, ...] = (200, 400, 600, 800)
    max_generate_tokens: int = 600
    use_pallas_kernels: bool = True
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("data",)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EngineConfig":
        cfg = cls(**_filter_kwargs(cls, d))
        cfg.text_len_buckets = tuple(cfg.text_len_buckets)
        cfg.batch_buckets = tuple(cfg.batch_buckets)
        cfg.cond_mel_buckets = tuple(cfg.cond_mel_buckets)
        cfg.mesh_shape = tuple(cfg.mesh_shape)
        cfg.mesh_axes = tuple(cfg.mesh_axes)
        return cfg


@dataclass
class IndexTTSConfig:
    """Top-level config — the union of the reference config.yaml keys
    (gpt / bigvgan / dvae / dataset / *_checkpoint) plus TPU engine config."""

    gpt: GPTConfig = field(default_factory=GPTConfig)
    bigvgan: BigVGANConfig = field(default_factory=BigVGANConfig)
    dvae: DVAEConfig = field(default_factory=DVAEConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    dataset: Dict[str, Any] = field(default_factory=lambda: {"bpe_model": "bpe.model"})
    gpt_checkpoint: str = "gpt.pth"
    bigvgan_checkpoint: str = "bigvgan_generator.pth"
    dvae_checkpoint: str = "dvae.pth"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "IndexTTSConfig":
        # `or {}`: a present-but-empty YAML section ("gpt:" with no body,
        # the standard use-defaults idiom) parses to None, and .get's
        # default only applies when the key is absent
        return cls(
            gpt=GPTConfig.from_dict(d.get("gpt") or {}),
            bigvgan=BigVGANConfig.from_dict(d.get("bigvgan") or {}),
            dvae=DVAEConfig.from_dict(d.get("dvae") or {}),
            engine=EngineConfig.from_dict(d.get("engine") or {}),
            dataset=dict(d.get("dataset") or {"bpe_model": "bpe.model"}),
            gpt_checkpoint=d.get("gpt_checkpoint", "gpt.pth"),
            bigvgan_checkpoint=d.get("bigvgan_checkpoint", "bigvgan_generator.pth"),
            dvae_checkpoint=d.get("dvae_checkpoint", "dvae.pth"),
        )


def is_hybrid(cfg) -> bool:
    """Whether a GPT config (the port's GPTConfig, or one of the same fields,
    as the JAX package's) names the granite hybrid stack."""
    return getattr(cfg, "block", "gpt2") == "granite_hybrid"


def load_config(path: str) -> IndexTTSConfig:
    """Load a reference-format config.yaml (reference: infer.py:42)."""
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f) or {}
    return IndexTTSConfig.from_dict(raw)


def save_config(cfg: IndexTTSConfig, path: str) -> None:
    def _to_plain(obj):
        if dataclasses.is_dataclass(obj):
            return {k: _to_plain(v) for k, v in dataclasses.asdict(obj).items()}
        if isinstance(obj, (list, tuple)):
            return [_to_plain(v) for v in obj]
        if isinstance(obj, dict):
            return {k: _to_plain(v) for k, v in obj.items()}
        return obj

    import yaml

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        # _to_plain handles dataclasses itself (asdict inside) — one walk
        yaml.safe_dump(_to_plain(cfg), f, sort_keys=False)
