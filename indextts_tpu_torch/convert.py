"""Checkpoint conversion: published IndexTTS-1.5 torch .pth state dicts ->
the numpy parameter trees of the JAX package (port of indextts_tpu/convert.py).

The reference loads plain torch.save state dicts (utils/checkpoint.py:25-34,
infer.py:49,63-64; the vocoder nested under "generator"). This module maps
those names onto the JAX package's tree layout (linear [in, out], conv
[K, Cin/g, Cout], weight norm folded) and returns nested dicts and lists of
numpy arrays, so that the engine loads a checkpoint with
weights.load_jax_params, the same bridge the parity tests use. Converted trees
are cached as <checkpoint>.npz, with the JAX package's key format: a cache
written by either package loads in the other. Covered: gpt.pth (all four
condition types), bigvgan_generator.pth, dvae.pth and
bigvgan_discriminator.pth.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from indextts_tpu_torch.config import BigVGANConfig, DVAEConfig, GPTConfig
from indextts_tpu_torch.ops.conv import weight_norm_fold


def load_torch_state_dict(path: str, key: Optional[str] = None) -> Dict[str, np.ndarray]:
    """torch.load -> {name: np.ndarray} (optionally unwrapping ['model'] like
    utils/checkpoint.py:28-30 or ['generator'] like infer.py:63-64)."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if key is not None:
        if key not in obj:
            # fail here, not with a far-away KeyError on some weight name
            # after unwrapping the wrong nesting
            raise KeyError(
                f"checkpoint {path!r} has no top-level entry {key!r} "
                f"(keys: {sorted(map(str, obj))[:10]})"
            )
        obj = obj[key]
    elif "model" in obj and isinstance(obj.get("model"), dict):
        obj = obj["model"]

    def to_np(v):
        if isinstance(v, dict):  # nested module state dicts (e.g. {'mpd': ..., 'mrd': ...})
            return {k: to_np(x) for k, x in v.items()}
        if hasattr(v, "numpy"):
            # Tensor.numpy() rejects bf16 (re-exported or fine-tuned checkpoints)
            if str(getattr(v, "dtype", "")) == "torch.bfloat16":
                v = v.float()
            return v.numpy()
        return np.asarray(v)

    return {k: to_np(v) for k, v in obj.items()}


def _t(w: np.ndarray) -> np.ndarray:
    """torch Linear [out, in] -> [in, out]."""
    return np.ascontiguousarray(w.T)


def _conv_w(w: np.ndarray) -> np.ndarray:
    """torch Conv1d [Cout, Cin/g, K] -> [K, Cin/g, Cout] (also ConvTranspose1d
    [Cin, Cout/g, K] -> [K, Cout/g, Cin])."""
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def _conv2d_w(w: np.ndarray) -> np.ndarray:
    """torch Conv2d [Cout, Cin, Kh, Kw] -> [Kh, Kw, Cin, Cout]."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _wn_folded_weight(sd: Dict[str, np.ndarray], prefix: str) -> np.ndarray:
    """Resolve a (possibly weight-normed) torch conv weight: legacy
    weight_v/weight_g, the parametrize-era original1/original0 pair, or a
    plain weight."""
    if f"{prefix}.weight_v" in sd:
        return weight_norm_fold(sd[f"{prefix}.weight_v"], sd[f"{prefix}.weight_g"])
    if f"{prefix}.parametrizations.weight.original1" in sd:
        return weight_norm_fold(
            sd[f"{prefix}.parametrizations.weight.original1"],
            sd[f"{prefix}.parametrizations.weight.original0"],
        )
    return sd[f"{prefix}.weight"]


def _folded_conv(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """Weight-normed torch conv -> folded conv params in the JAX layout."""
    out = {"weight": _conv_w(_wn_folded_weight(sd, prefix))}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _linear(sd, prefix, bias=True):
    p = {"weight": _t(sd[f"{prefix}.weight"])}
    if bias and f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _ln(sd, prefix):
    return {"weight": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _bn(sd, prefix):
    return {
        "weight": sd[f"{prefix}.weight"],
        "bias": sd[f"{prefix}.bias"],
        "running_mean": sd[f"{prefix}.running_mean"],
        "running_var": sd[f"{prefix}.running_var"],
    }


# ---------------------------------------------------------------------------
# GPT (UnifiedVoice)
# ---------------------------------------------------------------------------


def convert_gpt2_blocks(sd: Dict[str, np.ndarray], layers: int, prefix: str = "gpt") -> Dict[str, Any]:
    """HF GPT2Model block stack -> arrays stacked on a leading layer axis. HF
    Conv1D stores weight as [in, out], which is already the JAX layout."""

    def stack(fmt):
        return np.stack([sd[fmt.format(i=i)] for i in range(layers)])

    def pair(name):
        return {"weight": stack(f"{prefix}.h.{{i}}.{name}.weight"), "bias": stack(f"{prefix}.h.{{i}}.{name}.bias")}

    return {
        "ln_1": pair("ln_1"),
        "attn_qkv": pair("attn.c_attn"),
        "attn_proj": pair("attn.c_proj"),
        "ln_2": pair("ln_2"),
        "mlp_fc": pair("mlp.c_fc"),
        "mlp_proj": pair("mlp.c_proj"),
    }


def _convert_conformer(sd: Dict[str, np.ndarray], cfg: GPTConfig) -> Dict[str, Any]:
    cm = cfg.condition_module
    pfx = "conditioning_encoder"
    params: Dict[str, Any] = {}
    conv = lambda i: {"weight": _conv2d_w(sd[f"{pfx}.embed.conv.{i}.weight"]), "bias": sd[f"{pfx}.embed.conv.{i}.bias"]}
    if cm.input_layer == "linear":
        params["embed"] = {"out": _linear(sd, f"{pfx}.embed.out.0"), "ln": _ln(sd, f"{pfx}.embed.out.1")}
    elif cm.input_layer == "conv2d2":
        params["embed"] = {"conv0": conv(0), "out": _linear(sd, f"{pfx}.embed.out.0")}
    elif cm.input_layer == "conv2d":
        params["embed"] = {"conv0": conv(0), "conv1": conv(2), "out": _linear(sd, f"{pfx}.embed.out.0")}
    else:
        raise ValueError(cm.input_layer)

    def conv1d(prefix):
        return {"weight": _conv_w(sd[f"{prefix}.weight"]), "bias": sd[f"{prefix}.bias"]}

    layers = []
    for i in range(cm.num_blocks):
        lp = f"{pfx}.encoders.{i}"
        attn = {name: _linear(sd, f"{lp}.self_attn.{name}") for name in ("linear_q", "linear_k", "linear_v", "linear_out")}
        attn["linear_pos"] = _linear(sd, f"{lp}.self_attn.linear_pos", bias=False)
        attn["pos_bias_u"] = sd[f"{lp}.self_attn.pos_bias_u"]
        attn["pos_bias_v"] = sd[f"{lp}.self_attn.pos_bias_v"]
        layers.append(
            {
                "attn": attn,
                "ff": {"w1": _linear(sd, f"{lp}.feed_forward.w_1"), "w2": _linear(sd, f"{lp}.feed_forward.w_2")},
                "conv": {
                    "pw1": conv1d(f"{lp}.conv_module.pointwise_conv1"),
                    "dw": conv1d(f"{lp}.conv_module.depthwise_conv"),
                    "ln": _ln(sd, f"{lp}.conv_module.norm"),
                    "pw2": conv1d(f"{lp}.conv_module.pointwise_conv2"),
                },
                **{name: _ln(sd, f"{lp}.{name}") for name in ("norm_mha", "norm_ff", "norm_conv", "norm_final")},
            }
        )
    params["layers"] = layers
    params["after_norm"] = _ln(sd, f"{pfx}.after_norm")
    # the checkpoint registers the sinusoidal PE table as a buffer
    # (conformer/embedding.py:44 self.pe, shape [1, max_len, d]); consume it
    # when present so the table is bit-identical to the reference's
    pe_key = f"{pfx}.embed.pos_enc.pe"
    if pe_key in sd:
        params["pe"] = sd[pe_key][0]
    else:
        from indextts_tpu_torch.models.conformer import sinusoidal_pe

        params["pe"] = sinusoidal_pe(5000, cm.output_size)
    return params


def _convert_perceiver(sd: Dict[str, np.ndarray], cfg: GPTConfig) -> Dict[str, Any]:
    pfx = "perceiver_encoder"
    params: Dict[str, Any] = {"latents": sd[f"{pfx}.latents"], "norm_gamma": sd[f"{pfx}.norm.gamma"]}
    if f"{pfx}.proj_context.weight" in sd:
        params["proj_context"] = _linear(sd, f"{pfx}.proj_context")
    layers = []
    i = 0
    while f"{pfx}.layers.{i}.0.to_q.weight" in sd:
        layers.append(
            {
                "to_q": _linear(sd, f"{pfx}.layers.{i}.0.to_q", bias=False),
                "to_kv": _linear(sd, f"{pfx}.layers.{i}.0.to_kv", bias=False),
                "to_out": _linear(sd, f"{pfx}.layers.{i}.0.to_out", bias=False),
                "ff_in": _linear(sd, f"{pfx}.layers.{i}.1.0"),
                "ff_out": _linear(sd, f"{pfx}.layers.{i}.1.2"),
            }
        )
        i += 1
    params["layers"] = layers
    return params


def convert_unified_voice(sd: Dict[str, np.ndarray], cfg: GPTConfig) -> Dict[str, Any]:
    """UnifiedVoice state dict (gpt.pth) -> the JAX package's params tree of
    models/gpt.py, which weights.load_jax_params copies into UnifiedVoice."""
    params: Dict[str, Any] = {
        "text_embedding": sd["text_embedding.weight"],
        "mel_embedding": sd["mel_embedding.weight"],
        "text_pos_embedding": sd["text_pos_embedding.emb.weight"],
        "mel_pos_embedding": sd["mel_pos_embedding.emb.weight"],
        "gpt": {
            "blocks": convert_gpt2_blocks(sd, cfg.layers, prefix="gpt"),
            "ln_f": _ln(sd, "gpt.ln_f"),
        },
        "final_norm": _ln(sd, "final_norm"),
        "text_head": _linear(sd, "text_head"),
        "mel_head": _linear(sd, "mel_head"),
    }
    if cfg.condition_type in ("conformer_perceiver", "conformer_encoder"):
        params["conditioning_encoder"] = _convert_conformer(sd, cfg)
        if cfg.condition_type == "conformer_perceiver":
            params["perceiver_encoder"] = _convert_perceiver(sd, cfg)
    elif cfg.condition_type in ("perceiver", "default"):
        params["conditioning_encoder"] = _convert_legacy_conditioning(sd)
        if cfg.condition_type == "perceiver":
            params["perceiver_encoder"] = _convert_perceiver(sd, cfg)
    return params


def _convert_legacy_conditioning(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """AttentionBlock-stack ConditioningEncoder (model.py:210-234,
    arch_util.py:78-120). 1x1 convs become [Cin, Cout] matrices."""
    pfx = "conditioning_encoder"

    def conv1x1(prefix):
        return {"weight": np.ascontiguousarray(sd[f"{prefix}.weight"][:, :, 0].T), "bias": sd[f"{prefix}.bias"]}

    params: Dict[str, Any] = {"init": conv1x1(f"{pfx}.init"), "attn": []}
    i = 0
    while f"{pfx}.attn.{i}.qkv.weight" in sd:
        blk = {
            "norm": _ln(sd, f"{pfx}.attn.{i}.norm"),
            "qkv": conv1x1(f"{pfx}.attn.{i}.qkv"),
            "proj_out": conv1x1(f"{pfx}.attn.{i}.proj_out"),
        }
        rp_key = f"{pfx}.attn.{i}.relative_pos_embeddings.relative_attention_bias.weight"
        if rp_key in sd:
            blk["rel_pos"] = {"emb": sd[rp_key]}
        params["attn"].append(blk)
        i += 1
    return params


# ---------------------------------------------------------------------------
# ECAPA + BigVGAN
# ---------------------------------------------------------------------------


def _sb_conv(sd, prefix):
    """SpeechBrain Conv1d wrapper: the conv itself sits under `.conv`."""
    return {"weight": _conv_w(sd[f"{prefix}.conv.weight"]), "bias": sd[f"{prefix}.conv.bias"]}


def _ecapa_tdnn_block(sd, prefix):
    return {"conv": _sb_conv(sd, f"{prefix}.conv"), "bn": _bn(sd, f"{prefix}.norm.norm")}


def convert_ecapa(sd: Dict[str, np.ndarray], prefix: str = "speaker_encoder") -> Dict[str, Any]:
    from indextts_tpu_torch.models.ecapa import RES2NET_SCALE

    p: Dict[str, Any] = {"block0": _ecapa_tdnn_block(sd, f"{prefix}.blocks.0")}
    for i in range(1, 4):
        bp = f"{prefix}.blocks.{i}"
        p[f"block{i}"] = {
            "tdnn1": _ecapa_tdnn_block(sd, f"{bp}.tdnn1"),
            "res2net": [
                _ecapa_tdnn_block(sd, f"{bp}.res2net_block.blocks.{j}") for j in range(RES2NET_SCALE - 1)
            ],
            "tdnn2": _ecapa_tdnn_block(sd, f"{bp}.tdnn2"),
            "se_conv1": _sb_conv(sd, f"{bp}.se_block.conv1"),
            "se_conv2": _sb_conv(sd, f"{bp}.se_block.conv2"),
        }
    p["mfa"] = _ecapa_tdnn_block(sd, f"{prefix}.mfa")
    p["asp_tdnn"] = _ecapa_tdnn_block(sd, f"{prefix}.asp.tdnn")
    p["asp_conv"] = _sb_conv(sd, f"{prefix}.asp.conv")
    p["asp_bn"] = _bn(sd, f"{prefix}.asp_bn.norm")
    p["fc"] = _sb_conv(sd, f"{prefix}.fc")
    return p


def _snake(sd, prefix):
    act = {"alpha": sd[f"{prefix}.alpha"]}
    if f"{prefix}.beta" in sd:
        act["beta"] = sd[f"{prefix}.beta"]
    return act


def convert_bigvgan(sd: Dict[str, np.ndarray], h: BigVGANConfig) -> Dict[str, Any]:
    """BigVGAN generator state dict (bigvgan_generator.pth['generator']) ->
    the JAX package's params tree of models/bigvgan.py, weight norm folded."""
    params: Dict[str, Any] = {
        "conv_pre": _folded_conv(sd, "conv_pre"),
        "ups": [],
        "resblocks": [],
        "conds": [],
        "activation_post": _snake(sd, "activation_post.act"),
        "conv_post": _folded_conv(sd, "conv_post"),
        "cond_layer": {"weight": _conv_w(sd["cond_layer.weight"]), "bias": sd["cond_layer.bias"]},
        "speaker_encoder": convert_ecapa(sd, "speaker_encoder"),
    }
    for i in range(len(h.upsample_rates)):
        params["ups"].append(_folded_conv(sd, f"ups.{i}.0"))
        if h.cond_d_vector_in_each_upsampling_layer:
            params["conds"].append({"weight": _conv_w(sd[f"conds.{i}.weight"]), "bias": sd[f"conds.{i}.bias"]})
    n_res = len(h.upsample_rates) * len(h.resblock_kernel_sizes)
    for n in range(n_res):
        rp = f"resblocks.{n}"
        n_convs = len(h.resblock_dilation_sizes[n % len(h.resblock_kernel_sizes)])
        if h.resblock == "1":
            block = {
                "convs1": [_folded_conv(sd, f"{rp}.convs1.{j}") for j in range(n_convs)],
                "convs2": [_folded_conv(sd, f"{rp}.convs2.{j}") for j in range(n_convs)],
            }
            n_acts = 2 * n_convs
        else:
            block = {"convs": [_folded_conv(sd, f"{rp}.convs.{j}") for j in range(n_convs)]}
            n_acts = n_convs
        block["acts"] = [_snake(sd, f"{rp}.activations.{j}.act") for j in range(n_acts)]
        params["resblocks"].append(block)
    return params


# ---------------------------------------------------------------------------
# DVAE
# ---------------------------------------------------------------------------


def convert_dvae(sd: Dict[str, np.ndarray], cfg: DVAEConfig) -> Dict[str, Any]:
    """DiscreteVAE state dict (dvae.pth) -> the JAX package's params tree of
    models/dvae.py, which weights.load_jax_params copies into DiscreteVAE.

    Reference Sequential indices (xtts_dvae.py:251-291, positional_dims=1,
    use_transposed_convs=False): encoder = [L strided (conv, act) blocks] +
    [R ResBlocks] + [1x1 out conv]; decoder = [1x1 in conv (when R > 0)] +
    [R ResBlocks] + [L (UpsampledConv, act) blocks] + [1x1 out conv].
    Codebook buffers embed / cluster_size / embed_avg (xtts_dvae.py:66-69).
    """
    L, R = cfg.num_layers, cfg.num_resnet_blocks

    def conv(prefix):
        return {"weight": _conv_w(sd[f"{prefix}.weight"]), "bias": sd[f"{prefix}.bias"]}

    def res(prefix):
        return {"conv0": conv(f"{prefix}.net.0"), "conv1": conv(f"{prefix}.net.2"), "conv2": conv(f"{prefix}.net.4")}

    dec_off = 1 if R > 0 else 0
    params: Dict[str, Any] = {
        "enc_convs": [conv(f"encoder.{i}.0") for i in range(L)],
        "enc_res": [res(f"encoder.{L + r}") for r in range(R)],
        "enc_out": conv(f"encoder.{L + R}"),
        "dec_res": [res(f"decoder.{dec_off + r}") for r in range(R)],
        "dec_convs": [conv(f"decoder.{dec_off + R + i}.0.conv") for i in range(L)],
        "dec_out": conv(f"decoder.{dec_off + R + L}"),
        "codebook": {
            "embed": sd["codebook.embed"],
            "cluster_size": sd["codebook.cluster_size"],
            "embed_avg": sd["codebook.embed_avg"],
        },
    }
    if R > 0:
        params["dec_in"] = conv("decoder.0")
    return params


# ---------------------------------------------------------------------------
# BigVGAN discriminators (bigvgan_discriminator.pth)
# ---------------------------------------------------------------------------


def _folded_conv2d(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """Weight-normed torch Conv2d -> folded conv params in the JAX layout
    [Kh, Kw, Cin, Cout] (the resolution chain of _folded_conv)."""
    out = {"weight": _conv2d_w(_wn_folded_weight(sd, prefix))}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def convert_discriminator(sd: Dict[str, Any], h: BigVGANConfig) -> Dict[str, Any]:
    """bigvgan_discriminator.pth -> {"mpd": ..., "mrd": ...}, the JAX
    package's trees of models/bigvgan.py's mpd_apply / mrd_apply, which
    weights.load_jax_params copies into MultiPeriodDiscriminator /
    MultiResolutionDiscriminator.

    Takes the nested training-checkpoint layout ({"mpd": state_dict, "mrd":
    state_dict}, upstream BigVGAN's convention) or a flat state dict with
    "mpd." / "mrd." key prefixes. Weight norm is folded (DiscriminatorP's
    convs are (K, 1) weight-normed Conv2ds, DiscriminatorR's (3, 9) / (3, 3)
    Conv2ds over the magnitude STFT; models.py:278-417)."""
    if "mpd" in sd and isinstance(sd["mpd"], dict):
        sd = {f"{mod}.{k}": np.asarray(v) for mod in ("mpd", "mrd") for k, v in sd[mod].items()}

    def one(mod, i):
        p = f"{mod}.discriminators.{i}"
        n_convs = len([k for k in sd if k.startswith(f"{p}.convs.") and k.endswith(".bias")])
        return {
            "convs": [_folded_conv2d(sd, f"{p}.convs.{j}") for j in range(n_convs)],
            "conv_post": _folded_conv2d(sd, f"{p}.conv_post"),
        }

    return {
        "mpd": {"discriminators": [one("mpd", i) for i in range(len(h.mpd_reshapes))]},
        "mrd": {"discriminators": [one("mrd", i) for i in range(len(h.resolutions))]},
    }


# ---------------------------------------------------------------------------
# npz caching (the JAX package's key format)
# ---------------------------------------------------------------------------


# empty containers get an explicit marker entry: dropping them would make the
# cache's round trip return a tree of another structure than the conversion
# (bigvgan params['conds'] == [] when cond_d_vector_in_each_upsampling_layer
# is False)
_EMPTY_LIST_KEY = "__empty_list__"
_EMPTY_DICT_KEY = "__empty_dict__"


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        if not tree:
            out[f"{prefix}{_EMPTY_DICT_KEY}"] = np.zeros((), np.int8)
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out[f"{prefix}{_EMPTY_LIST_KEY}"] = np.zeros((), np.int8)
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys == [_EMPTY_LIST_KEY]:
            return []
        if keys == [_EMPTY_DICT_KEY]:
            return {}
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_params_npz(params: Any, path: str) -> None:
    np.savez(path, **flatten_tree(params))


def load_params_npz(path: str) -> Any:
    with np.load(path) as data:
        return unflatten_tree({k: data[k] for k in data.files})
