"""Int8 weight-only quantization of the GPT decode's matmuls (port of
indextts_tpu/ops/quant.py).

Each decode step reads every GPT matrix from device memory; stored as
per-output-channel symmetric int8 they are half the bytes of bf16.
Activations stay bf16 / float32. Opt-in, as in the JAX package: call
quantize_unified_voice(engine.gpt) on a built engine.

matmul_maybe_quantized routes a 2-D input (the decode step) to the K5 kernel
(ops/cuda/qmatmul.py; its plain version on the CPU) and a 3-D input (the
prefill, the teacher-forced pass) through JAX's dequantize-then-matmul.
QuantLinear is the module that holds the int8 weight in the layout K5 reads.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from indextts_tpu_torch.ops.cuda.qmatmul import int8_matmul


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8, w ~ q * scale, in the JAX layout:
    w is [Din, Dout] or layer-stacked [L, Din, Dout]; the scale keeps the
    stack and output axes ([..., 1, Dout], float32). Same bytes as JAX: the
    division runs in float32 and torch.round rounds half to even, as jnp.round."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"weight": q, "scale": scale}


def matmul_maybe_quantized(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ (wq * scale)^T + bias for an int8 weight wq [N, K] (torch Linear's
    layout) with scale [N]. A 2-D x runs K5; any other rank dequantizes the
    weight in x's dtype and multiplies, as the JAX function does outside its
    Pallas route."""
    if x.dim() == 2:
        return int8_matmul(x, wq, scale, bias)
    w = wq.to(x.dtype) * scale.to(x.dtype)[:, None]
    out = x @ w.t()
    return out if bias is None else out + bias.to(out.dtype)


class QuantLinear(nn.Module):
    """A Linear with int8 weights: weight [out, in] int8 (one output channel
    per row), scale [out] float32, bias in the model's dtype; y = x @ (weight
    * scale)^T + bias through matmul_maybe_quantized, so a 2-D x (the decode
    step) runs K5 and a 3-D x (prefill, teacher-forced pass) dequantizes.
    Built by quantize_unified_voice or by the weight bridge from a quantized
    JAX tree."""

    def __init__(self, in_features: int, out_features: int, bias_dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight", torch.zeros(out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(out_features, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(out_features, dtype=bias_dtype, device=device))

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "QuantLinear":
        """Quantize lin's weight per output channel (quantize_weight on the
        JAX layout [in, out], so the bytes equal JAX's)."""
        q = cls(lin.in_features, lin.out_features, lin.bias.dtype, lin.weight.device)
        qd = quantize_weight(lin.weight.detach().t())
        q.weight.copy_(qd["weight"].t())
        q.scale.copy_(qd["scale"].reshape(-1))
        q.bias.copy_(lin.bias.detach())
        return q

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return matmul_maybe_quantized(x, self.weight, self.scale, self.bias)


_QUANT_TARGETS = ("attn_qkv", "attn_proj", "mlp_fc", "mlp_proj")


@torch.no_grad()
def quantize_gpt_blocks(gpt: nn.Module) -> nn.Module:
    """Swap the four matmuls of every GPT-2 block (the decode's bandwidth
    bulk) for QuantLinear, in place. Norms, biases and embeddings stay."""
    for block in gpt.blocks:
        for name in _QUANT_TARGETS:
            lin = getattr(block, name)
            if not isinstance(lin, QuantLinear):
                setattr(block, name, QuantLinear.from_linear(lin))
    return gpt


@torch.no_grad()
def quantize_unified_voice(model: nn.Module) -> nn.Module:
    """Quantize a UnifiedVoice in place: the GPT blocks and the mel head; the
    text head stays. Returns the model."""
    quantize_gpt_blocks(model.gpt)
    if not isinstance(model.mel_head, QuantLinear):
        model.mel_head = QuantLinear.from_linear(model.mel_head)
    return model
