"""Weights: the bridge from the JAX parameter tree, and seeded random init.

The bridge walks a JAX parameter pytree (nested dicts and lists of numpy
arrays, as indextts_tpu's init_* and convert_* functions produce) beside the
port's nn.Module tree, matching names, and copies each leaf into the
parameter or buffer of the same name. Layouts differ only in these kinds:

    kind             JAX layout        torch layout
    Linear           [in, out]         [out, in]
    Conv1d           [K, Cin/g, Cout]  [Cout, Cin/g, K]
    ConvTranspose1d  [K, Cout/g, Cin]  [Cin, Cout/g, K]
    Conv2d           [Kh, Kw, Cin, Cout] [Cout, Cin, Kh, Kw]

(indextts_tpu/convert.py:56-69 has the inverse maps). GPT blocks are stacked
on a leading layer axis in JAX (one lax.scan body); a dict of stacked arrays
meeting an nn.ModuleList is unstacked along that axis. A quantized linear of
indextts_tpu/ops/quant.py ({weight: int8 [in, out], scale: [1, out], bias})
loads into ops/quant.py:QuantLinear (weight [out, in], the layout the K5
kernel reads; scale [out]); an nn.Linear that meets one is swapped for a
QuantLinear first.

The random init fills a module with the distributions of the JAX init_*
functions from a torch.Generator; it does not reproduce JAX's random bits.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

from indextts_tpu_torch.ops.quant import QuantLinear

_CONV_1D = (nn.Conv1d, nn.ConvTranspose1d)


def _to_torch_layout(owner: nn.Module, name: str, value: np.ndarray) -> np.ndarray:
    if isinstance(owner, QuantLinear) and name == "scale":
        return value.reshape(-1)
    if name != "weight":
        return value
    if isinstance(owner, (nn.Linear, QuantLinear)):
        return value.T
    if isinstance(owner, _CONV_1D):
        return np.transpose(value, (2, 1, 0))
    if isinstance(owner, nn.Conv2d):
        return np.transpose(value, (3, 2, 0, 1))
    return value


@torch.no_grad()
def load_jax_params(module: nn.Module, tree: Any, path: str = "") -> None:
    """Copy a JAX parameter tree (numpy or jax arrays) into `module` in place.
    Raises on a missing name or a shape mismatch; leaves of the module that the
    tree does not name keep their values."""
    if isinstance(module, nn.ModuleList):
        if isinstance(tree, Mapping):  # layer-stacked leaves: unstack axis 0
            tree = [_index_tree(tree, i) for i in range(len(module))]
        if len(tree) != len(module):
            raise ValueError(f"{path}: {len(tree)} JAX entries for {len(module)} modules")
        for i, (m, sub) in enumerate(zip(module, tree)):
            load_jax_params(m, sub, f"{path}.{i}")
        return
    if not isinstance(tree, Mapping):
        raise TypeError(f"{path}: expected a dict of parameters, got {type(tree).__name__}")
    for name, sub in tree.items():
        where = f"{path}.{name}" if path else name
        target = getattr(module, name, None)
        if isinstance(target, nn.Linear) and isinstance(sub, Mapping) and "scale" in sub:
            target = QuantLinear(target.in_features, target.out_features, target.bias.dtype, target.weight.device)
            setattr(module, name, target)
        elif isinstance(target, QuantLinear) and not (isinstance(sub, Mapping) and "scale" in sub):
            raise TypeError(f"{where}: the port's module is quantized but the JAX tree is not")
        if isinstance(target, nn.Module):
            load_jax_params(target, sub, where)
            continue
        if not isinstance(target, torch.Tensor):
            raise KeyError(f"{where}: the port's module has no parameter or buffer of this name")
        value = _to_torch_layout(module, name, np.asarray(sub))
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{where}: JAX shape {value.shape} (torch layout) != port shape {tuple(target.shape)}")
        target.copy_(torch.tensor(value, dtype=target.dtype))


def _index_tree(tree: Any, i: int) -> Any:
    if isinstance(tree, Mapping):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


# ---------------------------------------------------------------------------
# seeded random init (the JAX init_* distributions)
# ---------------------------------------------------------------------------


def uniform_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=g)


def normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.normal_(0.0, std, generator=g)


def fan_in(m: nn.Module) -> int:
    """Inputs per output of a Linear / Conv weight (ConvTranspose1d: Cout/g * K,
    torch's own convention)."""
    w = m.weight
    return int(np.prod(w.shape[1:]))


def default_init_(module: nn.Module, g: torch.Generator) -> None:
    """The JAX _linear_init / _conv_init_1d / _conv2d_init distribution for
    every Linear and Conv under `module`: weight and bias ~ U(+-1/sqrt(fan_in));
    norms to identity."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)):
                bound = 1.0 / math.sqrt(fan_in(m))
                uniform_(m.weight, bound, g)
                if m.bias is not None:
                    uniform_(m.bias, bound, g)
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
                m.reset_parameters()
