"""What the kernel wrappers share: tensors derived from their parameters,
made once; the card's SM count; the launch on a tensor's device and stream.

The activation kernels (K1-K4) read alpha and beta as float32, exponentiated
for log-scale parameters; K2 reads its conv weight packed. Deriving them on
every call would launch an `exp` (or a pack) per parameter per call beside
the kernel itself, so each derived tensor is cached per parameter tensor and
made again only when the parameter changes.
"""

from __future__ import annotations

import functools
import weakref
from typing import Callable, Dict, Tuple

import torch

# (id(tensor), what) -> (weak reference, data_ptr, version, derived): what the
# wrapper derives from a parameter, made once per parameter
_derived: Dict[Tuple[int, str], Tuple[weakref.ref, int, int, torch.Tensor]] = {}


def _cached(tensor: torch.Tensor, what: str, make: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """make(tensor), cached. The entry is keyed by the tensor object and holds
    its data pointer and version counter, so a parameter updated in place
    (copy_, load_state_dict, the weight bridge), given new storage
    (.to(dtype), .data = ...) or replaced by another tensor is derived again;
    the entry goes when the tensor does."""
    key = (id(tensor), what)
    hit = _derived.get(key)
    if (hit is not None and hit[0]() is tensor and hit[1] == tensor.data_ptr() and hit[2] == tensor._version
            and hit[3].device == tensor.device):
        return hit[3]
    made = make(tensor.detach())
    ref = weakref.ref(tensor, lambda _, key=key: _derived.pop(key, None))
    _derived[key] = (ref, tensor.data_ptr(), tensor._version, made)
    return made


def _snake_parameter(p: torch.Tensor, logscale: bool) -> torch.Tensor:
    """alpha or beta as the kernel reads it: float32, contiguous, exponentiated
    for log-scale parameters; made once per parameter."""
    if logscale:
        return _cached(p, "exp", lambda t: torch.exp(t.float()).contiguous())
    return _cached(p, "float", lambda t: t.float().contiguous())


def snake_parameters(alpha: torch.Tensor, beta, logscale: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alpha, beta) as the activation kernels read them; Snake (beta None)
    divides by alpha, so alpha stands in for beta."""
    a = _snake_parameter(alpha, logscale)
    return a, (a if beta is None else _snake_parameter(beta, logscale))


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The card's streaming multiprocessors, read once per device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def launch(fn, x: torch.Tensor, *args) -> int:
    """fn(*args, stream): a bound C launch function, called on x's device and
    that device's current stream. Returns its CUDA error code."""
    if x.device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(x.device):
        return fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
