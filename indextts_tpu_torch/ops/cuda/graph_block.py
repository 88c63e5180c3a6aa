"""A decode loop's block of conditional steps as one CUDA graph
(csrc/graph_block.cu): the device side of the JAX loops' lax.while_loop.

graphs.py captures two graphs on a loop's static buffers, the block's head
and one step, with torch.cuda.CUDAGraph(keep_graph=True); `BlockGraph`
assembles them into one executable graph of `k` steps, step j inside a
conditional IF node whose predicate a one-thread kernel computes from the
block's control buffers just before it, and launches it on the current
stream. The IF bodies are copies of the step with its event nodes (PyTorch's
around each NCCL collective it captures) replaced by edges, since a
conditional body takes none. The torch graphs are kept as long as the
block: their memory pool holds the step's temporaries, which every copy of
the step reuses.

There is no plain version: off the card (the CPU, `Graphs.eager()`, a gloo
mesh's decode stages) graphs.py runs the same head and step with the IF
decided on the host.
"""

from __future__ import annotations

import ctypes

import torch

SOURCE = "graph_block.cu"

_fns = None  # (build, launch, destroy, failed call, error name), argtypes set once


def _library() -> ctypes.CDLL:
    global _fns
    from indextts_tpu_torch.ops.cuda.build import load_library

    lib = load_library(SOURCE)
    if _fns is None:
        build, launch, destroy = lib.indextts_block_build, lib.indextts_block_launch, lib.indextts_block_destroy
        failed, name = lib.indextts_block_failed_call, lib.indextts_block_error_name
        build.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_void_p)]
        launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        destroy.argtypes = [ctypes.c_void_p]
        name.argtypes = [ctypes.c_int]
        for fn in (build, launch, destroy):
            fn.restype = ctypes.c_int
        failed.restype = name.restype = ctypes.c_char_p
        _fns = (build, launch, destroy, failed, name)
    return lib


def _error(err: int) -> str:
    return f"{_fns[4](err).decode()} ({err}) in {_fns[3]().decode() or 'the arguments'}"


class BlockGraph:
    """`k` conditional copies of `step` after `head` (two captured
    torch.cuda.CUDAGraph(keep_graph=True)); step j runs iff status[0] (the
    steps run in this block) < budget[0] and status[1] (the loop's
    condition) != 0, status int64 [2] and budget int64 [1] on the card."""

    def __init__(self, head: torch.cuda.CUDAGraph, step: torch.cuda.CUDAGraph, k: int, status: torch.Tensor,
                 budget: torch.Tensor):
        for name, t, n in (("status", status, 2), ("budget", budget, 1)):
            if t.dtype != torch.long or t.numel() != n or t.device.type != "cuda" or not t.is_contiguous():
                raise ValueError(f"BlockGraph: {name} must be a contiguous int64 [{n}] on the card, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
        _library()
        self.head, self.step, self.k = head, step, k
        self.status, self.budget = status, budget
        self._exec = ctypes.c_void_p()
        err = _fns[0](head.raw_cuda_graph(), step.raw_cuda_graph(), k, status.data_ptr(), budget.data_ptr(),
                      ctypes.byref(self._exec))
        if err != 0:
            raise RuntimeError(f"BlockGraph: building a block of {k} conditional steps failed: {_error(err)}")

    def replay(self) -> None:
        with torch.cuda.device(self.status.device):
            err = _fns[1](self._exec, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"BlockGraph: launching the block failed: {_fns[4](err).decode()} ({err})")

    def __del__(self):
        if _fns is not None and getattr(self, "_exec", None):
            _fns[2](self._exec)
            self._exec = ctypes.c_void_p()
