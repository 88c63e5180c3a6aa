"""Tensor and data parallelism over torch.distributed (port of
indextts_tpu/parallel/mesh.py).

The JAX package runs one controller over a ("data", "model") device mesh and
GSPMD inserts the collectives. The port runs one process per device, as
torchrun starts them; every rank makes the same engine calls with the same
arguments, as a JAX SPMD program runs on every chip, and the collectives are
explicit:

  * make_mesh reshapes the ranks of the initialized world to (world / tp,
    tp): rank r sits at data index r // tp and model index r % tp. The ranks
    of one data index form its model group (tensor parallelism), the ranks
    of one model index its data group (batch rows).
  * Tensor parallelism is Megatron's. attn_qkv and mlp_fc are
    column-parallel; attn_proj and mlp_proj are row-parallel, with an
    all-reduce after the product and the bias added once after it. The mel
    and text heads split their vocabulary where it divides, and their
    logits are gathered. attn_qkv splits by head, for q, k and v each: rank
    r keeps heads [r H / tp, (r + 1) H / tp) of all three, so its attention
    is whole over its heads (JAX's contiguous column split of the fused
    [D, 3D] matrix relies on GSPMD to reshard).
  * Data parallelism gives each data group a contiguous slice of a batch's
    rows; the outputs are gathered, so every rank returns the whole batch.
  * All communication is all_reduce and broadcast, the two collectives that
    gloo runs on CUDA tensors as well: an all-gather is an all_reduce (sum)
    of a zero-filled buffer into which each rank wrote its own slice. Two
    ranks can then share one card over gloo (NCCL refuses two ranks on one
    device), and the same code runs in CPU processes.

The backend is NCCL on CUDA when each rank has a card of its own, else gloo
(init_distributed); ranks that share a card pass backend="gloo". The vocoder,
ECAPA and the conditioning encoders stay replicated, as in JAX
(vocoder_sharding there): multi-device vocoding rides the data axis
(shard_batch).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from indextts_tpu_torch.config import is_hybrid

Spec = Tuple[Optional[str], ...]


class Comm:
    """One process group as the model code uses it: `ranks` (global ranks,
    in group order) and this rank's `index` among them. Collectives are
    in place and return their tensor; a group of one does nothing."""

    def __init__(self, group, ranks: Sequence[int]):
        self.group = group
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """All-reduce `t` in place. bf16 / fp16 tensors reduce in float32
        (one rounding at the end, and gloo need not support them)."""
        if self.size == 1:
            return t
        work = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
        if not work.is_contiguous():
            work = work.contiguous()
        dist.all_reduce(work, op=op, group=self.group)
        if work is not t:
            t.copy_(work)
        return t

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Each rank's `t` (equal shapes) concatenated along `dim` in group
        order: an all_reduce (sum) of a zero-filled buffer holding this
        rank's slice. Exact: every element is one rank's value plus zeros."""
        if self.size == 1:
            return t
        if t.dtype == torch.bool:
            return self.gather(t.to(torch.uint8), dim).bool()
        n = t.shape[dim]
        shape = list(t.shape)
        shape[dim] = n * self.size
        buf = t.new_zeros(shape)
        buf.narrow(dim, self.index * n, n).copy_(t)
        return self.all_reduce(buf)

    def broadcast(self, t: torch.Tensor, src_index: int) -> torch.Tensor:
        """Broadcast `t` in place from the rank at `src_index` of the group."""
        if self.size == 1:
            return t
        dist.broadcast(t, self.ranks[src_index], group=self.group)
        return t

    def broadcast_object(self, obj=None, src_index: int = 0):
        """A picklable object from the rank at `src_index` (CPU groups)."""
        box = [obj]
        if self.size > 1:
            dist.broadcast_object_list(box, self.ranks[src_index], group=self.group)
        return box[0]


# ---------------------------------------------------------------------------
# region operators: the model code's collectives, with their gradients
# ---------------------------------------------------------------------------


class _CopyToRegion(torch.autograd.Function):
    """Identity forward; the input gradient is all-reduced over the model
    group (each rank holds only its shard's part of it)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.clone()), None


class _ReduceFromRegion(torch.autograd.Function):
    """All-reduce (sum) of a row-parallel product's partial sums forward;
    identity backward."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromRegion(torch.autograd.Function):
    """Vocabulary-split logits [..., V / tp] -> [..., V] forward; backward
    keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm, ctx.n = comm, x.shape[-1]
        return comm.gather(x, dim=x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(g.dim() - 1, ctx.comm.index * ctx.n, ctx.n).contiguous(), None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_region(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    return _CopyToRegion.apply(x, comm) if _tracked(x) else x


def reduce_from_region(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    # without autograd the product is a fresh tensor: reduce it in place
    return _ReduceFromRegion.apply(x, comm) if _tracked(x) else comm.all_reduce(x)


def gather_from_region(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    return _GatherFromRegion.apply(x, comm) if _tracked(x) else comm.gather(x, dim=x.dim() - 1)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def default_backend(device: str) -> str:
    """NCCL when the ranks run on CUDA and every local rank has a card of its
    own, else gloo (CPU ranks, or ranks that share one card)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    if str(device).startswith("cuda") and torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def env_world_size() -> int:
    """The world size of an initialized group, else of torchrun's environment."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_distributed(device: str = "cuda", backend: Optional[str] = None) -> None:
    """Initialize the default process group from torchrun's environment
    (env://: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) unless it already
    is; the backend is default_backend(device) unless given."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend or default_backend(device), init_method="env://")


def rank_device(device: str) -> torch.device:
    """This rank's device: cuda:{LOCAL_RANK} when every local rank has a
    card, else the one card shared over gloo; a device with an index, or a
    CPU, as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", env_world_size()))
    return torch.device("cuda", local_rank if torch.cuda.device_count() >= local else 0)


@dataclass
class Mesh:
    """The (data, model) ranks of the initialized world: `model` is this
    rank's model group (tensor parallelism), `data` its data group, `world`
    a gloo group of every rank for host-side agreement (generator states,
    request checks, the server's calls), and `model_host` the model group's
    ranks over gloo, for host-side agreement inside it (the captured
    stages' lanes, graphs.py; `model` itself on a gloo mesh)."""

    tp: int
    dp: int
    rank: int
    backend: str
    device: torch.device
    model: Comm
    data: Comm
    world: Comm
    model_host: Comm

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.dp, "model": self.tp}

    @property
    def coords(self) -> Tuple[int, int]:
        """(data index, model index) of this rank."""
        return self.rank // self.tp, self.rank % self.tp

    def rows(self, n: int) -> Tuple[int, int]:
        """[start, stop) of this data group's contiguous slice of n rows
        (n a multiple of dp)."""
        if n % self.dp:
            raise ValueError(f"{n} rows do not split over {self.dp} data groups")
        per = n // self.dp
        d = self.coords[0]
        return d * per, (d + 1) * per

    def describe(self) -> str:
        return f"{self.shape} over {self.backend} on {self.device}, rank {self.rank} at (data, model) {self.coords}"


def mesh_shape(n: int, tp: Optional[int] = None) -> Tuple[int, int]:
    """(dp, tp) of n ranks: tp defaults to 2 when n is even and at least 2,
    else 1, as JAX's make_mesh."""
    if tp is None:
        tp = 2 if n % 2 == 0 and n >= 2 else 1
    if tp < 1 or n % tp:
        raise ValueError(f"n_devices {n} not divisible by tp {tp}")
    return n // tp, tp


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None, device: Optional[str] = None) -> Mesh:
    """A (data, model) mesh over the ranks of the initialized process group
    (mesh_shape). Every rank creates every subgroup, in the same order: a rank
    that skipped one would leave the others waiting in new_group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized torch.distributed process group "
                           "(init_distributed, torchrun's environment, or dist.init_process_group)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"make_mesh over {n} devices, but the process group has {world} ranks")
    dp, tp = mesh_shape(n, tp)
    rank, backend = dist.get_rank(), dist.get_backend()
    dev = rank_device(device or ("cuda" if backend == "nccl" else "cpu"))
    model = data = None
    for d in range(dp):
        ranks = list(range(d * tp, (d + 1) * tp))
        group = dist.new_group(ranks)
        if rank in ranks:
            model = Comm(group, ranks)
    for m in range(tp):
        ranks = list(range(m, n, tp))
        group = dist.new_group(ranks)
        if rank in ranks:
            data = Comm(group, ranks)
    cpu = dist.group.WORLD if backend == "gloo" else dist.new_group(list(range(n)), backend="gloo")
    model_host = model
    if backend != "gloo":
        for d in range(dp):
            ranks = list(range(d * tp, (d + 1) * tp))
            group = dist.new_group(ranks, backend="gloo")
            if rank in ranks:
                model_host = Comm(group, ranks)
    return Mesh(tp=tp, dp=dp, rank=rank, backend=backend, device=dev, model=model, data=data,
                world=Comm(cpu, list(range(n))), model_host=model_host)


# ---------------------------------------------------------------------------
# parameter placement
# ---------------------------------------------------------------------------

_COLUMN = ("attn_qkv", "mlp_fc")
_ROW = ("attn_proj", "mlp_proj")
_HEADS = ("mel_head", "text_head")


def gpt_param_spec(name: str) -> Spec:
    """The tensor-parallel split of a UnifiedVoice tensor, addressed by its
    state_dict name, in torch's layout (Linear and QuantLinear weights [out,
    in]; QuantLinear's scale and bias [out]): "model" at the dimension that
    splits, () when replicated. Megatron's: attn_qkv / mlp_fc split their
    output channels (int8 rows and their scales with them), attn_proj /
    mlp_proj their input (bias and scale replicated), the heads their
    vocabulary; everything else (norms, embeddings, conditioning) is
    replicated."""
    module, _, leaf = name.rpartition(".")
    layer = module.rpartition(".")[2]
    if layer in _COLUMN or module in _HEADS:
        return ("model", None) if leaf == "weight" else ("model",)
    if layer in _ROW:
        return (None, "model") if leaf == "weight" else ()
    return ()


def _check_divisible(spec: Spec, shape: Tuple[int, ...], mesh, name: str = "", heads: Optional[int] = None,
                     quant_kv: bool = False) -> Spec:
    """Fall back to replication where a split does not divide (JAX's rule;
    the odd vocabularies 8194 and 12001 hit it). The attention (attn_qkv,
    and attn_proj with it) divides by heads: H % tp == 0, and with the int8
    KV cache, which scales head pairs, (H / tp) % 2 == 0 too."""
    if not spec:
        return spec
    tp = mesh.shape["model"]
    layer = name.rpartition(".")[0].rpartition(".")[2]
    if layer in ("attn_qkv", "attn_proj") and heads is not None:
        ok = heads % tp == 0 and (not quant_kv or (heads // tp) % 2 == 0)
        return spec if ok else ()
    for dim, axis in enumerate(spec):
        if axis is not None and (dim >= len(shape) or shape[dim] % tp):
            return ()
    return spec


def _shard(t: torch.Tensor, dim: int, index: int, tp: int, by_thirds: bool) -> torch.Tensor:
    """Shard `index` of `tp` of t along dim; by_thirds splits each third (q,
    k, v) on its own and concatenates the three pieces."""
    parts = t.chunk(3, dim) if by_thirds else (t,)
    return torch.cat([p.chunk(tp, dim)[index] for p in parts], dim).contiguous()


@torch.no_grad()
def shard_gpt_params(model: nn.Module, mesh: Mesh, quant_kv: bool = False) -> nn.Module:
    """Slice a whole UnifiedVoice in place to this rank's tensor-parallel
    shard. Every rank builds or loads the whole model (the same seed or
    checkpoint: weights.load_jax_params, the engine's loader), then keeps its
    shard. Shards are contiguous (K5 reads a contiguous weight). A module
    whose weight split gets `tp_comm` (the model group) and `tp_dim` (0:
    output channels, 1: input); the model code reads them. An int8
    (QuantLinear) model shards its int8 rows and scales as above. `quant_kv`:
    the engine decodes with the int8 KV cache (the head-pair rule). A
    granite hybrid stack is refused (NotImplementedError): the mesh has no
    sharded Mamba heads and states."""
    if is_hybrid(model.cfg):
        raise NotImplementedError(
            "the multi-device mesh does not run a granite_hybrid GPT: it has no sharded Mamba heads and states "
            "(tensor-parallel in_proj / conv / out_proj by Mamba head, and each rank's share of the conv and SSM "
            "states); run the hybrid stack on one process")
    tp = mesh.shape["model"]
    if tp == 1:
        return model
    heads, comm = model.cfg.heads, mesh.model
    for mod_name, module, leaf, name, t in _named_tensors(model):
        spec = _check_divisible(gpt_param_spec(name), tuple(t.shape), mesh, name, heads, quant_kv)
        if not spec:
            continue
        dim = spec.index("model")
        shard = _shard(t.detach(), dim, comm.index, tp, mod_name.endswith("attn_qkv"))
        if leaf in module._parameters:
            module._parameters[leaf] = nn.Parameter(shard, requires_grad=t.requires_grad)
        else:
            module._buffers[leaf] = shard
        if leaf == "weight":
            module.tp_comm, module.tp_dim = comm, dim
            module.out_features, module.in_features = shard.shape
    return model


def _named_tensors(model: nn.Module):
    """(module name, module, leaf, state_dict name, tensor) of every
    parameter and buffer."""
    for mod_name, module in list(model.named_modules()):
        tensors = {**dict(module.named_parameters(recurse=False)), **dict(module.named_buffers(recurse=False))}
        for leaf, t in tensors.items():
            yield mod_name, module, leaf, f"{mod_name}.{leaf}" if mod_name else leaf, t


@torch.no_grad()
def gathered_state_dict(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The whole model's state dict, the shards of every split tensor
    gathered over the model group (every rank returns it): the inverse of
    shard_gpt_params, for checkpoints and checks."""
    out = {}
    for mod_name, module, leaf, name, t in _named_tensors(model):
        comm = getattr(module, "tp_comm", None)
        spec = gpt_param_spec(name) if comm is not None else ()
        if not spec:
            out[name] = t.detach().clone()
            continue
        dim = spec.index("model")
        parts = t.detach().chunk(3, dim) if mod_name.endswith("attn_qkv") else (t.detach(),)
        out[name] = torch.cat([comm.gather(p.contiguous(), dim) for p in parts], dim)
    return out


def local_heads(model: nn.Module) -> int:
    """The attention heads of the KV cache this rank holds (cfg.heads, or
    cfg.heads / tp where the attention splits; a granite hybrid stack, which
    the mesh does not shard, its KV heads)."""
    cfg = model.cfg
    if is_hybrid(cfg):
        return cfg.n_kv_heads
    return model.gpt.blocks[0].attn_qkv.weight.shape[0] * cfg.heads // (3 * cfg.model_dim)


def shard_batch(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """This data group's slice of the rows of each batch-first tensor;
    a tensor whose leading dim does not divide the data axis stays whole
    (replicated), as in JAX."""
    out = []
    for t in tensors:
        if t.dim() >= 1 and t.shape[0] > 0 and t.shape[0] % mesh.dp == 0:
            start, stop = mesh.rows(t.shape[0])
            t = t[start:stop]
        out.append(t)
    return tuple(out)


def reduce_data_gradients(model: nn.Module, mesh: Mesh) -> None:
    """Data-parallel training: sum every parameter's gradient over the data
    group. Each data group's loss must be its share of the global mean (its
    sums over the global counts), so the sum is the global gradient; the
    model groups' region operators have already made each rank's gradient
    whole over its shard."""
    for p in model.parameters():
        if p.grad is not None:
            mesh.data.all_reduce(p.grad)
