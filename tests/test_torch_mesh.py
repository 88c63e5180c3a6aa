"""The port's parallel/mesh.py without processes: its parameter placement
against the JAX package's (every parameter path of the tiny and the
flagship tree at tp 1, 2 and 4), make_mesh's shapes, the head-aligned
tensor-parallel split of a GPT block run in tp threads that sum the
row-parallel partial outputs (forward, the decode step on the plain cache,
the int8-cache step) against the unsharded block within 1e-5, the
whole-batch uniform draw of a data-parallel rank, and --tp in the CLI. The
spawned torch.distributed groups are in tests/test_torch_mesh_engine.py."""

import copy
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import torch
import torch.distributed as dist

from indextts_tpu.config import load_config as jax_load_config
from indextts_tpu.models.gpt import init_unified_voice
from indextts_tpu.parallel import mesh as jmesh
from indextts_tpu_torch.models import gpt_decode as tdec
from indextts_tpu_torch.models.gpt import UnifiedVoice
from indextts_tpu_torch.ops.sampling import RowDraw, uniforms
from indextts_tpu_torch.parallel import mesh as tmesh
from indextts_tpu_torch.weights import load_jax_params
from tests.test_engine import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _trees():
    tiny = tiny_config().gpt
    flagship = jax_load_config(os.path.join(REPO, "configs", "indextts_1_5.yaml")).gpt
    return {
        "tiny": (tiny, init_unified_voice(jax.random.PRNGKey(0), tiny)),
        # the flagship tree from its shapes alone
        "flagship": (flagship, jax.eval_shape(lambda k: init_unified_voice(k, flagship), jax.random.PRNGKey(0))),
    }


def _axis(spec, ndim: int):
    """'out' / 'in' for the logical dimension a JAX spec splits (only a
    stacked block weight [L, in, out] splits its input), None when
    replicated."""
    spec = tuple(spec)
    if "model" not in spec:
        return None
    return "in" if ndim == 3 and spec.index("model") == 1 else "out"


def _port_name_shape(path, shape):
    """The port's state_dict name and torch-layout shape of a JAX path."""
    if path[:2] == ("gpt", "blocks"):
        name = "gpt.blocks.0." + ".".join(path[2:])
        shape = shape[1:]  # one layer of the stacked [L, ...]
    else:
        name = ".".join(path)
    if len(shape) == 2 and path[-1] == "weight":
        shape = shape[::-1]  # [in, out] -> torch's [out, in]
    return name, tuple(shape)


def _port_axis(spec):
    if not spec:
        return None
    return "in" if spec == (None, "model") else "out"


# the one place the port's placement differs from JAX's: the attention
# splits by heads (H % tp, and (H / tp) % 2 with the int8 KV cache), not by
# columns of the fused [D, 3D] qkv matrix
HEAD_RULE_DIFFERS = {
    ("tiny", 4, True): ["gpt/blocks/attn_proj/weight", "gpt/blocks/attn_qkv/bias", "gpt/blocks/attn_qkv/weight"],
    ("flagship", 4, True): ["gpt/blocks/attn_proj/weight", "gpt/blocks/attn_qkv/bias",
                            "gpt/blocks/attn_qkv/weight"],
}


@pytest.mark.parametrize("tree", ["tiny", "flagship"])
def test_param_placement_matches_jax(tree):
    cfg, params = _trees()[tree]
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(leaves) > 20
    for tp in (1, 2, 4):
        jax_mesh = jmesh.make_mesh(8, tp=tp)
        for quant_kv in (False, True):
            differs = []
            split = 0
            for kp, leaf in leaves:
                path = jmesh._path_str(kp)
                shape = tuple(leaf.shape)
                jspec = jmesh._check_divisible(jmesh.gpt_param_spec(path), shape, jax_mesh)
                name, tshape = _port_name_shape(path, shape)
                tspec = tmesh._check_divisible(tmesh.gpt_param_spec(name), tshape, SimpleNamespace(shape={"model": tp}),
                                               name, cfg.heads, quant_kv)
                ja, ta = _axis(jspec, len(shape)), _port_axis(tspec)
                split += ta is not None
                if ja != ta:
                    differs.append("/".join(path))
            assert sorted(differs) == HEAD_RULE_DIFFERS.get((tree, tp, quant_kv), []), (tree, tp, quant_kv)
            assert split >= 3, (tree, tp, quant_kv)  # the MLP splits at the least


def test_head_rule_and_odd_vocabularies():
    """At the published widths the text vocabulary (12001) is odd and stays
    replicated; the mel vocabulary (8194 = 2 x 4097) splits at tp 2, not at
    4, as in JAX; so does the tiny mel head (66)."""
    m2, m4 = SimpleNamespace(shape={"model": 2}), SimpleNamespace(shape={"model": 4})
    check = tmesh._check_divisible
    assert check(("model", None), (8194, 1280), m2, "mel_head.weight") == ("model", None)
    assert check(("model",), (8194,), m4, "mel_head.bias") == ()
    assert check(("model", None), (12001, 1280), m2, "text_head.weight") == ()
    assert check(("model", None), (66, 64), m2, "mel_head.weight") == ("model", None)
    assert check(("model", None), (66, 64), m4, "mel_head.weight") == ()
    qkv = "gpt.blocks.0.attn_qkv.weight"
    assert check(("model", None), (3840, 1280), m2, qkv, heads=20, quant_kv=True) == ("model", None)
    assert check(("model", None), (3840, 1280), m4, qkv, heads=20) == ("model", None)
    assert check(("model", None), (3840, 1280), m4, qkv, heads=20, quant_kv=True) == ()
    assert check(("model", None), (3 * 96, 96), m4, qkv, heads=6) == ()  # 6 heads over 4 ranks


def test_mesh_shapes_match_jax():
    """make_mesh's (data, model) shape rule is JAX's (tests/test_parallel.py):
    8 ranks -> (4, 2), 1 -> (1, 1), and tp given; a one-rank gloo group
    builds a (1, 1) mesh whose groups do nothing."""
    for n, tp in ((8, None), (1, None), (8, 4), (8, 8), (6, None), (3, None), (4, 1)):
        want = jmesh.make_mesh(n, tp=tp).devices.shape
        assert tmesh.mesh_shape(n, tp) == want, (n, tp)
    with pytest.raises(ValueError):
        tmesh.mesh_shape(6, 4)
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        m = tmesh.make_mesh(device="cpu")
        assert m.shape == {"data": 1, "model": 1} and m.coords == (0, 0) and m.rows(3) == (0, 3)
        t = torch.arange(4.0)
        assert m.model.all_reduce(t) is t and torch.equal(m.data.gather(t), t)
        assert "gloo" in m.describe()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the head-aligned split, in tp threads
# ---------------------------------------------------------------------------


class ThreadComm:
    """tp threads as one model group: all_reduce sums every thread's tensor
    in thread order (the row-parallel partial outputs)."""

    def __init__(self, shared, index: int):
        self.shared, self.index, self.size = shared, index, shared["n"]

    def all_reduce(self, t, op=dist.ReduceOp.SUM):
        sh = self.shared
        sh["buf"][self.index] = t.clone()
        sh["barrier"].wait()
        parts = sh["buf"]
        total = parts[0].clone()
        for p in parts[1:]:
            total = torch.maximum(total, p) if op == dist.ReduceOp.MAX else total + p
        sh["barrier"].wait()
        t.copy_(total)
        return t

    gather = tmesh.Comm.gather


def _in_threads(tp: int, fn):
    shared = {"n": tp, "buf": [None] * tp, "barrier": threading.Barrier(tp)}
    out, errors = [None] * tp, []

    def run(r):
        try:
            out[r] = fn(r, ThreadComm(shared, r))
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)
            shared["barrier"].abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    if errors:
        raise errors[0]
    return out


@pytest.fixture(scope="module")
def tiny_model():
    cfg = tiny_config().gpt
    params = init_unified_voice(jax.random.PRNGKey(3), cfg)
    model = UnifiedVoice(cfg)
    load_jax_params(model, params)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():  # non-zero biases, so that a bias added tp times would show
        for name, p in model.gpt.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return cfg, model.eval()


def _shard_copy(model, comm, tp, quant_kv=False):
    m = copy.deepcopy(model)
    tmesh.shard_gpt_params(m, SimpleNamespace(shape={"data": 1, "model": tp}, model=comm), quant_kv=quant_kv)
    return m


@pytest.mark.parametrize("tp", [2, 4])
def test_block_forward_split_by_heads(tiny_model, tp):
    cfg, model = tiny_model
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 7, cfg.model_dim, generator=g)
    bias = torch.zeros(1, 1, 7, 7).masked_fill(torch.ones(7, 7).triu(1).bool(), tdec.NEG)
    with torch.no_grad():
        want, (k, v) = model.gpt.blocks[0](x, bias, cfg.heads)

    def rank(r, comm):
        with torch.no_grad():
            return _shard_copy(model, comm, tp).gpt.blocks[0](x, bias, cfg.heads)

    hl = cfg.heads // tp
    for r, (out, (kr, vr)) in enumerate(_in_threads(tp, rank)):
        assert kr.shape == (2, hl, 7, cfg.model_dim // cfg.heads)
        torch.testing.assert_close(out, want, atol=TOL, rtol=0)
        torch.testing.assert_close(kr, k[:, r * hl : (r + 1) * hl], atol=TOL, rtol=0)
        torch.testing.assert_close(vr, v[:, r * hl : (r + 1) * hl], atol=TOL, rtol=0)


@pytest.mark.parametrize("quant", [False, True])
def test_block_step_split_by_heads(tiny_model, quant):
    """One decode step against the plain cache (GPT2Block.step) and the int8
    cache (_decode_block_q) at tp 2: outputs within 1e-5 and each rank's
    cache slot written with its own heads (and head pairs' scales)."""
    cfg, model = tiny_model
    tp, b, s, pos = 2, 3, 12, 9
    h, dh = cfg.heads, cfg.model_dim // cfg.heads
    g = torch.Generator().manual_seed(2)
    x = torch.randn(b, cfg.model_dim, generator=g)
    cache = [torch.randn(b, h, s, dh, generator=g) for _ in range(2)]
    valid = torch.arange(s)[None, :] < torch.tensor([[pos], [pos - 3], [pos]])
    bias = torch.where(valid, torch.zeros(()), tdec.NEG)[:, None, :]
    if quant:
        (k8, ks), (v8, vs) = tdec._quant_cols(cache[0]), tdec._quant_cols(cache[1])
        cache = [k8, ks, v8, vs]
    full = [c.clone() for c in cache]

    def step(block, caches):
        with torch.no_grad():
            if quant:
                return tdec._decode_block_q(block, x, *caches, pos, bias, h)
            return block.step(x, *caches, pos, bias, h)

    want = step(model.gpt.blocks[0], full)
    hl = h // tp

    def heads_of(c, r):
        n = hl if c.dim() == 4 else hl // 2  # int8 scales: one per head pair
        return c[:, r * n : (r + 1) * n].clone()

    def rank(r, comm):
        caches = [heads_of(c, r) for c in cache]
        return step(_shard_copy(model, comm, tp, quant_kv=quant).gpt.blocks[0], caches), caches

    for r, (out, caches) in enumerate(_in_threads(tp, rank)):
        torch.testing.assert_close(out, want, atol=TOL, rtol=0)
        for c_r, c_full in zip(caches, full):
            torch.testing.assert_close(c_r, heads_of(c_full, r), atol=TOL, rtol=0)


def test_quantize_on_shards_equals_quantize_then_shard(tiny_model):
    """quantize_unified_voice on tp = 2 shards (row-parallel scales over the
    whole input, an all-reduced max) gives the bytes of quantizing the whole
    model and then sharding it."""
    from indextts_tpu_torch.ops.quant import quantize_unified_voice

    cfg, model = tiny_model
    whole = quantize_unified_voice(copy.deepcopy(model))

    def rank(r, comm):
        a = quantize_unified_voice(_shard_copy(model, comm, 2))
        b = _shard_copy(whole, comm, 2)
        return a.state_dict(), b.state_dict()

    for sd_a, sd_b in _in_threads(2, rank):
        assert sd_a.keys() == sd_b.keys()
        for k in sd_a:
            assert torch.equal(sd_a[k], sd_b[k]), k
        assert sd_a["gpt.blocks.0.attn_proj.weight"].shape == (cfg.model_dim, cfg.model_dim // 2)
        assert sd_a["gpt.blocks.0.attn_proj.scale"].shape == (cfg.model_dim,)
        assert sd_a["mel_head.scale"].shape == (cfg.number_mel_codes // 2,)


def test_row_draw_takes_rows_of_the_whole_batch_draw():
    g = torch.Generator().manual_seed(5)
    whole = torch.rand(6, generator=g)
    beams = torch.rand(6, 10, generator=g)
    g.manual_seed(5)
    assert torch.equal(uniforms((2,), RowDraw(g, 2, 6), "cpu"), whole[2:4])
    assert torch.equal(uniforms((3, 10), RowDraw(g, 3, 6), "cpu"), beams[3:6])
    g.manual_seed(5)
    assert torch.equal(uniforms((6,), g, "cpu"), whole)


def test_cli_tp_reaches_the_engine(monkeypatch, tmp_path):
    """--tp parses and reaches the engine (one process: no mesh)."""
    from indextts_tpu_torch import cli
    from indextts_tpu_torch import engine as engine_mod

    built = []

    class Fake:
        def __init__(self, **kw):
            built.append(kw)

        def infer(self, **kw):
            return kw["output_path"]

    monkeypatch.setattr(engine_mod, "IndexTTS", Fake)
    cfg = tmp_path / "config.yaml"
    cfg.write_text("{}")
    prompt = os.path.join(REPO, "tests", "sample_prompt.wav")
    for extra, tp in (([], None), (["--tp", "2"], 2)):
        cli.main(["HELLO.", "-v", prompt, "-c", str(cfg), "-o", str(tmp_path / "o.wav"), "-d", "cpu", *extra])
        assert built[-1]["tp"] == tp
